"""Workload telemetry emitter: the workload end of the workload->runner->server
metrics channel.

The port's own copy of ``dstack_tpu/workloads/telemetry.py`` (the port
imports nothing of the JAX package): the same ``DSTACK_TPU_TELEMETRY_PATH``
JSON-lines schema, which the control plane's goodput ledger reads, the same
never-blocking buffer and the same profiler control hook, whose default
profiler is ``torch.profiler`` instead of ``jax.profiler``.

* **Zero dependencies beyond the stdlib at import.** torch is imported only
  when the profiler control hook fires.
* **Never blocks, never throws into the caller.** ``emit()`` appends to a
  bounded in-memory buffer under a lock held for microseconds; a full buffer
  DROPS the point and increments ``dropped`` instead of back-pressuring the
  train step. Sidecar write errors are swallowed and counted.
* **Sidecar file protocol.** A background thread flushes buffered points as
  JSON lines appended to the path in ``DSTACK_TPU_TELEMETRY_PATH`` (set by
  the runner agent, which tails the file).
* **Control hook.** The agent requests on-demand profiling by atomically
  writing ``<path>.ctl`` (``{"id": N, "cmd": "profile", "seconds": S}``).
  The flusher polls the file each tick; a new id starts a profiler capture
  into ``<dir(path)>/profile/<id>`` and stops it ``S`` seconds later,
  emitting ``profile_start``/``profile_end`` marks.

Point schema (one JSON object per line, all optional but ``ts``/``kind``):
``kind="step"`` (``step``, ``step_time_s``, ``tokens_per_sec``, ``mfu``,
``tf_per_sec``, ``loss``, ``input_wait_s``), ``kind="engine"``,
``kind="mark"`` (``event`` in run_start, compile_start, compile_end,
run_end, profile_start, profile_end, profile_error, ...) and
``kind="emitter"`` (``dropped``, ``write_errors``); every point carries the
host identity (``host``, ``proc``, ``slice``).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

ENV_PATH = "DSTACK_TPU_TELEMETRY_PATH"

# Buffer/flush defaults: at one point per second-scale train step a 4096-point
# buffer holds over an hour of backlog; the 0.25 s flush keeps the agent's
# tail near-real-time without measurable file-IO pressure.
DEFAULT_CAPACITY = 4096
DEFAULT_FLUSH_INTERVAL = 0.25


def _iso_now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _host_identity() -> Dict[str, Any]:
    """Per-host identity stamped on every point so a gang's N streams stay
    attributable after they merge server-side (services/gang_health.py):
    ``host`` (hostname), ``proc`` (torchrun's global ``RANK``, else the TPU
    worker / node rank when the agent's cluster env is present), ``slice``
    (MegaScale slice id on multislice).
    Env-only + stdlib, so the first marks need no framework."""
    ident: Dict[str, Any] = {}
    try:
        ident["host"] = socket.gethostname()
    except Exception:
        pass
    for field, names in (
        ("proc", ("RANK", "TPU_WORKER_ID", "DSTACK_NODE_RANK")),
        ("slice", ("MEGASCALE_SLICE_ID",)),
    ):
        for name in names:
            raw = os.environ.get(name)
            if raw:
                try:
                    ident[field] = int(raw)
                except ValueError:
                    continue  # unparsable -> try the next fallback var
                break
    return ident


class _TorchProfiler:
    """Default control-hook profiler: a torch.profiler capture of the CPU and,
    where there is one, the CUDA device, written as a Chrome trace into the
    artifact directory. torch is imported only when a capture starts."""

    def __init__(self) -> None:
        self._prof = None
        self._logdir: Optional[str] = None

    def start(self, logdir: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._logdir = logdir

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._logdir, "trace.json"))


class TelemetryEmitter:
    """Bounded, never-blocking telemetry channel to the runner agent.

    ``profiler`` is injectable for tests (needs ``start(logdir)``/``stop()``);
    ``None`` selects the lazy torch profiler."""

    def __init__(
        self,
        path: str,
        capacity: int = DEFAULT_CAPACITY,
        flush_interval: float = DEFAULT_FLUSH_INTERVAL,
        profiler: Optional[Any] = None,
    ) -> None:
        self.path = path
        self.capacity = max(1, int(capacity))
        self.flush_interval = flush_interval
        self.enabled = True
        self.dropped = 0
        self.write_errors = 0
        self.profile_errors = 0
        self._buf: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._closed = threading.Event()
        self._profiler = profiler if profiler is not None else _TorchProfiler()
        self.identity: Dict[str, Any] = _host_identity()
        self._profile_id = 0  # last handled control-command id
        self._profile_stop_at: Optional[float] = None
        self._profile_artifact: Optional[str] = None
        self._ctl_sig: Optional[tuple] = None  # (mtime_ns, size) of last read ctl
        self._reported = (0, 0)  # (dropped, write_errors) already shipped
        self._thread = threading.Thread(
            target=self._flush_loop, name="telemetry-flush", daemon=True
        )
        self._thread.start()

    # -- the hot path ------------------------------------------------------

    def emit(self, kind: str, **fields: Any) -> None:
        """Queue one point. Safe to call from any thread, including the train
        step's — a full buffer drops (and counts), nothing here raises."""
        try:
            point = {"ts": _iso_now(), "kind": kind}
            # Identity first so an explicit field (tests, multi-tenant
            # harnesses) can override what the env derived.
            point.update(self.identity)
            point.update(fields)
            with self._lock:
                if len(self._buf) >= self.capacity:
                    self.dropped += 1
                    return
                self._buf.append(point)
        except Exception:
            # The emitter must never take the workload down, full stop.
            self.dropped += 1

    def step(self, step: int, step_time_s: float, **fields: Any) -> None:
        self.emit("step", step=step, step_time_s=step_time_s, **fields)

    def mark(self, event: str, **fields: Any) -> None:
        self.emit("mark", event=event, **fields)

    def set_identity(self, **fields: Any) -> None:
        """Merge identity fields stamped on every subsequent point (the train
        entrypoint sets ``proc`` to its process index; the env derivation
        above may be absent in local runs)."""
        try:
            self.identity.update(fields)
        except Exception:
            pass

    # -- flushing ----------------------------------------------------------

    def flush(self, timeout: float = 2.0) -> None:
        """Best-effort synchronous drain (used at run end so the final points
        are durable before the process exits). Never raises."""
        try:
            self._flush_once()
        except Exception:
            self.write_errors += 1
        # The background thread may be mid-write; give it a beat.
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._buf:
                    return
            time.sleep(0.01)

    def close(self, timeout: float = 2.0) -> None:
        """Flush and stop the background thread. Idempotent, never raises."""
        if self._closed.is_set():
            return
        self._closed.set()
        self._wake.set()
        try:
            self._thread.join(timeout)
        except Exception:
            pass
        try:
            self._stop_profile_if_due(force=True)
        except Exception:
            pass
        self.flush(timeout=0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "buffered": len(self._buf),
                "dropped": self.dropped,
                "write_errors": self.write_errors,
                "profile_errors": self.profile_errors,
            }

    def _flush_loop(self) -> None:
        while not self._closed.wait(self.flush_interval):
            try:
                self._poll_control()
            except Exception:
                self.profile_errors += 1
            try:
                self._stop_profile_if_due()
            except Exception:
                self.profile_errors += 1
            try:
                self._flush_once()
            except Exception:
                self.write_errors += 1
        # Final drain on close.
        try:
            self._flush_once()
        except Exception:
            self.write_errors += 1

    def _flush_once(self) -> None:
        with self._lock:
            if not self._buf:
                batch: List[dict] = []
            else:
                batch = list(self._buf)
                self._buf.clear()
            # Report counter advances as their own point so drops are visible
            # downstream even though the dropped points themselves are gone.
            counters = (self.dropped, self.write_errors)
            if counters != self._reported:
                batch.append(
                    {
                        "ts": _iso_now(),
                        "kind": "emitter",
                        "dropped": counters[0],
                        "write_errors": counters[1],
                    }
                )
                self._reported = counters
        if not batch:
            return
        lines = []
        for point in batch:
            try:
                lines.append(json.dumps(point, default=str))
            except Exception:
                self.dropped += 1
        if not lines:
            return
        try:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        except Exception:
            # Count the batch as dropped: it is gone, and the write error
            # alone would undercount the loss.
            self.write_errors += 1
            self.dropped += len(lines)

    # -- the profiler control hook ----------------------------------------

    @property
    def _ctl_path(self) -> str:
        return self.path + ".ctl"

    def _poll_control(self) -> None:
        try:
            st = os.stat(self._ctl_path)
        except OSError:
            return
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._ctl_sig:
            return
        with open(self._ctl_path, "r", encoding="utf-8") as f:
            cmd = json.loads(f.read())
        if not isinstance(cmd, dict) or cmd.get("cmd") != "profile":
            self._ctl_sig = sig
            return
        cmd_id = int(cmd.get("id") or 0)
        if cmd_id <= self._profile_id:
            self._ctl_sig = sig
            return  # already handled (mtime jitter, agent rewrite)
        if self._profile_stop_at is not None:
            # One capture at a time — but do NOT consume the command: leaving
            # the signature unrecorded makes the next tick retry it, so a
            # request that arrived mid-capture starts when this one stops
            # instead of silently vanishing.
            return
        self._ctl_sig = sig
        self._profile_id = cmd_id
        seconds = min(max(float(cmd.get("seconds") or 5.0), 0.1), 600.0)
        artifact = os.path.join(os.path.dirname(self.path), "profile", str(cmd_id))
        # Mark (and flush) BEFORE starting: on a loaded host a profiler start
        # can block for seconds against the training thread, and the
        # operator polling the metrics channel should see the request was
        # picked up rather than silence.
        self.mark("profile_start", profile_id=cmd_id, seconds=seconds, artifact=artifact)
        try:
            self._flush_once()
        except Exception:
            self.write_errors += 1
        try:
            self._profiler.start(artifact)
        except Exception as e:
            self.profile_errors += 1
            self.mark("profile_error", profile_id=cmd_id, error=str(e)[:200])
            return
        self._profile_artifact = artifact
        # The capture window counts from when tracing actually began (start
        # may block under load); `seconds` is a minimum, stop lands on the
        # next flush tick after it elapses.
        self._profile_stop_at = time.monotonic() + seconds

    def _stop_profile_if_due(self, force: bool = False) -> None:
        if self._profile_stop_at is None:
            return
        if not force and time.monotonic() < self._profile_stop_at:
            return
        artifact, self._profile_artifact = self._profile_artifact, None
        self._profile_stop_at = None
        try:
            self._profiler.stop()
        except Exception as e:
            self.profile_errors += 1
            self.mark("profile_error", profile_id=self._profile_id, error=str(e)[:200])
            return
        self.mark("profile_end", profile_id=self._profile_id, artifact=artifact)


class NullEmitter:
    """The disabled emitter (no DSTACK_TPU_TELEMETRY_PATH): same surface, no
    buffer, no thread — workloads call it unconditionally and pay nothing."""

    enabled = False
    path = None
    dropped = 0
    write_errors = 0

    def __init__(self) -> None:
        self.identity: Dict[str, Any] = {}

    def emit(self, kind: str, **fields: Any) -> None:
        pass

    def set_identity(self, **fields: Any) -> None:
        pass

    def step(self, step: int, step_time_s: float, **fields: Any) -> None:
        pass

    def mark(self, event: str, **fields: Any) -> None:
        pass

    def flush(self, timeout: float = 0.0) -> None:
        pass

    def close(self, timeout: float = 0.0) -> None:
        pass

    def stats(self) -> Dict[str, int]:
        return {"buffered": 0, "dropped": 0, "write_errors": 0, "profile_errors": 0}


_emitter: Optional[Any] = None
_emitter_lock = threading.Lock()


def get_emitter() -> Any:
    """Process-wide emitter, created on first use from DSTACK_TPU_TELEMETRY_PATH
    (the runner agent sets it; unset = NullEmitter, telemetry off)."""
    global _emitter
    with _emitter_lock:
        if _emitter is None:
            path = os.environ.get(ENV_PATH, "")
            _emitter = TelemetryEmitter(path) if path else NullEmitter()
        return _emitter


def configure(emitter: Optional[Any]) -> Any:
    """Swap the process-wide emitter (tests; None resets to re-read the env).
    Returns the previous emitter WITHOUT closing it — the caller owns both."""
    global _emitter
    with _emitter_lock:
        prev, _emitter = _emitter, emitter
        return prev
