"""Async checkpointing in the JAX package's on-disk format.

The port of ``dstack_tpu/workloads/checkpoint.py``. A checkpoint either
package writes, the other reads:

- ``step-%08d/shard-%05d.npz``: one file per process, whose members are
  named ``"<leaf index>@<a:b,c:d>"``, the leaf's position in the flattened
  state and the global index of the piece it holds. Extension dtypes
  (bfloat16, fp8) are stored as same-width unsigned views.
- ``step-%08d/manifest.json``: ``step``, ``process_count``, ``mesh``,
  ``data_offset``, ``leaves`` (key, shape, dtype name) and ``extra``.
- ``step-%08d/_COMMIT-%05d``: written last, once the shard is durable; a
  step is complete when every process's marker exists.

Leaves are keyed by the JAX tree path strings (``jax.tree_util.keystr``):
``leaf_entries`` flattens dicts in sorted key order (``['k']``), named
tuples by field (``.name``) and other tuples and lists by position
(``[i]``), as JAX flattens dicts, optax's states and tuples. The training
state's layout in those terms is ``train.state_tree``.

The port runs without a mesh, so it writes one whole-array piece per leaf,
keyed ``0:n,...`` (``""`` for a 0-d leaf), exactly as a meshless
``jax.Array``'s one addressable shard is keyed. Reading merges every shard
file of a step by global index, so a checkpoint JAX wrote from several
processes or on a mesh restores here too, and incomplete coverage raises.

``save()`` blocks only for the device-to-host copy (and the previous
write), writes on a background thread and never raises: a failed save is
counted and marked. A checkpoint that cannot be read raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dstack_tpu_torch.workloads import telemetry as telemetry_lib
from dstack_tpu_torch.workloads.convert import storage_dtype, tensor_from_host

_STEP_DIR_RE = re.compile(r"^step-(\d+)$")


class LeafSpec(NamedTuple):
    """A template leaf without data (the port's ``jax.ShapeDtypeStruct``):
    restore makes a tensor of this shape and dtype on ``device``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device = torch.device("cpu")


def _step_dir(step: int) -> str:
    return f"step-{step:08d}"


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, LeafSpec))


def leaf_entries(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Stable ``(key, leaf)`` pairs in JAX's flattening order, keyed by
    JAX's tree path strings, so both packages name a leaf alike."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_entries(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += leaf_entries(getattr(tree, name), f"{prefix}.{name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, child in enumerate(tree):
            out += leaf_entries(child, f"{prefix}[{i}]")
        return out
    raise TypeError(f"{prefix or 'tree'}: cannot checkpoint a {type(tree).__name__}")


def _rebuild(tree, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``
    (an iterator), as ``jax.tree_util.tree_unflatten``."""
    if _is_leaf(tree):
        return next(leaves)
    if isinstance(tree, dict):
        rebuilt = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: rebuilt[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(child, leaves) for child in tree)
    raise TypeError(f"cannot rebuild a {type(tree).__name__}")


def _dtype_name(leaf) -> str:
    """The manifest's dtype name: numpy's (and ml_dtypes') spelling, which
    torch's dtype names share."""
    return str(leaf.dtype).removeprefix("torch.")


def _index_key(shape) -> str:
    """The ``a:b,c:d`` key of a whole-array piece (``""`` when 0-d)."""
    return ",".join(f"0:{int(d)}" for d in shape)


def _parse_index(key: str) -> Tuple[slice, ...]:
    if not key:
        return ()
    return tuple(
        slice(int(a), int(b)) for a, b in (p.split(":") for p in key.split(","))
    )


def _host_copy(leaf) -> np.ndarray:
    """Device-to-host copy of one leaf, in its savable form: builtin numpy
    dtypes as they are, extension dtypes as same-width unsigned views. A
    new array, so the training step may go on updating the leaf in place
    while the writer thread holds the copy."""
    if isinstance(leaf, np.ndarray):
        arr = np.array(leaf)
        if arr.dtype.isbuiltin == 1:
            return arr
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    t = leaf.detach().to("cpu", copy=True)
    store = storage_dtype(_dtype_name(t))
    if store is None:
        return t.numpy()
    signed = {1: torch.int8, 2: torch.int16}[t.element_size()]
    return t.view(signed).numpy().view(store)


class CheckpointManager:
    """Async checkpointing of a tree of tensors (the JAX manager's
    contract). ``save()`` is called from the train loop, ``restore()`` at
    startup. One manager per process."""

    def __init__(
        self,
        directory: str,
        keep: int = 2,
        telemetry: Optional[Any] = None,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        self.directory = directory
        self.keep = max(1, keep)
        self.process_index = process_index
        self.process_count = process_count
        self._telemetry = telemetry if telemetry is not None else telemetry_lib.get_emitter()
        self.save_errors = 0
        self.last_error: Optional[BaseException] = None
        self.saves = 0
        self._pending: Optional[threading.Event] = None
        self._closed = False
        os.makedirs(directory, exist_ok=True)

    # -- writing -----------------------------------------------------------

    def save(
        self,
        step: int,
        state,
        data_offset: Optional[int] = None,
        mesh_shape: Optional[Dict[str, int]] = None,
        extra: Optional[dict] = None,
        block: bool = False,
    ) -> None:
        """Snapshot ``state`` at ``step``. Blocks only for the device-to-host
        copy (and for the previous save's write, if still in flight); the
        write happens on a background thread. Never raises: a failed save is
        counted and marked, not fatal to training."""
        if self._closed:
            return
        t0 = time.perf_counter()
        self._telemetry.mark("checkpoint_start", step=step)
        try:
            # Double-buffer bound: at most one host snapshot awaiting write.
            self.wait()
            payload: Dict[str, np.ndarray] = {}
            leaves: List[dict] = []
            for i, (key, leaf) in enumerate(leaf_entries(state)):
                shape = list(leaf.shape)
                leaves.append({"key": key, "shape": shape, "dtype": _dtype_name(leaf)})
                payload[f"{i}@{_index_key(shape)}"] = _host_copy(leaf)
            manifest = {
                "step": int(step),
                "process_count": self.process_count,
                "mesh": dict(mesh_shape) if mesh_shape else None,
                "data_offset": int(data_offset) if data_offset is not None else None,
                "leaves": leaves,
                "extra": extra or {},
            }
        except BaseException as e:  # noqa: BLE001 - never kill the train step
            self.save_errors += 1
            self.last_error = e
            self._telemetry.mark("checkpoint_error", step=step, error=str(e)[:200])
            # Close the bracket: a dangling checkpoint_start would bill the
            # time up to the window's edge to checkpointing in the ledger.
            self._telemetry.mark(
                "checkpoint_end", step=step,
                blocked_s=round(time.perf_counter() - t0, 6), failed=True,
            )
            return
        blocked = time.perf_counter() - t0
        done = threading.Event()
        self._pending = done
        threading.Thread(
            target=self._write, args=(step, payload, manifest, done),
            name="checkpoint-write", daemon=True,
        ).start()
        self._telemetry.mark("checkpoint_end", step=step, blocked_s=round(blocked, 6))
        if block:
            self.wait()

    def _write(self, step: int, payload, manifest, done: threading.Event) -> None:
        t0 = time.perf_counter()
        path = os.path.join(self.directory, _step_dir(step))
        try:
            os.makedirs(path, exist_ok=True)
            shard = os.path.join(path, f"shard-{self.process_index:05d}.npz")
            tmp = shard + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, shard)
            if self.process_index == 0:
                mtmp = os.path.join(path, "manifest.json.tmp")
                with open(mtmp, "w", encoding="utf-8") as f:
                    json.dump(manifest, f)
                os.replace(mtmp, os.path.join(path, "manifest.json"))
            # Commit marker last: readers take the step as complete only when
            # every process's marker exists.
            with open(os.path.join(path, f"_COMMIT-{self.process_index:05d}"), "w") as f:
                f.write(str(step))
            self.saves += 1
            self._telemetry.mark(
                "checkpoint_saved", step=step,
                write_s=round(time.perf_counter() - t0, 6), path=path,
            )
            self._prune()
        except BaseException as e:  # noqa: BLE001
            self.save_errors += 1
            self.last_error = e
            self._telemetry.mark("checkpoint_error", step=step, error=str(e)[:200])
        finally:
            done.set()

    def _prune(self) -> None:
        if self.process_index != 0:
            return
        for step in self.complete_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, _step_dir(step)), ignore_errors=True)

    def wait(self, timeout: float = 600.0) -> bool:
        """Drain the in-flight write (True = nothing pending or it finished)."""
        pending = self._pending
        if pending is None:
            return True
        ok = pending.wait(timeout)
        if ok:
            self._pending = None
        return ok

    def close(self, timeout: float = 600.0) -> None:
        """Drain pending writes; further saves become no-ops. Idempotent."""
        self.wait(timeout)
        self._closed = True

    # -- reading -----------------------------------------------------------

    def complete_steps(self) -> List[int]:
        """Ascending steps whose every per-process commit marker exists."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.directory, name)
            manifest = self._read_manifest(path)
            if manifest is None:
                continue
            n = int(manifest.get("process_count") or 1)
            if all(os.path.exists(os.path.join(path, f"_COMMIT-{p:05d}")) for p in range(n)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _read_manifest(path: str) -> Optional[dict]:
        try:
            with open(os.path.join(path, "manifest.json"), "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_manifest(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self._read_manifest(os.path.join(self.directory, _step_dir(step)))
        if manifest is None:
            raise FileNotFoundError(f"checkpoint {_step_dir(step)} has no readable manifest")
        return manifest

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint into ``template``'s structure: each leaf comes
        back as a new tensor in the template leaf's dtype and on its device
        (a numpy template leaf gets the host array). Returns ``(tree,
        manifest)``. Raises on any mismatch in structure or shape, and on
        missing shard coverage."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self.read_manifest(step)
        leaves = manifest["leaves"]
        entries = leaf_entries(template)
        if [k for k, _ in entries] != [leaf["key"] for leaf in leaves]:
            raise ValueError(
                f"checkpoint structure mismatch: saved {[leaf['key'] for leaf in leaves]}"
                f" vs template {[k for k, _ in entries]}"
            )
        for (key, leaf), meta in zip(entries, leaves):
            if list(leaf.shape) != list(meta["shape"]):
                raise ValueError(
                    f"{key}: checkpoint shape {meta['shape']} != template {list(leaf.shape)}"
                    f" - the model/optimizer config changed under the checkpoint"
                )
        path = os.path.join(self.directory, _step_dir(step))
        host = self._load_host_arrays(path, leaves, set(range(len(leaves))))
        restored = [
            _materialize(leaf, host.pop(i), leaves[i]["dtype"])
            for i, (_, leaf) in enumerate(entries)
        ]
        return _rebuild(template, iter(restored)), manifest

    def restore_subtree(self, template, step: Optional[int] = None, prefix: str = ""):
        """Restore only the leaves matching ``template``'s keys: the
        train-to-serve handoff (the engine wants ``.params`` of a whole
        TrainState, without reading the optimizer's moments). Each key is
        matched as ``prefix + key`` first, then as a unique suffix; an
        ambiguous suffix raises with the candidate prefixes. Only the
        matched leaves' bytes are read. Returns ``(tree, manifest)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.directory}")
        manifest = self.read_manifest(step)
        leaves = manifest["leaves"]
        saved_keys = [leaf["key"] for leaf in leaves]
        by_key = {k: i for i, k in enumerate(saved_keys)}
        entries = leaf_entries(template)
        picked: List[int] = []
        for key, leaf in entries:
            i = by_key.get(prefix + key)
            if i is None:
                matches = [j for j, sk in enumerate(saved_keys) if sk.endswith(key)]
                if not matches:
                    raise ValueError(
                        f"checkpoint {_step_dir(step)} has no leaf matching"
                        f" {prefix + key!r} (or suffix {key!r})"
                    )
                if len(matches) > 1:
                    prefixes = sorted(saved_keys[j][: -len(key)] for j in matches)
                    raise ValueError(
                        f"{key!r} is ambiguous in {_step_dir(step)}: matches under prefixes"
                        f" {prefixes} - pass prefix= to pick one"
                    )
                i = matches[0]
            if list(leaf.shape) != list(leaves[i]["shape"]):
                raise ValueError(
                    f"{key}: checkpoint shape {leaves[i]['shape']} != template"
                    f" {list(leaf.shape)} - the model config changed under the checkpoint"
                )
            picked.append(i)
        path = os.path.join(self.directory, _step_dir(step))
        host = self._load_host_arrays(path, leaves, set(picked))
        restored = [
            _materialize(leaf, host[i], leaves[i]["dtype"])
            for (_, leaf), i in zip(entries, picked)
        ]
        return _rebuild(template, iter(restored)), manifest

    @staticmethod
    def _load_host_arrays(path: str, leaves: List[dict], wanted) -> Dict[int, np.ndarray]:
        """The global host array of every leaf index in ``wanted``, merged
        from the step's shard files by global index, in its storage dtype
        (extension dtypes as unsigned views). Unwanted leaves' bytes are not
        read. Raises on incomplete coverage."""
        host: Dict[int, np.ndarray] = {}
        store = {}
        for i in wanted:
            meta = leaves[i]
            store[i] = storage_dtype(meta["dtype"]) or np.dtype(meta["dtype"])
        covered = {i: 0 for i in wanted}
        seen: Dict[int, set] = {i: set() for i in wanted}
        shard_files = sorted(
            os.path.join(path, n) for n in os.listdir(path)
            if n.startswith("shard-") and n.endswith(".npz")
        )
        for fname in shard_files:
            with np.load(fname) as z:
                for zkey in z.files:
                    leaf_s, _, idx_key = zkey.partition("@")
                    i = int(leaf_s)
                    if i not in covered or idx_key in seen[i]:
                        continue  # unwanted, or replicated across processes
                    seen[i].add(idx_key)
                    shape = tuple(leaves[i]["shape"])
                    piece = z[zkey]
                    if piece.dtype != store[i]:
                        if piece.dtype.itemsize != store[i].itemsize:
                            raise ValueError(
                                f"{leaves[i]['key']}: shard dtype {piece.dtype}"
                                f" incompatible with manifest {leaves[i]['dtype']}"
                            )
                        piece = piece.view(store[i])
                    index = _parse_index(idx_key)
                    whole = not index or all(
                        sl.start == 0 and sl.stop == d for sl, d in zip(index, shape)
                    )
                    if whole:
                        # The whole leaf in one piece (a meshless save): keep
                        # the loaded array rather than copy it into zeros.
                        host[i] = piece.reshape(shape)
                    else:
                        if i not in host:
                            host[i] = np.zeros(shape, store[i])
                        host[i][index] = piece
                    covered[i] += int(piece.size)
        for i in wanted:
            meta = leaves[i]
            want = int(np.prod(meta["shape"])) if meta["shape"] else 1
            if covered[i] < want:
                raise ValueError(
                    f"{meta['key']}: shard files cover {covered[i]}/{want}"
                    f" elements - a process's shard file is missing"
                )
        return host


def _materialize(leaf, arr: np.ndarray, dtype_name: str):
    """One restored host array as its template leaf wants it: a tensor in
    the leaf's dtype on its device, or the numpy array for a numpy leaf."""
    if isinstance(leaf, np.ndarray):
        return arr
    t = tensor_from_host(arr, dtype_name)
    return t.to(device=leaf.device, dtype=leaf.dtype)
