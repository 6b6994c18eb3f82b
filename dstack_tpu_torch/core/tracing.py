"""Trace ids and duration histograms for the serving engine.

The port's own copy of what ``dstack_tpu/core/tracing.py`` gives the serving
engine: contextvar trace ids carried by ``X-Dstack-Trace-Id``, an in-process
fixed-bucket histogram registry, and its Prometheus text exposition. Metric
names and buckets are the JAX engine's, so the control plane's proxy and
scrapers read a replica of either package alike.
"""

from __future__ import annotations

import contextvars
import threading
import uuid
from typing import Dict, List, Optional, Tuple

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
)

# The header carrying a trace id from the service proxy to a serving replica.
TRACE_HEADER = "X-Dstack-Trace-Id"

_trace_id: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "dstack_tpu_torch_trace_id", default=None
)


def new_trace() -> str:
    """Start a fresh trace bound to the current context; returns its id."""
    tid = uuid.uuid4().hex[:16]
    _trace_id.set(tid)
    return tid


def set_trace_id(trace_id: str) -> str:
    """Adopt an externally minted trace id as the current context's trace."""
    _trace_id.set(trace_id)
    return trace_id


def current_trace_id() -> Optional[str]:
    return _trace_id.get()


def wrap_with_context(fn):
    """Run ``fn`` inside a snapshot of the caller's contextvars, taken now:
    a thread target starts from an empty context otherwise."""
    ctx = contextvars.copy_context()

    def _in_context(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return _in_context


class Histogram:
    """Cumulative fixed-bucket histogram (Prometheus semantics), one counter
    vector per label set."""

    __slots__ = ("name", "buckets", "_series")

    def __init__(self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        # label-items tuple -> [bucket_counts..., +Inf count, sum]
        self._series: Dict[Tuple[Tuple[str, str], ...], List[float]] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        key = tuple(sorted((labels or {}).items()))
        row = self._series.get(key)
        if row is None:
            row = self._series[key] = [0.0] * (len(self.buckets) + 2)
        for i, le in enumerate(self.buckets):
            if value <= le:
                row[i] += 1
        row[-2] += 1  # +Inf / total count
        row[-1] += value  # sum

    def snapshot(self) -> List[Tuple[Dict[str, str], List[float], float, float]]:
        """[(labels, cumulative_bucket_counts incl +Inf, sum, count)]."""
        return [
            (dict(key), list(row[:-1]), row[-1], row[-2])
            for key, row in sorted(self._series.items())
        ]


_lock = threading.Lock()
_histograms: Dict[str, Histogram] = {}


def observe(name: str, seconds: float, labels: Optional[Dict[str, str]] = None) -> None:
    """Record one duration into the named histogram (thread-safe)."""
    with _lock:
        hist = _histograms.get(name)
        if hist is None:
            hist = _histograms[name] = Histogram(name)
        hist.observe(seconds, labels)


def histogram_snapshot(name: str):
    """Snapshot of one histogram family, or None if never observed."""
    with _lock:
        hist = _histograms.get(name)
        return None if hist is None else (hist.buckets, hist.snapshot())


def _esc_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_exposition(help_map: Optional[Dict[str, str]] = None) -> str:
    """Prometheus text exposition of every registered histogram; families in
    ``help_map`` are advertised (HELP/TYPE) before their first observation."""
    names = list(help_map or {})
    with _lock:
        names += [n for n in sorted(_histograms) if n not in names]
    lines: List[str] = []
    for name in names:
        help_ = (help_map or {}).get(name, f"Span duration for {name}")
        lines.append(f"# HELP {name} " + help_.replace("\\", "\\\\").replace("\n", "\\n"))
        lines.append(f"# TYPE {name} histogram")
        snap = histogram_snapshot(name)
        if snap is None:
            continue
        buckets, series = snap
        for labels, cumulative, total, count in series:
            for le, c in zip([f"{b:g}" for b in buckets] + ["+Inf"], cumulative):
                inner = ",".join(
                    f'{k}="{_esc_label(v)}"'
                    for k, v in sorted({**labels, "le": le}.items())
                )
                lines.append(f"{name}_bucket{{{inner}}} {c:g}")
            if labels:
                inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in sorted(labels.items()))
                lines.append(f"{name}_sum{{{inner}}} {total:g}")
                lines.append(f"{name}_count{{{inner}}} {count:g}")
            else:
                lines.append(f"{name}_sum {total:g}")
                lines.append(f"{name}_count {count:g}")
    return "\n".join(lines) + "\n"
