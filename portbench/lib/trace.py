"""torch.profiler over the traced window, reduced to what the per-layer
readers need: kernel intervals by name, the union of busy time, device
time under named host ranges, and the longest idle gaps labelled by what
the host was doing (the harness's own ranges, ``portbench.*``, around the
calls into the program).
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench."
# record_function ranges that the profiler also lays on the device timeline;
# they are no kernels.
_RANGES = re.compile(r"^(ProfilerStep|Optimizer\.|moe\.|portbench\.)")


class Trace:
    """The reduced trace: ``kernels`` [(name, start_us, dur_us)] sorted by
    start, ``window_s`` the traced wall time, and the host's top-level
    operations for labelling gaps."""

    def __init__(self, kernels, window_s: float, host_ops, spans, range_device_us):
        self.kernels: List[Tuple[str, float, float]] = kernels
        self.window_s = window_s
        self._host = host_ops            # [(start_us, end_us, name)] top level, sorted
        self._spans = spans              # [(start_us, end_us, name)] harness spans, sorted
        self.range_device_us: Dict[str, float] = range_device_us

    def busy_s(self) -> float:
        """Seconds in which some kernel ran (union of intervals)."""
        return sum(b - a for a, b in self._merged()) / 1e6

    def _merged(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for _, start, dur in self.kernels:
            end = start + dur
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    def device_time_s(self, pattern: str) -> Tuple[float, int]:
        """(summed seconds, launches) of kernels whose name matches."""
        rx = re.compile(pattern)
        hits = [dur for name, _, dur in self.kernels if rx.search(name)]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = collections.Counter()
        for name, _, dur in self.kernels:
            total[name[:160]] += dur / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing at each gap's
        midpoint: the innermost harness span, then the host's top-level
        operation there."""
        merged = self._merged()
        by: Dict[str, float] = collections.Counter()
        span_starts = [s[0] for s in self._spans]
        host_starts = [h[0] for h in self._host]
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) / 2
            by[_label(mid, self._spans, span_starts) + " / "
               + _label(mid, self._host, host_starts)] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _label(t: float, intervals, starts) -> str:
    """The name of the latest-starting interval that covers ``t``."""
    last = bisect.bisect_right(starts, t) - 1
    for i in range(last, max(last - 64, -1), -1):
        if intervals[i][1] >= t:
            return intervals[i][2]
    return "host idle"


def _top_level(ops: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    out = []
    for op in sorted(ops):
        if not out or op[0] >= out[-1][1]:
            out.append(op)
    return out


def reduce(prof, window_s: float) -> Trace:
    kernels, host, spans = [], [], []
    ranges: Dict[str, float] = collections.Counter()
    for e in prof.events():
        device = str(e.device_type).endswith("CUDA")
        start, end = e.time_range.start, e.time_range.end
        if device:
            if getattr(e, "is_user_annotation", False) or _RANGES.match(e.name):
                continue
            kernels.append((e.name, float(start), float(end - start)))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((float(start), float(end), e.name))
        else:
            host.append((float(start), float(end), e.name))
            if _RANGES.match(e.name):
                ranges[e.name] += float(e.device_time_total)
    kernels.sort(key=lambda k: k[1])
    return Trace(kernels, window_s, _top_level(host), sorted(spans), dict(ranges))


class Tracer:
    """torch.profiler from ``start`` to ``stop``, each after a
    synchronisation, or nothing when disabled. ``trace`` is the reduced
    trace, worked out on first use: reducing a serving trace takes longer
    than its window, so it waits until the window has closed."""

    def __init__(self, enabled: bool, device):
        self.enabled, self.device = enabled, device
        self._prof = self._stopped = self._trace = None
        self._window = 0.0

    def warm(self) -> None:
        """An empty profiler run in set-up: the profiler's first start
        takes seconds (CUPTI loads), which must not fall in the window."""
        if self.enabled:
            self.start()
            self._prof.stop()
            self._prof = None

    @property
    def running(self) -> bool:
        return self._prof is not None

    @property
    def trace(self) -> Optional[Trace]:
        if self._trace is None and self._stopped is not None:
            self._trace = reduce(self._stopped, self._window)
            self._stopped = None
        return self._trace

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self._stopped is not None \
                or self._trace is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=activities, acc_events=True)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._sync()
        self._window = time.perf_counter() - self._t0
        self._prof.stop()
        self._stopped, self._prof = self._prof, None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
