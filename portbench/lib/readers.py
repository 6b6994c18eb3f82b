"""What a per-layer reader (``metrics/<name>.py``) is handed.

A reader is a module with ``UNIT``, ``BETTER``, ``LAYER``, ``MOVES``,
``SOURCE`` and ``read(ctx)``, which returns a number or None when the run
holds nothing for it to read (another mode, no trace, a card with no
published peak). It never returns 0 for a share of a peak it could not
read.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from portbench.lib import files
from portbench.lib.trace import Trace
from portbench.reference.dense import RefConfig


def peaks(device_name: str) -> Optional[dict]:
    table = json.loads((files.ROOT / "lib" / "peaks.json").read_text())["cards"]
    return table.get(device_name)


@dataclasses.dataclass
class Family:
    """A kernel family: its kernel-name patterns by call and the module
    that counts one call's FLOPs and bytes."""

    name: str
    spec: dict
    work: Any


def families(used_by: str, extra=()) -> List[Family]:
    out = []
    for name in files.names("kernels", ".json", extra):
        spec = files.load_json("kernels", name, extra)
        if spec.get("used_by") == used_by:
            out.append(Family(name, spec, files.load_module("kernels", spec["count"], extra)))
    return out


@dataclasses.dataclass
class Context:
    mode: str
    cell: dict
    ref: Optional[RefConfig]
    trace: Optional[Trace]
    peak: Optional[dict]
    records: Dict[str, Any]
    extra: Tuple = ()

    @classmethod
    def of(cls, run) -> "Context":
        name = run.records.get("device_name", "")
        trace = run.tracer.trace if run.tracer is not None else None
        return cls(run.cell["mode"], run.cell, run.records.get("ref"), trace,
                   peaks(name) if name else None, run.records, tuple(run.extra))

    def family_share(self, used_by: str, calls: Dict[str, List[dict]]) -> Optional[float]:
        """Sum of roofline bounds over sum of device time, in %, of the
        kernel families that serve ``used_by``. ``calls`` maps a call kind
        to the shapes of its calls in the traced window; when a call kind
        has a ``count_by`` pattern instead, every launch the trace shows of
        it takes ``calls[kind][0]``'s shape. A shape's ``launches`` (default
        1) counts identical launches, one per layer."""
        if self.trace is None or self.peak is None:
            return None
        bound = device = 0.0
        for fam in families(used_by, self.extra):
            for kind, spec in fam.spec["calls"].items():
                secs, _ = self.trace.device_time_s(spec["kernels"])
                if secs == 0.0:
                    continue
                shapes = calls.get(kind, [])
                if "count_by" in spec:
                    _, launches = self.trace.device_time_s(spec["count_by"])
                    shapes = shapes[:1] * launches if shapes else []
                for shape in shapes:
                    flops, nbytes = fam.work.work(kind, shape)
                    bound += shape.get("launches", 1) * max(
                        flops / self.peak["bf16_flops"], nbytes / self.peak["hbm_bytes_per_s"])
                device += secs
        if device == 0.0 or bound == 0.0:
            return None
        return 100.0 * bound / device
