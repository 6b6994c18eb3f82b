"""One run of one cell: ``python3 -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

The cell (``cells/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``) and
its mode (``modes/<mode>.py``). The mode makes the weights and inputs from
the seed on the card, warms up the cell's shapes, measures for
``--seconds``, and then runs the plain reference to decide ``correct``.
With ``--trace 1`` every per-layer reader under ``metrics/`` that finds
something to read reports. The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from portbench.lib import files

CHECKOUT = files.ROOT.parent
# Names that the measured process must not hold once the window has closed:
# the JAX package and JAX itself, compared by whole top-level names.
FORBIDDEN = ("jax", "jaxlib", "flax", "dstack_tpu")


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def fixed_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its CUDA libraries under build/torch_kernels itself)."""
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["DSTACK_TPU_AUTOTUNE_DIR"] = str(build / "autotune")


@dataclasses.dataclass
class Run:
    """Everything one run of a cell knows and fills in."""

    cell_name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float
    extra: Sequence[Path] = ()
    control: str = ""            # the program's lower-precision path (the control): its quant
    fault: Optional[str] = None  # a planted fault, for the tests of `correct`
    # filled by the mode
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    records: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    tracer: Any = None

    def now(self) -> float:
        return time.monotonic()

    def setup_done(self) -> None:
        """Marks the first timed step: set-up ran from process start to here."""
        self.metrics["setup_s"] = time.monotonic() - self.started
        self.log(f"set-up {self.metrics['setup_s']:.1f} s")

    def log(self, message: str) -> None:
        print(f"portbench: {message} (at {time.monotonic() - self.started:.1f} s)",
              file=sys.stderr, flush=True)

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared with its limit; the run is correct when every
        number is at or under its limit."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def load_run(workload: str, seed: int, seconds: float, trace: bool, device, started: float,
             extra: Sequence[Path] = (), control: str = "",
             fault: Optional[str] = None) -> Run:
    cell = files.load_json("cells", workload, extra)
    return Run(workload, cell, files.load_json("configs", cell["config"], extra),
               files.load_json("traffic", cell["traffic"], extra), seed, seconds, trace, device,
               started, extra, control, fault)


def per_layer(run: Run) -> Dict[str, dict]:
    """Every reader under metrics/ that finds something to read."""
    from portbench.lib.readers import Context

    ctx = Context.of(run)
    out = {}
    for name, module in files.iter_modules("metrics", run.extra):
        value = module.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": module.UNIT}
    return out


def execute(run: Run) -> dict:
    """Runs the cell's mode and returns the result (without ``device``)."""
    mode = files.load_module("modes", run.cell["mode"], run.extra)
    mode.run(run)
    correct = bool(run.checks) and all(c["value"] <= c["limit"] for c in run.checks.values())
    if run.trace:
        metrics = per_layer(run)
    else:
        units = mode.UNITS
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in run.metrics.items()}
    result = {"correct": correct and run.failed == 0, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics}
    if run.trace and run.tracer is not None and run.tracer.trace is not None:
        t = run.tracer.trace
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        result["traced"] = {"busy_s": t.busy_s(), "window_s": t.window_s}
    return result


def main(argv: Optional[Sequence[str]] = None, started: Optional[float] = None) -> int:
    started = time.monotonic() if started is None else started
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8", "int8"), default="",
                   help="run the program's lower-precision path of this quantization in"
                        " place of the configuration's precision (the control)")
    p.add_argument("--fault", default=None, help="plant a fault (unchanged, half_batch, token)")
    args = p.parse_args(argv)
    fixed_caches()

    import torch

    cell = files.load_json("cells", args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA card is available; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import dstack_tpu_torch  # noqa: F401  the program under test
    except ImportError as exc:
        print(f"portbench: the program is not here ({exc})", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = load_run(args.workload, args.seed, args.seconds, bool(args.trace), device, started,
                   control=args.control, fault=args.fault)
    result = execute(run)
    found = run.records.get("forbidden") or forbidden_modules()
    if found:
        print(f"portbench: the measured process holds {', '.join(found)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    traced = result.pop("traced", None)
    if traced:
        device_info.update(traced)
    result["device"] = device_info
    result["checks"] = run.checks
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
