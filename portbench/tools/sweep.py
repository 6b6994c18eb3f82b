"""Find a serving cell's knee once, on the card: run its mix at each given
rate for a window and print what each reached. The benchmark itself never
searches; a cell's mix holds the fixed rate that this sweep chose.

    python3 -m portbench.tools.sweep --workload <cell> --seed <n> --seconds 30 \\
        --rates 2 3 4 5 6
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from portbench import run

    run.fixed_caches()
    device = torch.device("cuda", 0)
    for rate in args.rates:
        r = run.load_run(args.workload, args.seed, args.seconds, False, device, time.monotonic())
        r.mix = dict(r.mix, rate_per_s=rate)
        result = run.execute(r)
        line = dict(rate_per_s=rate, correct=result["correct"], failed=result["failed"],
                    attempted=result["attempted"],
                    waiting_at_close=r.records["waiting_at_close"],
                    itl_p90_ms=r.records["itl_p90_ms"], prefill_ms=r.records["prefill_ms"],
                    **{k: v["value"] for k, v in result["metrics"].items()},
                    checks=r.checks)
        print(json.dumps(line), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
