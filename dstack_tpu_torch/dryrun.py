"""The port's entry points for a compile check and a multi-rank check: a
forward of the flagship model, and a dry run of every mesh axis over
several processes.

    python -m dstack_tpu_torch.dryrun [n] [--device cpu]

The counterpart of the repository's ``__graft_entry__.py``. ``entry()``
returns the ``test`` preset's forward and a [2, 128] token batch.
``dryrun_multichip(n)`` starts n ranks (``torch.distributed``: gloo on the
CPU, NCCL with a card a rank, gloo with ranks sharing cards) and runs what
the JAX dry run runs, on tiny shapes, one optimizer step or one
value-and-grad each:

- the dense train step over n factored into (dp, fsdp, tp, sp), every axis
  that fits getting 2 (n = 16 gives 2 x 2 x 2 x 2), so ring attention runs;
- the same step on a multislice mesh (4 slices when n >= 8 and divides by
  4, else 2; 2-way tp inside a slice when it fits);
- at n >= 8, the MoE step at dp 2 x ep 2 x tp 2 (``moe_test``, max_seq_len
  128) on 8 ranks;
- at n >= 4, the pipelined value-and-grad at dp 2 x pp 2 (GPipe, n_micro
  2, no remat) on 4 ranks.

A part whose mesh spans fewer ranks than n runs in a world of its own
size, beside the others. Rank 0 prints the JAX dry run's line for each part
(its mesh shape and the loss), and every loss must be finite and positive.
Each world must finish within a timeout, so a hung collective fails the
run. The entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DRYRUN_RANKS = 16
ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when none is asked for (which must exist)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def entry(device=None):
    """(fn, example_args): the forward step of the flagship model (the
    ``test`` preset, weights from seed 0) and a [2, 128] batch of token 0."""
    from dstack_tpu_torch.workloads import model as model_lib
    from dstack_tpu_torch.workloads.config import get_config

    device = resolve_device(device)
    cfg = get_config("test")
    params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=device)

    def fn(params, tokens):
        return model_lib.forward(params, tokens, cfg)

    return fn, (params, tokens)


def factor_axes(n: int) -> Dict[str, int]:
    """n ranks factored into (dp, fsdp, tp, sp) as the JAX dry run does:
    sp, tp, fsdp and dp each take 2 while n stays even, fsdp the rest."""
    axes = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    remaining = n
    for name in ("sp", "tp", "fsdp", "dp"):
        if remaining % 2 == 0:
            axes[name] *= 2
            remaining //= 2
    axes["fsdp"] *= remaining
    return axes


def multislice_shape(n: int) -> Optional[Dict[str, int]]:
    """The multislice part's shape (slices, devices a slice, fsdp and tp
    inside a slice), or None where the JAX dry run skips it."""
    num_slices = 4 if n >= 8 and n % 4 == 0 else 2
    if n < 2 or n % num_slices:
        return None
    per_slice = n // num_slices
    tp = 2 if per_slice % 2 == 0 else 1
    return dict(slices=num_slices, per_slice=per_slice, fsdp=per_slice // tp, tp=tp)


def _batch(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int64)


def _train_step(mesh, cfg, device, tokens, targets) -> float:
    from dstack_tpu_torch.workloads import train as train_lib

    optimizer = train_lib.make_optimizer()
    state = train_lib.init_train_state(cfg, optimizer, device, mesh=mesh)
    step = train_lib.make_train_step(cfg, optimizer, mesh)
    tok, tgt = train_lib.local_batch(tokens, targets, mesh)
    _, metrics = step(state, torch.from_numpy(tok).to(device), torch.from_numpy(tgt).to(device))
    return metrics["loss"].item()


def part_dense(n: int, device: torch.device) -> str:
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import get_config

    axes = factor_axes(n)
    mesh = sharding.make_mesh(**axes).connect(device)
    cfg = get_config("test")
    b, t = 2 * axes["dp"] * axes["fsdp"], 128 * axes["sp"]
    loss = _check(_train_step(mesh, cfg, device, _batch(1, (b, t), cfg.vocab_size),
                              _batch(2, (b, t), cfg.vocab_size)), "")
    return (f"dryrun_multichip ok: mesh dp={axes['dp']} fsdp={axes['fsdp']} "
            f"tp={axes['tp']} sp={axes['sp']}, loss={loss:.4f}")


def part_multislice(n: int, device: torch.device) -> str:
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads.config import get_config

    shape = multislice_shape(n)
    # Slice i holds ranks [i * per_slice, (i + 1) * per_slice).
    slice_ids = [r // shape["per_slice"] for r in range(n)]
    mesh = sharding.make_multislice_mesh(shape["slices"], slice_ids, fsdp=shape["fsdp"],
                                         tp=shape["tp"]).connect(device)
    cfg = get_config("test")
    b = 2 * shape["slices"] * shape["fsdp"]
    loss = _check(_train_step(mesh, cfg, device, _batch(3, (b, 128), cfg.vocab_size),
                              _batch(4, (b, 128), cfg.vocab_size)), "multislice ")
    return (f"dryrun_multichip multislice ok: {shape['slices']} slices x {shape['per_slice']}"
            f" devices (fsdp={shape['fsdp']} tp={shape['tp']}), loss={loss:.4f}")


def part_moe(n: int, device: torch.device) -> str:
    from dstack_tpu_torch.workloads import moe as moe_lib
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads import train as train_lib

    cfg = dataclasses.replace(moe_lib.MOE_PRESETS["moe_test"], max_seq_len=128)
    mesh = sharding.make_moe_mesh(dp=2, fsdp=1, ep=2, tp=2, sp=1).connect(device)
    optimizer = train_lib.make_optimizer()
    state = moe_lib.init_moe_train_state(cfg, optimizer, device, mesh=mesh)
    step = moe_lib.make_moe_train_step(cfg, optimizer, mesh)
    tokens = _batch(5, (8, 128), cfg.vocab_size)
    tok, _ = train_lib.local_batch(tokens, tokens, mesh)
    tok = torch.from_numpy(tok).to(device)
    _, metrics = step(state, tok, tok)
    loss = _check(metrics["loss"].item(), "MoE ")
    return (f"dryrun_multichip MoE ok: ep=2 tp=2 dp=2 "
            f"({cfg.n_experts} experts top-{cfg.top_k}), loss={loss:.4f}")


def part_pipeline(n: int, device: torch.device) -> str:
    from dstack_tpu_torch.workloads import data as data_lib
    from dstack_tpu_torch.workloads import model as model_lib
    from dstack_tpu_torch.workloads import pipeline as pp_lib
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("test", remat=False)
    mesh = pp_lib.make_pp_mesh(dp=2, pp=2).connect(device)
    params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    local = {k: v.clone().requires_grad_(True)
             for k, v in pp_lib.shard_params_pp(params, mesh).items()}
    tokens = _batch(6, (4, 128), cfg.vocab_size)
    rows = data_lib.rank_rows(4, 2, mesh.index("dp"), mesh.shape["dp"])
    tok = torch.from_numpy(tokens[rows]).to(device)
    loss = pp_lib.pipelined_loss_fn(local, tok, tok, cfg, mesh, n_micro=2)
    torch.autograd.grad(loss, list(local.values()))
    loss = _check(loss.item(), "pipeline ")
    return f"dryrun_multichip pipeline ok: pp=2 dp=2 (GPipe), loss={loss:.4f}"


PARTS = {"dense": part_dense, "multislice": part_multislice, "moe": part_moe,
         "pipeline": part_pipeline}


def _check(loss: float, what: str) -> float:
    if not (math.isfinite(loss) and loss > 0):
        raise AssertionError(f"bad {what}loss {loss}")
    return loss


def plan(n: int) -> List[tuple]:
    """[(world size, parts)] in the order the JAX dry run prints them."""
    main = ["dense"] + (["multislice"] if multislice_shape(n) else [])
    worlds = [(n, main)]
    for size, part in ((8, "moe"), (4, "pipeline")):
        if n == size:
            main.append(part)
        elif n > size:
            worlds.append((size, [part]))
    return worlds


def _start_world(world: int, parts: List[str], n: int, device: str,
                 workdir: str) -> List[subprocess.Popen]:
    """``parts`` on ``world`` rank processes, started."""
    init = os.path.join(workdir, f"init-{world}-{'-'.join(parts)}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    # A rank's host work is small; one thread a rank keeps n ranks from
    # oversubscribing the host's cores.
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.dryrun", "--rank", str(r), "--world",
         str(world), "--init", init, "--parts", ",".join(parts), "--device", device, str(n)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _finish_world(procs: List[subprocess.Popen], parts: List[str], deadline: float) -> List[str]:
    """Wait for a world's ranks until ``deadline``; rank 0's printed lines."""
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dry run: {len(procs)} ranks ({', '.join(parts)}) did not finish"
                           f" in time") from None
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise RuntimeError(f"dry run rank {r} of {len(procs)} exited {proc.returncode}:\n"
                               f"{out[-4000:]}")
    return [line for line in outs[0].splitlines() if line.startswith("dryrun_multichip")]


def dryrun_multichip(n_devices: int = DRYRUN_RANKS, device=None,
                     timeout: float = 600.0) -> List[str]:
    """One step of every mesh axis on ``n_devices`` rank processes (see the
    module's docstring); prints and returns rank 0's lines. ``device``:
    "cpu" runs the ranks on the CPU over gloo; otherwise on the card(s).
    On the card the worlds run side by side (their ranks wait mostly on
    starting a CUDA context); on the CPU, where they would compete for the
    cores, one after another. All must finish within ``timeout`` seconds."""
    device = resolve_device(device).type
    lines = []
    worlds = []
    with tempfile.TemporaryDirectory(prefix="dryrun-") as workdir:
        deadline = time.monotonic() + timeout

        def start(world, parts):
            return parts, _start_world(world, parts, n_devices, device, workdir)

        try:
            pending = plan(n_devices)
            if device != "cpu":
                worlds = [start(*w) for w in pending]
            for i, w in enumerate(pending):
                if device == "cpu":
                    worlds.append(start(*w))
                parts, procs = worlds[i]
                for line in _finish_world(procs, parts, deadline):
                    print(line, flush=True)
                    lines.append(line)
        finally:
            for _, procs in worlds:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
    return lines


def _rank_main(args) -> None:
    """One rank of a dry-run world: join the group, run the parts, and on
    rank 0 print each part's line."""
    if args.device == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        count = torch.cuda.device_count()
        device = torch.device("cuda", args.rank % count)
        torch.cuda.set_device(device)
        backend = "nccl" if count >= args.world else "gloo"
    dist.init_process_group(backend, init_method=f"file://{args.init}", rank=args.rank,
                            world_size=args.world, timeout=GROUP_TIMEOUT)
    try:
        for part in args.parts.split(","):
            line = PARTS[part](args.n, device)
            if args.rank == 0:
                print(line, flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=DRYRUN_RANKS)
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--parts", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return
    dryrun_multichip(args.n, args.device)
    fn, fn_args = entry(args.device)
    with torch.no_grad():
        out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), str(out.dtype).replace("torch.", ""), flush=True)


if __name__ == "__main__":
    main()
