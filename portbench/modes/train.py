"""Training cells: the port's train step on seeded weights and batches.

Set-up builds one train state from the benchmark's weights
(``train.init_train_state`` or ``moe.init_moe_train_state``) and one step
(``train.make_train_step`` or ``moe.make_moe_train_step``), and drives it
through the first ``reference_steps`` steps, through the same call and
feed as the window. Those steps warm every shape up. The window then runs
whole steps, each ended by reading its loss, for ``--seconds``.

``train_tokens_per_s`` is the tokens of every step that ended inside the
window over the time from the window's start to the end of the last of
them. Afterwards the program's state is freed and the plain reference
(``reference/``) follows the same first steps from the same weights and
batches; the run is correct when each of these is at or under its limit:

- ``loss_gap``: the largest gap between the program's and the reference's
  loss over those steps (nats);
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (after clipping; the program's read
  from its second moment after one step), over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_gap``: the same for the norm of each leaf's change over those
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

UNITS = {"train_tokens_per_s": "tokens/s", "setup_s": "s"}


def port_config(run):
    """The program's config object: the configuration file's port fields,
    the cell's cut and knobs, and the control's quantized products."""
    from dstack_tpu_torch.workloads.config import LlamaConfig
    from dstack_tpu_torch.workloads.moe import MoeConfig

    port = run.config["port"]
    fields = dict(port["fields"])
    fields.update(run.cell.get("cut", {}))
    fields.update(run.cell.get("port", {}))
    if run.control:
        fields["quant"] = run.control
    return {"LlamaConfig": LlamaConfig, "MoeConfig": MoeConfig}[port["class"]](**fields)


def leaf_norms(opt, params: Dict, b2: float) -> Dict[str, float]:
    """Each leaf's norm of the gradient the optimizer took at its first
    step, from the second moment it keeps: nu = (1 - b2) g^2."""
    out = {}
    for name, p in params.items():
        state = opt.state[p]
        nu = state["nu"] if "nu" in state else state["exp_avg_sq"]
        out[name] = math.sqrt(float(nu.double().sum()) / (1.0 - b2))
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's |prog - ref| over max(ref leaf, median ref leaf)."""
    names = [k for k in ref if keep is None or keep(k)]
    median = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in names}


def run(r) -> None:
    import torch
    from torch.profiler import record_function

    from dstack_tpu_torch.workloads import moe as moe_lib
    from dstack_tpu_torch.workloads import train as train_lib
    from portbench.lib import gen, weights
    from portbench.lib.trace import Tracer
    from portbench.reference import dense, moe as ref_moe
    from portbench.run import forbidden_modules

    cfg = port_config(r)
    tc = r.cell["train"]
    ref = dense.ref_config(r.config, cfg.n_layers)
    shapes = dense.tree_shapes(ref)
    is_moe = isinstance(cfg, moe_lib.MoeConfig)
    device = r.device
    r.records.update(ref=ref, device_name=_device_name(device))

    opt_kw = dict(learning_rate=tc["lr"], weight_decay=tc["weight_decay"], b1=tc["b1"],
                  b2=tc["b2"], grad_clip=tc["grad_clip"], mu_dtype=tc["mu_dtype"])
    optimizer = train_lib.make_optimizer(**opt_kw)
    params = weights.draw(shapes, r.seed, ref.d_model, device, torch.float32)
    if is_moe:
        state = moe_lib.init_moe_train_state(cfg, optimizer, params=params)
        step = moe_lib.make_moe_train_step(cfg, optimizer, grad_accum=tc["grad_accum"])
    else:
        state = train_lib.init_train_state(cfg, optimizer, params=params)
        step = train_lib.make_train_step(cfg, optimizer, grad_accum=tc["grad_accum"])
    del params
    step = _planted(r.fault, step)
    feed = gen.generator(r.mix, r.extra).train_batches(r.mix, r.seed, ref.vocab)
    batch, seq = r.mix["batch"], r.mix["seq"]

    def one_step() -> float:
        tokens, targets = next(feed)
        with record_function("portbench.batch_copy"):
            tok = torch.from_numpy(tokens).to(device, non_blocking=True)
            tgt = torch.from_numpy(targets).to(device, non_blocking=True)
        with record_function("portbench.train_step"):
            _, metrics = step(state, tok, tgt)
        with record_function("portbench.loss_read"):
            return float(metrics["loss"])

    # Set-up: the steps the reference follows, through the window's call.
    n_ref = tc["reference_steps"]
    losses = []
    for i in range(n_ref):
        losses.append(one_step())
        if i == 0:
            first = leaf_norms(state.opt, state.params, tc["b2"])
    with torch.no_grad():
        change = {}
        for index, (name, shape) in enumerate(shapes.items()):
            start = weights.draw_leaf(name, shape, index, r.seed, ref.d_model, device,
                                      torch.float32)
            change[name] = float(torch.linalg.vector_norm((state.params[name] - start).double()))
            del start

    # The window.
    r.sync()
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    r.tracer = Tracer(r.trace, device)
    r.tracer.warm()
    # The traced slice is the window's last ``trace_seconds`` (whole steps):
    # stopping the profiler processes its events, after the window.
    trace_from = r.seconds - r.cell.get("trace_seconds", r.seconds)
    r.setup_done()
    t0 = r.now()
    done, last, traced = 0, t0, 0
    while True:
        if r.trace and not r.tracer.running and r.now() - t0 >= trace_from:
            r.tracer.start()
        with record_function("portbench.step"):
            one_step()
        traced += r.tracer.running
        t = r.now()
        if t - t0 > r.seconds:
            break
        done, last = done + 1, t
    r.tracer.stop()
    r.records["forbidden"] = forbidden_modules()
    tokens_per_step = batch * seq
    if done:
        r.metrics["train_tokens_per_s"] = done * tokens_per_step / (last - t0)
    r.attempted, r.failed = done + 1, 0 if done else 1
    if device.type == "cuda":
        r.records["window_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        r.memory_peak_bytes = max(setup_peak, r.records["window_peak_bytes"])
    r.records.update(
        steps_traced=traced, tokens_per_step=tokens_per_step, seq=seq,
        attn_shape=dict(b=batch // tc["grad_accum"], h=ref.n_heads, kh=ref.n_kv_heads, t=seq,
                        d=ref.head_dim, window=cfg.attn_window, causal=True, in_bytes=2))

    r.log(f"window: {done} steps in {last - t0:.2f} s, {traced} traced")
    # The reference, once the program's state is freed.
    del state, step
    r.free()
    dense.strict_fp32()
    batches = []
    again = gen.generator(r.mix, r.extra).train_batches(r.mix, r.seed, ref.vocab)
    for _ in range(n_ref):
        tokens, targets = next(again)
        batches.append((torch.from_numpy(tokens).to(device), torch.from_numpy(targets).to(device)))
    ref_params = weights.draw(shapes, r.seed, ref.d_model, device, torch.float32)
    index = {name: i for i, name in enumerate(shapes)}
    out = dense.train(
        ref_params, batches, ref,
        dense.AdamW(lr=tc["lr"], b1=tc["b1"], b2=tc["b2"], weight_decay=tc["weight_decay"],
                    clip=tc["grad_clip"],
                    mu_dtype=getattr(torch, tc["mu_dtype"] or "float32")),
        block=ref_moe.moe_block if is_moe else dense.dense_block,
        initial=lambda name: weights.draw_leaf(name, shapes[name], index[name], r.seed,
                                               ref.d_model, device, torch.float32))
    del ref_params, batches
    r.free()
    r.log("reference done")
    grad = leaf_gaps(first, out["first_grad"])
    floor = 1e-3 * statistics.median(out["first_grad"].values())
    moved = leaf_gaps(change, out["change"], lambda k: out["first_grad"][k] >= floor)
    readings = {
        "loss_gap": max(abs(a - b) for a, b in zip(losses, out["losses"])),
        "loss_gap_step1": abs(losses[0] - out["losses"][0]),
        "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
        "change_gap": max(moved.values()),
        "change_gap_median": statistics.median(moved.values()),
    }
    r.log("losses " + " ".join(f"{a:.6f}/{b:.6f}" for a, b in zip(losses, out["losses"])))
    for label, per in (("grad", grad), ("change", moved)):
        worst = sorted(per.items(), key=lambda kv: -kv[1])
        r.log(f"{label} gap by leaf: " + " ".join(f"{k}={v:.3g}" for k, v in worst))
    # Numbers with a limit decide `correct`; the others are printed only.
    for name, value in readings.items():
        if name in r.cell["limits"]:
            r.check(name, value, r.cell["limits"][name])
        else:
            r.log(f"reading {name} {value!r} (not compared)")
    r.records["readings"] = dict(readings, losses=losses, ref_losses=out["losses"])


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else ""


def _planted(fault, step):
    """The program's step with a fault planted under it, for the tests
    that `correct` catches faults: ``unchanged`` returns the state as it
    was (the loss computed, nothing updated), ``half_batch`` leaves out half
    of the rows and takes the mean over the rest."""
    if fault is None:
        return step
    if fault == "half_batch":
        return lambda state, tok, tgt: step(state, tok[: tok.shape[0] // 2],
                                            tgt[: tgt.shape[0] // 2])
    if fault == "unchanged":
        import torch

        def frozen(state, tok, tgt):
            saved = {k: p.detach().clone() for k, p in state.params.items()}
            moments = {p: {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in state.opt.state[p].items()}
                       for p in state.params.values()}
            out = step(state, tok, tgt)
            with torch.no_grad():
                for k, p in state.params.items():
                    p.copy_(saved[k])
                for p, st in moments.items():
                    state.opt.state[p].update(st)
            return out

        return frozen
    raise ValueError(f"unknown fault {fault!r}")

