"""Training: AdamW with global-norm clipping, gradient accumulation,
checkpoints with resume, the draft head's distillation, the timed loop and
the CLI, on one device or on a training mesh.

The port of ``dstack_tpu/workloads/train.py``. One call of the step function
is one optimizer update, as the JAX package's jitted step; the port updates
the parameters and the optimizer's moments in place instead of returning new
ones. Parameters are fp32 masters (cfg.param_dtype) and the forward runs in
cfg.dtype (``model.forward`` casts each weight on use), so gradients reach
the masters through those casts as ``jax.grad`` does.

Under ``torchrun`` (one process per card) ``main`` builds the reference's
(dp, fsdp, tp, sp) mesh (``sharding.py``): every rank holds the local pieces
of the parameters and of the optimizer's moments, and reads the rows of its
data coordinate; the backward pass leaves each rank the gradient of its own
pieces, already summed over the data ranks (``kernels/collective.py``), so
clipping and AdamW run on the local pieces with the global norm. An MoE
preset (``moe.MOE_PRESETS``) takes the reference's MoE branch instead: the
(dp, fsdp, ep, tp, sp) mesh with the experts over ep (``_moe_main``).

Checkpoints are the JAX package's (``checkpoint.py``): ``state_tree`` lays
a state out as JAX's ``TrainState`` (or ``DraftTrainState``) flattens, with
optax's ``chain(clip_by_global_norm, adamw)`` state as ``opt_state``, so
either package resumes the other's run.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads import checkpoint as checkpoint_lib
from dstack_tpu_torch.workloads import data as data_lib
from dstack_tpu_torch.workloads import model as model_lib
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import telemetry as telemetry_lib
from dstack_tpu_torch.workloads.config import LlamaConfig
from dstack_tpu_torch.workloads.kernels import platform
from dstack_tpu_torch.workloads.sharding import DATA_AXES

Params = Dict[str, torch.Tensor]

# Dense bf16 tensor-core peak of one H100 SXM for MFU (NVIDIA H100 data
# sheet: 989 TFLOP/s without sparsity).
_H100_BF16_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(...)) as a recipe;
    ``build`` makes the AdamW over a parameter dict (torch's optimizer needs
    its tensors, optax's transformation does not). ``mu_dtype`` "bfloat16"
    or "float16" keeps the first moment in that type, as optax's
    ``mu_dtype``."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    mu_dtype: Optional[str] = None

    def build(self, params: Params) -> torch.optim.Optimizer:
        # optax.adamw decays every leaf, as one param group with weight_decay
        # does here: p -= lr * (adam_update + wd * p); eps is optax's default.
        # The moments exist from the start, as optax's ``init`` makes them, so
        # a fresh state is a checkpoint template and a restore target.
        if self.mu_dtype is not None:
            return AdamWLowMu(list(params.values()), lr=self.learning_rate,
                              betas=(self.b1, self.b2), eps=1e-8, weight_decay=self.weight_decay,
                              mu_dtype=model_lib.dtype_of(self.mu_dtype))
        opt = torch.optim.AdamW(list(params.values()), lr=self.learning_rate,
                                betas=(self.b1, self.b2), eps=1e-8,
                                weight_decay=self.weight_decay)
        for p in params.values():
            opt.state[p].update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                                exp_avg_sq=torch.zeros_like(p))
        return opt


class AdamWLowMu(torch.optim.Optimizer):
    """optax.adamw(mu_dtype=bfloat16 or float16): the first moment is stored
    in that type, the second moment and the parameters in their own dtype
    (fp32).

    Rounding follows the jitted optax update: ``mu = (1 - b1) * g + b1 *
    mu_low`` in fp32, with b1 rounded to the moment's type (JAX casts the
    Python float to the moment's dtype); the product is rounded to fp16 but
    not to bf16 (XLA drops the bf16 round trip inside the fused update;
    eager optax would round it); the update uses that fp32 mu, and mu is
    stored rounded to its type. Then, in fp32, ``p += -lr * (mu_hat /
    (sqrt(nu_hat) + eps) + wd * p)`` with the bias corrections ``1 -
    b**count`` computed in fp32. torch.optim.AdamW keeps mu in the
    parameter dtype, hence this class."""

    def __init__(self, params, lr: float, betas: Tuple[float, float], eps: float,
                 weight_decay: float, mu_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p].update(step=0, mu=torch.zeros_like(p, dtype=mu_dtype),
                                     nu=torch.zeros_like(p, dtype=torch.float32))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWLowMu.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            grads = [p.grad.float() for p in params]
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            b1, b2 = group["betas"]
            count = states[0]["step"] + 1
            for st in states:
                st["step"] = count
            b1_low = torch.tensor(b1, dtype=self.mu_dtype).item()
            mu = torch._foreach_mul(grads, 1.0 - b1)
            decayed = [m.float() for m in mus]
            torch._foreach_mul_(decayed, b1_low)
            if self.mu_dtype == torch.float16:
                # XLA keeps fp16's product rounded (it drops bf16's).
                decayed = [x.to(torch.float16).float() for x in decayed]
            torch._foreach_add_(mu, decayed)
            del decayed
            torch._foreach_mul_(nus, b2)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_add_(nus, sq)
            del sq
            for m_store, m in zip(mus, mu):
                m_store.copy_(m)
            f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
            bc1 = (1.0 - f32(b1) ** count).item()
            bc2 = (1.0 - f32(b2) ** count).item()
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(mu, bc1)
            torch._foreach_div_(mu, denom)
            torch._foreach_add_(mu, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(mu, -group["lr"])
            torch._foreach_add_(params, mu)
        return None


# The bf16 first moment's optimizer, by the name it had before fp16 joined.
AdamWBf16Mu = AdamWLowMu

# The floating first-moment dtypes optax takes; float64 is fp32 without x64.
_MU_DTYPES = ("float16", "bfloat16", "float32", "float64")


def make_optimizer(
    learning_rate: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    mu_dtype: Optional[str] = None,
) -> OptimizerConfig:
    """AdamW with global-norm clipping. ``mu_dtype="bfloat16"`` (or
    "float16") stores the first moment in that type (half its memory; the
    second moment and the master parameters stay fp32). "float64" is fp32,
    as in JAX without x64."""
    if mu_dtype not in (None,) + _MU_DTYPES:
        raise ValueError(f"mu_dtype={mu_dtype}: expected one of {_MU_DTYPES}")
    return OptimizerConfig(learning_rate, weight_decay, b1, b2, grad_clip,
                           None if mu_dtype in ("float32", "float64") else mu_dtype)


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: torch.optim.Optimizer
    step: int = 0


class MoeTrainState(TrainState):
    """The MoE branch's state (``moe.init_moe_train_state``). Its checkpoint
    layout is the reference's ``{"params": ..., "opt": ...}`` dict, which
    has no step leaf: the step is the optimizer's count."""


def init_train_state(
    cfg: LlamaConfig,
    optimizer: OptimizerConfig,
    device: Optional[torch.device] = None,
    params: Optional[Params] = None,
    mesh: Optional[sharding.Mesh] = None,
) -> TrainState:
    """Synthetic parameters from seed 0 on ``device`` (or the given
    ``params``, used as they are), made trainable, and their optimizer.
    Under ``mesh`` each rank keeps its local pieces of the meshless tree:
    every leaf is drawn on ``device`` one layer at a time from the same
    generator as meshless, and only the local piece is kept, so the device
    holds one layer's draw beyond the rank's pieces and the host nothing."""
    if params is None:
        device = torch.device(device)
        params = model_lib.init_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                                       mesh=mesh)
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=optimizer.build(params))


def local_batch(tokens: np.ndarray, targets: np.ndarray, mesh: Optional[sharding.Mesh],
                grad_accum: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """This rank's part of a global batch (numpy [B, T]): its rows over the
    mesh's data axes, microbatch by microbatch (``data.rank_rows``), and
    under sp its chunk of the sequence. Meshless: the batch as it is."""
    if mesh is None:
        return tokens, targets
    axes = sharding.data_axes(mesh)
    rows = data_lib.rank_rows(tokens.shape[0], grad_accum, mesh.index(axes),
                              mesh.axis_size(axes))
    cols = sharding.seq_chunk(tokens.shape[1], mesh)
    return tokens[rows][:, cols], targets[rows][:, cols]


def check_microbatch(batch: int, grad_accum: int, data_shards: int,
                     axes_label: str = "dp*fsdp") -> None:
    """A microbatch smaller than (or ragged over) the data-shard count
    silently reshards in a perf-tuned step: fail loudly. Meshless, as here,
    there is one data shard, as in the reference's meshless step."""
    if grad_accum > 1 and (batch // grad_accum) % data_shards != 0:
        raise ValueError(
            f"microbatch {batch}//{grad_accum} must be a multiple of the "
            f"{data_shards} data shards ({axes_label}); grow --batch or "
            f"shrink --grad-accum"
        )


def value_and_grad(loss_fn, params: Params, *args, **kwargs) -> Tuple[torch.Tensor, Params]:
    """(loss, {name: d loss / d param}) of ``loss_fn(params, *args, **kwargs)``."""
    loss = loss_fn(params, *args, **kwargs)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def accumulate_grads(loss_fn, params: Params, tokens, targets, grad_accum: int,
                     **loss_kwargs) -> Tuple[torch.Tensor, Params]:
    """(mean loss, mean grads) over ``grad_accum`` microbatches: the batch
    splits row-major into [A, B/A, T]; each microbatch's grads add into fp32
    accumulators, and the mean comes back in each param's dtype. Peak
    activation memory is one microbatch's."""
    b = tokens.shape[0]
    if b % grad_accum != 0:
        raise ValueError(f"batch {b} not divisible by grad_accum={grad_accum}")
    mb = b // grad_accum
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(grad_accum):
        rows = slice(i * mb, (i + 1) * mb)
        loss, grads = value_and_grad(loss_fn, params, tokens[rows], targets[rows], **loss_kwargs)
        for k, g in grads.items():
            acc[k] += g.float()
        loss_sum = loss_sum + loss
    grads = {k: (acc[k] / grad_accum).to(p.dtype) for k, p in params.items()}
    return loss_sum / grad_accum, grads


def global_norm(grads: Iterable[torch.Tensor], mesh: Optional[sharding.Mesh] = None,
                specs=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (optax.global_norm). Each
    leaf's sum of squares is a BLAS dot of the leaf with itself: no
    temporary of the leaf's size, and on the CPU a blocked sum, where
    ``torch.linalg.vector_norm`` accumulates serially and lands 1e-5 off
    for a leaf of 10^6 entries. Under ``mesh`` the leaves are this rank's
    pieces, laid out by ``specs``: each leaf's sums are added over the
    ranks, a piece that several ranks hold counted on the first of them
    only, so every element of the global gradient counts once."""
    sq = [torch.dot(v, v) for v in (g.float().flatten() for g in grads)]
    if mesh is not None:
        sq = torch.stack([s if sharding.holds_first_copy(spec, mesh) else torch.zeros_like(s)
                          for s, spec in zip(sq, specs)])
        dist.all_reduce(sq, group=mesh.group(mesh.axes))
        sq = list(sq)
    return torch.sqrt(sum(sq))


def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: each g stays as it is when norm <
    max_norm, else becomes (g / norm) * max_norm. No host sync."""
    keep = norm < max_norm
    div = torch.where(keep, 1.0, norm)
    mul = torch.where(keep, 1.0, max_norm)
    for g in grads:
        g.div_(div).mul_(mul)


def make_train_step(cfg: LlamaConfig, optimizer: OptimizerConfig,
                    mesh: Optional[sharding.Mesh] = None, grad_accum: int = 1,
                    loss: Callable = model_lib.loss_fn):
    """Returns (state, tokens, targets) -> (state, metrics): one optimizer
    update of ``loss`` (the dense model's; the MoE step passes its own),
    over ``grad_accum`` microbatches. metrics holds 0-dim tensors
    (``loss``, the unclipped ``grad_norm``) and the new ``step``. Under
    ``mesh`` the state holds this rank's pieces and tokens/targets its rows
    (``data.rank_rows``: microbatch by microbatch, over the mesh's data
    axes); the loss and the norm are the global batch's."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    axes = sharding.data_axes(mesh)
    data_shards = mesh.axis_size(axes) if mesh is not None else 1

    def step(state: TrainState, tokens: torch.Tensor, targets: torch.Tensor):
        check_microbatch(tokens.shape[0] * data_shards, grad_accum, data_shards,
                         axes_label="*".join(axes))
        if grad_accum == 1:
            value, grads = value_and_grad(loss, state.params, tokens, targets, cfg=cfg,
                                          mesh=mesh)
        else:
            value, grads = accumulate_grads(loss, state.params, tokens, targets, grad_accum,
                                            cfg=cfg, mesh=mesh)
        grad_norm = _apply_update(state.opt, state.params, grads, optimizer.grad_clip, mesh)
        state.step += 1
        return state, {"loss": value, "grad_norm": grad_norm, "step": state.step}

    return step


def _apply_update(opt: torch.optim.Optimizer, trained: Params, grads: Params,
                  grad_clip: float, mesh: Optional[sharding.Mesh] = None) -> torch.Tensor:
    """clip_by_global_norm then the AdamW update of ``trained`` in place;
    returns the unclipped global norm."""
    specs = [sharding.param_specs(mesh)[k] for k in grads] if mesh is not None else None
    grad_norm = global_norm(grads.values(), mesh, specs)
    clip_by_global_norm_(grads.values(), grad_clip, grad_norm)
    for name, p in trained.items():
        p.grad = grads[name]
    opt.step()
    opt.zero_grad(set_to_none=True)
    return grad_norm


@dataclasses.dataclass
class DraftTrainState:
    """Distillation state for the draft head (--draft-head): the frozen
    target rides along as ``params``, so one checkpoint serves both
    ``serve.load_serve_params`` (``.params``) and ``serve.load_draft_params``
    (``.draft``). Only ``draft`` trains; ``opt`` covers it alone."""

    params: Params
    draft: Params
    opt: torch.optim.Optimizer
    step: int = 0


def make_draft_distill_step(cfg: LlamaConfig, optimizer: OptimizerConfig, rollout: int = 2,
                            mesh: Optional[sharding.Mesh] = None):
    """Returns (state: DraftTrainState, tokens) -> (state, loss): one
    distillation update. The frozen target's forward gives the hidden states
    and argmax labels (model.draft_distill_loss); gradients reach
    ``state.draft`` only. The target tree is shared, never copied. Under
    ``mesh`` the target is this rank's pieces, ``tokens`` its rows, and the
    draft whole on every rank: its gradients are those of the global mean
    loss (summed over the data axes), so every rank takes the same update."""

    def step(state: DraftTrainState, tokens: torch.Tensor):
        loss, grads = value_and_grad(
            lambda draft: model_lib.draft_distill_loss(draft, state.params, tokens, cfg,
                                                       rollout=rollout, mesh=mesh),
            state.draft,
        )
        _apply_update(state.opt, state.draft, grads, optimizer.grad_clip)
        state.step += 1
        return state, loss

    return step


# -- the checkpoint layout ---------------------------------------------------
# optax.chain(clip_by_global_norm, adamw) keeps its state as
# (EmptyState(), (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())):
# the clip, the decoupled decay and the learning-rate scale hold no leaves.
# These named tuples give checkpoint.leaf_entries the same key paths.


class EmptyState(NamedTuple):
    """optax's EmptyState: no leaves."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: Params
    nu: Params


class TrainStateTree(NamedTuple):
    params: Params
    opt_state: tuple
    step: torch.Tensor  # 0-d int32


class DraftStateTree(NamedTuple):
    params: Params
    draft: Params
    opt_state: tuple
    step: torch.Tensor  # 0-d int32


def _moment_keys(opt: torch.optim.Optimizer) -> Tuple[str, str]:
    return ("mu", "nu") if isinstance(opt, AdamWLowMu) else ("exp_avg", "exp_avg_sq")


def _trained(state) -> Params:
    return state.draft if isinstance(state, DraftTrainState) else state.params


def state_tree(state):
    """``state`` laid out as JAX's TrainState (or DraftTrainState) flattens:
    ``.params[...]`` (``.draft[...]``), ``.opt_state[1][0].count`` /
    ``.mu[...]`` / ``.nu[...]`` and ``.step``; an ``MoeTrainState`` as the
    reference's MoE branch saves its dict: ``['opt'][1][0].count`` / ...
    and ``['params'][...]``. The tensors are the state's own (no copy); the
    step counts are new 0-d int32 tensors. The optimizer keeps a step count
    per parameter; all must agree."""
    trained = _trained(state)
    mu_key, nu_key = _moment_keys(state.opt)
    counts = {int(state.opt.state[p]["step"]) for p in trained.values()}
    if len(counts) != 1:
        raise ValueError(f"the optimizer's per-parameter step counts disagree: {sorted(counts)}")
    adam = ScaleByAdamState(
        count=torch.tensor(counts.pop(), dtype=torch.int32),
        mu={k: state.opt.state[p][mu_key] for k, p in trained.items()},
        nu={k: state.opt.state[p][nu_key] for k, p in trained.items()},
    )
    opt_state = (EmptyState(), (adam, EmptyState(), EmptyState()))
    if isinstance(state, MoeTrainState):
        return {"params": state.params, "opt": opt_state}
    step = torch.tensor(state.step, dtype=torch.int32)
    if isinstance(state, DraftTrainState):
        return DraftStateTree(state.params, state.draft, opt_state, step)
    return TrainStateTree(state.params, opt_state, step)


@torch.no_grad()
def load_state_tree(state, tree) -> None:
    """Copy a restored ``state_tree`` layout into ``state`` in place: the
    parameters, the moments, every parameter's optimizer step count (a
    float tensor for torch's AdamW, whose bias correction reads it) and the
    step (an MoE state's is the count)."""
    if isinstance(state, MoeTrainState):
        tree = TrainStateTree(tree["params"], tree["opt"], None)
    for name in ("params", "draft") if isinstance(state, DraftTrainState) else ("params",):
        for k, t in getattr(state, name).items():
            t.copy_(getattr(tree, name)[k])
    adam = tree.opt_state[1][0]
    count = int(adam.count)
    mu_key, nu_key = _moment_keys(state.opt)
    for k, p in _trained(state).items():
        st = state.opt.state[p]
        st[mu_key].copy_(adam.mu[k])
        st[nu_key].copy_(adam.nu[k])
        st["step"] = count if isinstance(state.opt, AdamWLowMu) else torch.tensor(float(count))
    state.step = count if tree.step is None else int(tree.step)


def _step_time_stats(times) -> Dict[str, float]:
    """p50/p90/mean seconds from a list of per-step wall times."""
    if not times:
        return {}
    s = sorted(times)
    pick = lambda q: s[min(len(s) - 1, int(q * len(s)))]  # noqa: E731
    return {
        "p50_s": pick(0.50),
        "p90_s": pick(0.90),
        "mean_s": sum(s) / len(s),
    }


def _device_peak_flops(device: torch.device) -> float:
    """Dense bf16 peak of the card for MFU: ``_H100_BF16_FLOPS`` on an H100;
    0 for the CPU or any other card, and then no MFU is reported."""
    if device.type != "cuda":
        return 0.0
    return _H100_BF16_FLOPS if "h100" in torch.cuda.get_device_name(device).lower() else 0.0


def make_collective_fence(mesh: Optional[sharding.Mesh]):
    """A timed one-element all-reduce over the whole mesh, for per-step
    collective-wait attribution (the gang-health signal). Run right after a
    step has synchronized, it measures how long this rank waits for the
    rest: the bare collective latency on a healthy gang, stretched by the
    lag on every rank but a straggler. None without a mesh or on one rank.
    Its first all-reduce runs here, outside the timed loop."""
    if mesh is None or mesh.size <= 1:
        return None
    x = torch.ones(1, device=mesh.device)
    group = mesh.group(mesh.axes)

    def fence() -> float:
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return time.perf_counter() - t0

    fence()
    return fence


def _timed_loop(steps: int, batch: int, seq: int, do_step,
                flops_per_step: float = 0.0, telemetry=None,
                step_extras=None, start_step: int = 0, on_step=None,
                device: Optional[torch.device] = None, fence=None,
                devices: int = 1) -> Dict[str, float]:
    """Shared throughput loop: ``do_step()`` advances the state and returns
    the loss as a 0-dim tensor; reading it as a float waits for the device
    each step, as the reference blocks on each step.

    The first call (kernel builds, library set-up, first step) is reported
    as ``compile_s``, apart from the steady state, whose p50/p90 step times
    give tokens/s and, on a card with a known peak, MFU. Every step lands on
    the telemetry channel with the reference's keys: compile_start /
    compile_end marks around the first call, then one ``step`` point per
    iteration, then run_end. ``start_step`` resumes the numbering after a
    checkpoint restore: the loop runs ``steps - start_step`` steps numbered
    ``start_step + 1 .. steps``. ``on_step(step, loss)`` fires after every
    step; its exceptions propagate (an injected crash must end the run).
    ``fence`` (make_collective_fence) runs after each step and its wall time
    lands on the step point as ``collective_wait_s``; MFU counts the peak
    of ``devices`` cards."""
    if telemetry is None:
        telemetry = telemetry_lib.get_emitter()
    if steps - start_step <= 0:
        print(f"training done (0 steps remaining of {steps})", flush=True)
        return {}
    device = torch.device("cpu") if device is None else torch.device(device)
    peak_flops = _device_peak_flops(device) * devices if flops_per_step else 0.0

    telemetry.mark("compile_start", steps=steps, batch=batch, seq=seq)
    t0 = time.perf_counter()
    loss = float(do_step())
    compile_s = time.perf_counter() - t0
    telemetry.mark("compile_end", compile_s=compile_s)
    print(f"step {start_step + 1}/{steps} loss={loss:.4f} compile+first-step {compile_s:.2f}s",
          flush=True)
    if on_step is not None:
        on_step(start_step + 1, loss)

    times = []
    for i in range(start_step + 1, steps):
        t0 = time.perf_counter()
        loss = float(do_step())
        dt = time.perf_counter() - t0
        times.append(dt)
        point = {
            "loss": round(loss, 6),
            "tokens_per_sec": round(batch * seq / max(dt, 1e-9), 2),
        }
        if flops_per_step:
            fps = flops_per_step / max(dt, 1e-9)
            point["tf_per_sec"] = round(fps / 1e12, 3)
            if peak_flops:
                point["mfu"] = round(fps / peak_flops, 5)
        if step_extras is not None:
            try:
                point.update(step_extras())
            except Exception:
                pass  # extras are advisory; never let them kill the loop
        if fence is not None:
            point["collective_wait_s"] = round(fence(), 6)
        telemetry.step(i + 1, round(dt, 6), **point)
        if on_step is not None:
            on_step(i + 1, loss)
        if (i + 1) % 10 == 0 or i == steps - 1:
            window = times[-10:]
            dt = sum(window) / len(window)
            tf = (f" {flops_per_step / max(dt, 1e-9) / 1e12:.1f} TF/s"
                  if flops_per_step else "")
            print(f"step {i + 1}/{steps} loss={loss:.4f} "
                  f"{batch * seq / max(dt, 1e-9):,.0f} tok/s{tf}", flush=True)

    stats = _step_time_stats(times)
    stats["compile_s"] = compile_s
    if times:
        p50 = stats["p50_s"]
        stats["tokens_per_sec"] = batch * seq / max(p50, 1e-9)
        summary = (f"done: {steps - start_step} steps, compile {compile_s:.2f}s, "
                   f"step p50 {p50 * 1000:.1f}ms p90 {stats['p90_s'] * 1000:.1f}ms, "
                   f"{stats['tokens_per_sec']:,.0f} tok/s")
        if flops_per_step:
            stats["tf_per_sec"] = flops_per_step / max(p50, 1e-9) / 1e12
            summary += f" {stats['tf_per_sec']:.1f} TF/s"
            if peak_flops:
                stats["mfu"] = flops_per_step / max(p50, 1e-9) / peak_flops
                summary += f" MFU {stats['mfu']:.4f}"
        print(summary, flush=True)
    else:
        print("training done", flush=True)
    telemetry.mark(
        "run_end",
        steps=steps,
        compile_s=round(compile_s, 4),
        tokens_per_sec=round(stats.get("tokens_per_sec", 0.0), 2),
        **{k: v for k, v in telemetry.stats().items() if k != "buffered"},
    )
    telemetry.flush()
    return stats


def make_checkpoint_manager(args, telemetry, mesh: Optional[sharding.Mesh] = None,
                            whole_keys: Tuple[str, ...] = ()):
    """--checkpoint-dir -> a CheckpointManager (None when checkpointing is
    off); under ``mesh`` one a rank, writing its own pieces (the leaves
    under ``whole_keys`` are whole on every rank)."""
    if not getattr(args, "checkpoint_dir", ""):
        return None
    return checkpoint_lib.CheckpointManager(args.checkpoint_dir, telemetry=telemetry, mesh=mesh,
                                            whole_keys=whole_keys)


def maybe_resume(manager, resume: bool, state, telemetry):
    """Restore the latest complete checkpoint into ``state`` (in place) when
    --resume is set. Returns (state, start_step). A fresh directory under
    --resume starts at step 0 (the first attempt of a retried gang passes
    the same flags)."""
    if manager is None or not resume:
        return state, 0
    step = manager.latest_step()
    if step is None:
        print("resume: no complete checkpoint found; starting fresh", flush=True)
        return state, 0
    tree, manifest = manager.restore(state_tree(state), step)
    load_state_tree(state, tree)
    del tree
    start_step = int(manifest["step"])
    telemetry.mark("restart", step=start_step, resumed=True, from_mesh=manifest.get("mesh"))
    print(f"resumed from checkpoint step {start_step} (saved on mesh {manifest.get('mesh')})",
          flush=True)
    return state, start_step


def make_checkpoint_hook(manager, every: int, total_steps: int, get_state,
                         mesh_shape=None, resumed: bool = False):
    """The _timed_loop on_step hook: save every N steps (the final state is
    saved by the entry point after the loop, so the last step is not written
    twice). DSTACK_TPU_TRAIN_CRASH_AT_STEP injects a preemption for the
    control plane's smoke and bench runs, on the first attempt only (a
    resumed run sails past the crash step it already survived).
    ``get_state`` returns the checkpoint layout (``state_tree``)."""
    crash_at = int(os.environ.get("DSTACK_TPU_TRAIN_CRASH_AT_STEP", "0") or 0)

    def on_step(step: int, loss) -> None:
        if manager is not None and every > 0 and step % every == 0 and step < total_steps:
            manager.save(step, get_state(), data_offset=step, mesh_shape=mesh_shape)
        if crash_at and not resumed and step >= crash_at:
            print(f"injected preemption: exiting at step {step}", flush=True)
            raise SystemExit(1)

    return on_step


def _chain(*hooks):
    """One on_step hook that calls each given hook in turn."""
    hooks = [h for h in hooks if h is not None]

    def on_step(step: int, loss) -> None:
        for hook in hooks:
            hook(step, loss)

    return on_step


def apply_perf_overrides(cfg: LlamaConfig, args) -> LlamaConfig:
    """--attn-impl / --quant / --attn-window / --tp-overlap / --fsdp-overlap
    -> config fields (empty flag = keep the config default)."""
    reps = {}
    if args.attn_impl:
        reps["attn_impl"] = args.attn_impl
    if args.quant:
        reps["quant"] = args.quant
    if args.attn_window:
        reps["attn_window"] = args.attn_window
    if getattr(args, "tp_overlap", False):
        reps["tp_overlap"] = True
    if getattr(args, "fsdp_overlap", False):
        reps["fsdp_overlap"] = True
    return dataclasses.replace(cfg, **reps) if reps else cfg


def train(
    cfg: LlamaConfig,
    *,
    steps: int,
    batch: int,
    seq: int,
    device: torch.device,
    grad_accum: int = 1,
    prefetch: int = 2,
    data_path: Optional[str] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
    telemetry=None,
    mu_dtype: Optional[str] = None,
    ckpt: Optional[checkpoint_lib.CheckpointManager] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    mesh: Optional[sharding.Mesh] = None,
) -> Dict[str, float]:
    """Train ``cfg`` for ``steps`` updates on ``device`` from synthetic
    parameters and the input pipeline; returns the timed loop's stats.
    Under a connected ``mesh`` this process is one rank of it: its pieces of
    the state, its rows of each global ``batch``, its checkpoint shard. An
    ``moe.MoeConfig`` trains the MoE decoder (on an MoE mesh, if any), with
    no FLOP count (the reference reports no MFU for MoE).

    With ``ckpt``: ``resume`` restores the latest complete checkpoint and
    the feed seeks past the batches it consumed; a save every
    ``checkpoint_every`` steps, and the final state once more (blocking)
    when ``checkpoint_every`` is set. ``on_step(step, loss)`` runs before the
    checkpoint hook. The manager is closed (its last write drained) on the
    way out, an injected crash included."""
    from dstack_tpu_torch.workloads import moe as moe_lib

    if telemetry is None:
        telemetry = telemetry_lib.get_emitter()
    try:
        optimizer = make_optimizer(mu_dtype=mu_dtype)
        is_moe = isinstance(cfg, moe_lib.MoeConfig)
        if is_moe:
            state = moe_lib.init_moe_train_state(cfg, optimizer, device, mesh=mesh)
        else:
            state = init_train_state(cfg, optimizer, device, mesh=mesh)
        state, start_step = maybe_resume(ckpt, resume, state, telemetry)
        step_fn = (moe_lib.make_moe_train_step if is_moe else make_train_step)(
            cfg, optimizer, mesh, grad_accum=grad_accum)
        axes = sharding.data_axes(mesh)
        shards = {} if mesh is None else dict(
            data_index=mesh.index(axes), data_shards=mesh.axis_size(axes),
            grad_accum=grad_accum, columns=sharding.seq_chunk(seq, mesh))
        feed = data_lib.input_pipeline(
            batch, seq, cfg.vocab_size, data_path=data_path, prefetch=prefetch, device=device,
            start_batch=start_step, **shards,
        )
        mesh_shape = dict(mesh.shape) if mesh is not None else None
        flops_per_step = 0.0 if is_moe else cfg.flops_per_token(seq) * batch * seq
        box = {"state": state}
        feed_wait = {"s": 0.0}

        def do_step():
            t0 = time.perf_counter()
            tokens, targets = next(feed)
            feed_wait["s"] = time.perf_counter() - t0
            box["state"], metrics = step_fn(box["state"], tokens, targets)
            return metrics["loss"]

        hook = make_checkpoint_hook(ckpt, checkpoint_every, steps,
                                    lambda: state_tree(box["state"]), mesh_shape=mesh_shape,
                                    resumed=start_step > 0)
        try:
            stats = _timed_loop(steps, batch, seq, do_step, flops_per_step,
                                telemetry=telemetry,
                                step_extras=lambda: {"input_wait_s": round(feed_wait["s"], 6)},
                                start_step=start_step, on_step=_chain(on_step, hook),
                                device=device, fence=make_collective_fence(mesh),
                                devices=mesh.size if mesh is not None else 1)
            if ckpt is not None and checkpoint_every:
                # The final state: a completed run's last step restores too.
                ckpt.save(steps, state_tree(box["state"]), data_offset=steps,
                          mesh_shape=mesh_shape, block=True)
            return stats
        finally:
            feed.close()
    finally:
        if ckpt is not None:
            ckpt.close()


def _restore_target(ckpt, step: int, cfg: LlamaConfig, device: torch.device,
                    mesh: Optional[sharding.Mesh] = None) -> Tuple[Params, dict]:
    """The ``.params`` subtree of checkpoint ``step`` at cfg's shapes and
    param dtype on ``device``: a TrainState and a DraftTrainState both
    hold it, and so does a params-only tree. Under ``mesh``: this rank's
    pieces."""
    dtype = model_lib.dtype_of(cfg.param_dtype)
    specs = sharding.param_specs(mesh)

    def local(name, shape):
        if mesh is None:
            return shape
        return tuple(s.stop - s.start for s in sharding.local_slices(specs[name], shape, mesh))

    template = {k: checkpoint_lib.LeafSpec(local(k, shape), dtype, device)
                for k, shape in model_lib.param_shapes(cfg).items()}
    return ckpt.restore_subtree(template, step=step, prefix=".params")


def distill(
    cfg: LlamaConfig,
    *,
    steps: int,
    batch: int,
    seq: int,
    device: torch.device,
    prefetch: int = 2,
    data_path: Optional[str] = None,
    on_step: Optional[Callable[[int, float], None]] = None,
    telemetry=None,
    mu_dtype: Optional[str] = None,
    ckpt: Optional[checkpoint_lib.CheckpointManager] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    draft_layers: int = 2,
    draft_ff: int = 0,
    draft_lr: float = 1e-3,
    rollout: int = 2,
    mesh: Optional[sharding.Mesh] = None,
) -> Dict[str, float]:
    """Distill the draft head against the frozen target (--draft-head).
    Under a connected ``mesh`` this process is one rank of the training
    mesh: the target's pieces (restored as this rank's regions of a mesh or
    a meshless checkpoint), its rows of each batch, and the whole draft head
    and its optimizer state, which every rank updates alike; a checkpoint
    keeps JAX's layout (``.params`` cut by the mesh, ``.draft`` whole).

    The target is the latest checkpoint's ``.params`` in ``ckpt`` when there
    is one (a TrainState or an earlier DraftTrainState), else the synthetic
    init. The saved state is a DraftTrainState whose step numbers continue
    past the target's, so ``latest_step`` lands on it and serve can point
    --checkpoint-dir and --spec-model at the same directory; with
    ``resume``, a latest step that holds ``.draft`` resumes in place. The
    final state is saved (blocking) whenever there is a manager."""
    if telemetry is None:
        telemetry = telemetry_lib.get_emitter()
    optimizer = make_optimizer(learning_rate=draft_lr, mu_dtype=mu_dtype)
    feed = None
    try:
        base_step = 0
        latest = ckpt.latest_step() if ckpt is not None else None
        resume_full = latest is not None and resume and any(
            leaf["key"].startswith(".draft") for leaf in ckpt.read_manifest(latest)["leaves"]
        )
        if latest is not None and not resume_full:
            target, manifest = _restore_target(ckpt, latest, cfg, device, mesh)
            base_step = int(manifest["step"])
            print(f"draft-head: frozen target from checkpoint step {base_step}", flush=True)
        else:
            target = model_lib.init_params(
                cfg, torch.Generator(device=device).manual_seed(0), device, mesh=mesh)
        draft = model_lib.init_draft_params(
            cfg, torch.Generator(device=device).manual_seed(1), device,
            n_layers=draft_layers, d_ff=draft_ff,
        )
        for p in draft.values():
            p.requires_grad_(True)
        state = DraftTrainState(target, draft, optimizer.build(draft))
        start_step = 0
        if resume_full:
            tree, manifest = ckpt.restore(state_tree(state), latest)
            load_state_tree(state, tree)
            del tree
            start_step = state.step
            base_step = int(manifest["step"]) - start_step
            print(f"resumed draft head at draft step {start_step}"
                  f" (checkpoint step {manifest['step']})", flush=True)
        step_fn = make_draft_distill_step(cfg, optimizer, rollout=rollout, mesh=mesh)
        shards = {} if mesh is None else dict(data_index=mesh.index(DATA_AXES),
                                              data_shards=mesh.axis_size(DATA_AXES))
        feed = data_lib.input_pipeline(
            batch, seq, cfg.vocab_size, data_path=data_path, prefetch=prefetch,
            device=device, start_batch=start_step, **shards,
        )
        mesh_shape = dict(mesh.shape) if mesh is not None else None
        box = {"state": state}
        feed_wait = {"s": 0.0}

        def do_step():
            t0 = time.perf_counter()
            tokens, _ = next(feed)  # the teacher labels itself; targets unused
            feed_wait["s"] = time.perf_counter() - t0
            box["state"], loss = step_fn(box["state"], tokens)
            return loss

        def save_every(step: int, loss) -> None:
            if ckpt is not None and checkpoint_every and step % checkpoint_every == 0 \
                    and step < steps:
                ckpt.save(base_step + step, state_tree(box["state"]), data_offset=step,
                          mesh_shape=mesh_shape)

        stats = _timed_loop(steps, batch, seq, do_step, telemetry=telemetry,
                            step_extras=lambda: {"input_wait_s": round(feed_wait["s"], 6)},
                            start_step=start_step, on_step=_chain(on_step, save_every),
                            device=device, fence=make_collective_fence(mesh),
                            devices=mesh.size if mesh is not None else 1)
        if ckpt is not None:
            ckpt.save(base_step + steps, state_tree(box["state"]), data_offset=steps,
                      mesh_shape=mesh_shape, block=True)
            print(f"draft head saved at checkpoint step {base_step + steps} (.draft subtree)",
                  flush=True)
        return stats
    finally:
        if feed is not None:
            feed.close()
        if ckpt is not None:
            ckpt.close()


def autotune_attention(cfg: LlamaConfig, seq: int, device: torch.device,
                       mesh: Optional[sharding.Mesh] = None) -> Optional[Dict]:
    """--autotune: sweep the flash or splash kernels' tile pairs before the
    first step and persist the winner, which the kernels then read for this
    card, head dim and length. JAX probes with a (1, seq, 1, head_dim) fp32
    normal; on the card fp32 runs the CUDA-core kernels, which take no tile,
    so the probe here is the step's own: the config's activation dtype, its
    query and KV heads, batch 1, from a seeded generator, under its window.
    On a mesh rank 0 tunes and writes the cache and broadcasts the pair, so
    every rank runs the same tiles. Prints JAX's line; None when the
    attention core has no tiles."""
    from dstack_tpu_torch.workloads.kernels import autotune

    if cfg.attn_impl not in ("flash", "splash"):
        return None
    report = None
    if mesh is None or mesh.rank == 0:
        gen = torch.Generator(device=device).manual_seed(0)
        adt = model_lib.dtype_of(cfg.dtype)
        q = torch.randn((1, seq, cfg.n_heads, cfg.head_dim), generator=gen, device=device)
        kv = torch.randn((2, 1, seq, cfg.n_kv_heads, cfg.head_dim), generator=gen, device=device)
        report = autotune.tune(cfg.attn_impl, q.to(adt), kv[0].to(adt), kv[1].to(adt),
                               causal=True, window=cfg.attn_window)
        del q, kv
    if mesh is not None:
        from dstack_tpu_torch.workloads.kernels import collective

        pair = torch.tensor(report["blocks"] if report else (0, 0), dtype=torch.int64,
                            device=device)
        collective.broadcast(pair, 0, None)
        if report is None:
            report = {"kernel": cfg.attn_impl, "gen": autotune.generation_of(device),
                      "head_dim": cfg.head_dim, "seq": seq,
                      "blocks": tuple(int(b) for b in pair.tolist()), "sweep": {}}
            autotune.remember(cfg.attn_impl, cfg.head_dim, seq, report["blocks"],
                              gen=report["gen"])
    print(f"autotune: {report['kernel']} gen={report['gen']} head_dim={report['head_dim']}"
          f" seq={report['seq']} -> blocks={report['blocks']}", flush=True)
    return report


def build_mesh(args, device: torch.device) -> Tuple[sharding.Mesh, Optional[sharding.Mesh]]:
    """The reference's training mesh for this command line: (its layout,
    the connected mesh or None). Under torchrun (``WORLD_SIZE`` set) this
    process joins the group (NCCL on a card, gloo on the CPU) and the mesh
    spans its ranks, fsdp absorbing what --tp leaves; with --multislice and
    MEGASCALE_NUM_SLICES > 1, dp leads over the slices. A lone process is
    the reference's one-device mesh: its layout is checked, and the step
    runs meshless."""
    rank_device = sharding.init_distributed(device)
    world = dist.get_world_size() if rank_device is not None else 1
    num_slices = int(os.environ.get("MEGASCALE_NUM_SLICES", "1"))
    if args.multislice and num_slices > 1 and rank_device is not None:
        layout = sharding.make_multislice_mesh(num_slices, sharding.gather_slice_ids(),
                                               tp=args.tp)
    else:
        layout = sharding.make_mesh(tp=args.tp, world=world)
    if args.tp_overlap and layout.shape["tp"] <= 1:
        raise ValueError(
            "--tp-overlap needs a tensor-parallel mesh axis (pass --tp > 1);"
            " with tp=1 there is no all-reduce to hide and the ring is a"
            " silent no-op"
        )
    return layout, (layout.connect(rank_device) if rank_device is not None else None)


def _moe_main(args, device: torch.device) -> Dict[str, float]:
    """The reference's MoE branch (its ``_moe_main``): experts over ep, the
    rest of the ranks on dp. ``--ep`` defaults to the largest axis that
    divides both the rank count and the expert count (their gcd). A lone
    process is the reference's one-device mesh: validated, run meshless."""
    import math

    from dstack_tpu_torch.workloads.config import validate_config
    from dstack_tpu_torch.workloads.moe import MOE_PRESETS

    if args.multislice:
        raise SystemExit("--multislice is not supported for MoE configs yet")
    if args.tp > 1 or args.tp_overlap:
        raise SystemExit(
            "--tp/--tp-overlap are not supported for MoE configs (the mesh "
            "is dp×ep; expert matmuls have no tp-sharded contraction to "
            "overlap) — drop the flags or pick a dense config"
        )
    cfg = MOE_PRESETS[args.config]
    if args.remat_policy:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=args.remat_policy)
    cfg = apply_perf_overrides(cfg, args)
    model_lib.remat_policy_of(cfg)  # an unknown policy raises before the first step
    rank_device = sharding.init_distributed(device)
    n = dist.get_world_size() if rank_device is not None else 1
    ep = args.ep or math.gcd(n, cfg.n_experts)
    if n % ep != 0:
        raise SystemExit(f"{n} devices not divisible by ep={ep}")
    if cfg.n_experts % ep != 0:
        raise SystemExit(
            f"n_experts={cfg.n_experts} not divisible by ep={ep};"
            f" pick --ep from the divisors of both"
        )
    layout = sharding.make_moe_mesh(dp=n // ep, fsdp=1, ep=ep, tp=1, sp=1, world=n)
    mesh = layout.connect(rank_device) if rank_device is not None else None
    device = rank_device or device
    data_shards = layout.axis_size(sharding.MOE_DATA_AXES)
    # 2 rows per data shard per microbatch by default.
    batch = args.batch or 2 * data_shards * args.grad_accum
    seq = args.seq or cfg.max_seq_len
    validate_config(cfg, seq=seq, device=device, mesh=layout,
                    batch=batch // max(args.grad_accum, 1))
    print(f"config={args.config} device={device} devices={n} mesh={layout.shape}"
          f" experts={cfg.n_experts} top_k={cfg.top_k} batch={batch} seq={seq}"
          f" grad_accum={args.grad_accum} prefetch={args.prefetch}"
          f" attn_impl={cfg.attn_impl} quant={cfg.quant}"
          f" remat={cfg.remat_policy if cfg.remat else 'off'}"
          f" params={cfg.num_params() / 1e9:.3f}B active={cfg.active_params() / 1e9:.3f}B",
          flush=True)
    telemetry = telemetry_lib.get_emitter()
    telemetry.set_identity(proc=dist.get_rank() if mesh is not None else 0)
    telemetry.mark("run_start", workload="train", config=args.config, devices=n,
                   batch=batch, seq=seq)
    try:
        return train(cfg, steps=args.steps, batch=batch, seq=seq, device=device,
                     grad_accum=args.grad_accum, prefetch=args.prefetch,
                     data_path=args.data or None, telemetry=telemetry,
                     mu_dtype=args.mu_dtype or None,
                     ckpt=make_checkpoint_manager(args, telemetry, mesh),
                     checkpoint_every=args.checkpoint_every, resume=args.resume, mesh=mesh)
    finally:
        telemetry.close()


def main(argv=None) -> Dict[str, float]:
    """``python -m dstack_tpu_torch.workloads.train``: the runnable training
    entry point, on the CUDA card unless ``--device cpu``; launched by
    ``torchrun`` (one process per card) it trains on the (dp, fsdp, tp, sp)
    mesh, or for an MoE preset on the (dp, fsdp, ep, tp, sp) mesh. Synthetic
    data by default (``--data tokens.bin`` feeds a packed corpus); prints
    per-step throughput and, for a dense model on a known card, MFU."""
    import argparse

    from dstack_tpu_torch.workloads.config import ATTN_IMPLS, PRESETS
    from dstack_tpu_torch.workloads.moe import MOE_PRESETS

    parser = argparse.ArgumentParser(prog="dstack_tpu_torch.workloads.train")
    parser.add_argument("--config", default="test",
                        choices=sorted(PRESETS) + sorted(MOE_PRESETS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=0,
                        help="global batch (0 = 2 per data shard per microbatch)")
    parser.add_argument("--seq", type=int, default=0, help="sequence length (0 = config max)")
    parser.add_argument("--multislice", action="store_true",
                        help="leading dp axis over the MEGASCALE slice count")
    parser.add_argument("--ep", type=int, default=0,
                        help="expert-parallel axis size for MoE configs"
                             " (0 = largest ep dividing both the rank count"
                             " and n_experts, i.e. their gcd)")
    parser.add_argument("--grad-accum", type=int, default=1, dest="grad_accum",
                        help="microbatches per optimizer update (fp32 grad"
                             " accumulators; batch must divide evenly)")
    parser.add_argument("--remat-policy", default="", dest="remat_policy",
                        choices=["", "full", "dots", "save_proj"],
                        help="rematerialization policy override (config default if empty)")
    parser.add_argument("--attn-impl", default="", dest="attn_impl",
                        choices=[""] + list(ATTN_IMPLS),
                        help="attention core: flash (the CUDA flash kernels),"
                             " flash_tpu/auto (the same kernels under the public"
                             " kernel's contract), splash (the CUDA block-sparse"
                             " kernels: causal/local-window/document masks skip"
                             " dead tiles), xla/blockwise, plain (config default"
                             " if empty)")
    parser.add_argument("--attn-window", type=int, default=0, dest="attn_window",
                        help="local-attention window W for --attn-impl splash:"
                             " each query sees keys [i-W+1, i] (0 = dense causal)")
    parser.add_argument("--mu-dtype", default="", dest="mu_dtype",
                        choices=["", "float32", "bfloat16"],
                        help="Adam first-moment dtype (bfloat16 halves its memory)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="input prefetch depth: batches staged on the device"
                             " ahead of the step (0 = synchronous feed)")
    parser.add_argument("--data", default="",
                        help="flat binary token-id file (np.uint16) to train"
                             " on; empty = synthetic tokens")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without one) or cpu")
    parser.add_argument("--quant", default="", choices=["", "none", "int8", "fp8"],
                        help="matmul precision: int8/fp8 = dynamically quantized"
                             " projections with fp32 sums and straight-through"
                             " gradients; fp8 (e4m3) needs compute capability 8.9+"
                             " (config default if empty)")
    parser.add_argument("--checkpoint-every", type=int, default=0, dest="checkpoint_every",
                        help="save an async checkpoint every N steps (0 = off;"
                             " requires --checkpoint-dir)")
    parser.add_argument("--checkpoint-dir", default="", dest="checkpoint_dir",
                        help="directory for checkpoints, in the JAX package's format")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest complete checkpoint in"
                             " --checkpoint-dir; a fresh dir starts at step 0")
    parser.add_argument("--draft-head", action="store_true", dest="draft_head",
                        help="distill a speculative-decode draft head against the"
                             " frozen target instead of training the target; saved"
                             " as the .draft subtree next to .params (serve --spec-model)")
    parser.add_argument("--draft-layers", type=int, default=2, dest="draft_layers",
                        help="draft-head depth (pre-norm residual blocks)")
    parser.add_argument("--draft-ff", type=int, default=0, dest="draft_ff",
                        help="draft-head MLP width (0 = 2 * d_model)")
    parser.add_argument("--draft-lr", type=float, default=1e-3, dest="draft_lr",
                        help="draft-head AdamW learning rate")
    parser.add_argument("--draft-rollout", type=int, default=2, dest="draft_rollout",
                        help="distillation rollout depth: steps >= 2 train the head"
                             " on its own continuations")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel axis size (fsdp absorbs the rest of"
                             " the ranks)")
    parser.add_argument("--tp-overlap", action="store_true", dest="tp_overlap",
                        help="collective-matmul ring for the TP down-projections:"
                             " the partial sums' transfers hide under the chunk"
                             " products (requires --tp > 1)")
    parser.add_argument("--fsdp-overlap", action="store_true", dest="fsdp_overlap",
                        help="all-gather ring for the FSDP up-projections: weight"
                             " shards rotate around dp*fsdp, each hop hiding under"
                             " the previous chunk's product (requires dp*fsdp > 1"
                             " and d_model divisible by it)")
    parser.add_argument("--autotune", action="store_true",
                        help="sweep the flash/splash kernels' (block_q, block_kv)"
                             " tile pairs before the first step and persist the"
                             " winner (DSTACK_TPU_AUTOTUNE_DIR)")
    args = parser.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint_dir:
        raise SystemExit("--checkpoint-every requires --checkpoint-dir")
    is_moe = args.config in MOE_PRESETS
    if is_moe and args.draft_head:
        raise SystemExit("--draft-head supports dense configs only")

    device = platform.resolve_device(args.device)
    if device.type == "cuda":
        platform.set_reference_matmul_precision()
    owns_group = not dist.is_initialized()
    try:
        if is_moe:
            return _moe_main(args, device)
        layout, mesh = build_mesh(args, device)
        return _main(args, layout, mesh, mesh.device if mesh is not None else device)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, layout: sharding.Mesh, mesh: Optional[sharding.Mesh],
          device: torch.device) -> Dict[str, float]:
    from dstack_tpu_torch.workloads.config import get_config, validate_config

    telemetry = telemetry_lib.get_emitter()
    telemetry.set_identity(proc=dist.get_rank() if mesh is not None else 0)
    if args.draft_head:
        cfg = apply_perf_overrides(get_config(args.config), args)
        batch = args.batch or 2 * layout.axis_size(DATA_AXES)
        seq = args.seq or cfg.max_seq_len
        validate_config(cfg, seq=seq, device=device, mesh=layout, batch=batch)
        print(f"draft-head distillation: config={args.config} device={device}"
              f" devices={layout.size} mesh={layout.shape} batch={batch} seq={seq}"
              f" layers={args.draft_layers} rollout={args.draft_rollout} lr={args.draft_lr}",
              flush=True)
        telemetry.mark("run_start", workload="train_draft", config=args.config,
                       devices=layout.size, batch=batch, seq=seq)
        try:
            # The draft head and its optimizer state are whole on every rank.
            ckpt = make_checkpoint_manager(args, telemetry, mesh,
                                           whole_keys=(".draft", ".opt_state"))
            return distill(cfg, steps=args.steps, batch=batch, seq=seq, device=device,
                           prefetch=args.prefetch, data_path=args.data or None,
                           telemetry=telemetry, mu_dtype=args.mu_dtype or None,
                           ckpt=ckpt, checkpoint_every=args.checkpoint_every,
                           resume=args.resume, draft_layers=args.draft_layers,
                           draft_ff=args.draft_ff, draft_lr=args.draft_lr,
                           rollout=args.draft_rollout, mesh=mesh)
        finally:
            telemetry.close()

    cfg = get_config(args.config)
    if args.remat_policy:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=args.remat_policy)
    cfg = apply_perf_overrides(cfg, args)
    model_lib.remat_policy_of(cfg)  # an unknown policy raises before the first step
    data_shards = layout.axis_size(DATA_AXES)
    # Each MICROBATCH keeps 2 rows per data shard by default (an explicit
    # --batch must divide accordingly).
    batch = args.batch or 2 * data_shards * args.grad_accum
    seq = args.seq or cfg.max_seq_len
    validate_config(cfg, seq=seq, device=device, mesh=layout,
                    batch=batch // max(args.grad_accum, 1))
    if args.autotune:
        autotune_attention(cfg, seq, device, mesh)

    print(f"config={args.config} device={device} devices={layout.size}"
          f" mesh={layout.shape} batch={batch} seq={seq} "
          f"grad_accum={args.grad_accum} attn_impl={cfg.attn_impl} "
          f"attn_window={cfg.attn_window} quant={cfg.quant} "
          f"mu_dtype={args.mu_dtype or 'float32'} "
          f"remat={cfg.remat_policy if cfg.remat else 'off'} prefetch={args.prefetch} "
          f"tp_overlap={cfg.tp_overlap} fsdp_overlap={cfg.fsdp_overlap} "
          f"params={cfg.num_params() / 1e9:.3f}B", flush=True)
    telemetry.mark("run_start", workload="train", config=args.config, devices=layout.size,
                   mesh=layout.shape, batch=batch, seq=seq, grad_accum=args.grad_accum)
    try:
        return train(cfg, steps=args.steps, batch=batch, seq=seq, device=device,
                     grad_accum=args.grad_accum, prefetch=args.prefetch,
                     data_path=args.data or None, telemetry=telemetry,
                     mu_dtype=args.mu_dtype or None,
                     ckpt=make_checkpoint_manager(args, telemetry, mesh),
                     checkpoint_every=args.checkpoint_every, resume=args.resume, mesh=mesh)
    finally:
        telemetry.close()


if __name__ == "__main__":
    main()
