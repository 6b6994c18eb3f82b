"""Pipeline parallelism: GPipe microbatching over a ``pp`` mesh axis.

The port of ``dstack_tpu/workloads/pipeline.py``. The model's stacked layers
split into S contiguous stages over ``pp`` (``stage_params_spec``); the
embed, the final norm and the lm_head are whole on every rank. A stage runs
``model.transformer_block`` meshless, the same block the dense forward
runs, under ``cfg.remat`` and its policy, so the pipelined and the dense
forward agree. The mesh is (dp, pp): data parallelism composes outside the
pp axis, each dp row of stages holding its own rows of the batch.

Where the reference runs one uniform tick body under ``shard_map`` (every
stage computes every tick, bubble ticks on garbage, and the gradient comes
from differentiating the whole schedule), the port writes the fill-drain
schedule out:

- forward: microbatch i reaches stage s at tick i + s; a stage receives its
  input from s - 1 (stage 0 takes the embedded microbatch), runs its layers
  and sends the output to s + 1 (``collective.send``/``recv``). Bubble
  ticks compute nothing. The last stage's outputs are broadcast over pp,
  as the reference's masked ``psum`` replicates them, so every pp rank
  computes the same final norm, logits and loss;
- backward: each stage walks its microbatches in reverse, receives the
  gradient of the output from s + 1 (the last stage takes the loss's own),
  differentiates its layers (``torch.autograd.grad``, recomputing under
  remat) and sends the input's gradient to s - 1. Every rank meets its
  neighbours in the same order, so no hop waits on a cycle. Stage 0's
  input gradient is broadcast over pp, so the embed's gradient, like the
  final norm's and the lm_head's, comes out whole and equal on every pp
  rank; it is not summed over pp, which would count it pp times.

Under dp the loss is the mean over the global batch and every leaf's
gradient is summed over dp (each leaf is whole over it).

Composing fsdp, tp or sp inside the stages is not implemented, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.utils.checkpoint

from dstack_tpu_torch.workloads import model as model_lib
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.config import LlamaConfig
from dstack_tpu_torch.workloads.kernels.collective import (
    broadcast,
    recv,
    reduce_backward,
    send,
)
from dstack_tpu_torch.workloads.sharding import (
    PP_LAYER_KEYS as LAYER_KEYS,
    PP_MESH_AXES,
    PP_PARAM_SPECS,
    Mesh,
    Spec,
    make_pp_mesh,
)

Params = Dict[str, torch.Tensor]

__all__ = ["PP_MESH_AXES", "LAYER_KEYS", "make_pp_mesh", "stage_params_spec",
           "shard_params_pp", "pipelined_forward", "pipelined_loss_fn"]


def stage_params_spec() -> Dict[str, Spec]:
    """Layer-stacked tensors split their leading L axis over pp (L/S layers
    a stage, contiguous); everything else is whole."""
    return dict(PP_PARAM_SPECS)


def shard_params_pp(params: Params, mesh: Mesh, rank: Optional[int] = None) -> Params:
    """``rank``'s pieces of a whole parameter tree on a pipeline mesh
    (views): its stage's layers, and the rest whole."""
    specs = stage_params_spec()
    return {k: v[sharding.local_slices(specs[k], v.shape, mesh, rank)]
            for k, v in params.items()}


class _Schedule:
    """What one pipelined forward needs besides its tensors."""

    def __init__(self, cfg: LlamaConfig, mesh: Mesh, n_micro: int, positions: torch.Tensor,
                 grad: bool):
        self.cfg, self.n_micro, self.positions, self.grad = cfg, n_micro, positions, grad
        self.group = mesh.group("pp")
        self.stages = mesh.members("pp")
        self.stage = mesh.index("pp")

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == len(self.stages) - 1

    def run(self, layers: Params, x: torch.Tensor) -> torch.Tensor:
        """This stage's layers on one microbatch, each layer recomputed in
        the backward pass under cfg.remat, as the dense forward's."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = model_lib.remat_policy_of(cfg) if remat else None
        for layer in range(layers["wq"].shape[0]):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    model_lib.transformer_block, x, layers, layer, cfg, self.positions, None,
                    use_reentrant=False, context_fn=context_fn)
            else:
                x = model_lib.transformer_block(x, layers, layer, cfg, self.positions, None)
        return x


class _Pipeline(torch.autograd.Function):
    """The fill-drain schedule over one dp row of stages: the embedded
    microbatches [n_micro, mb, T, D] (used by stage 0) and this stage's
    layer leaves in, the last stage's outputs out on every pp rank."""

    @staticmethod
    def forward(ctx, sched: _Schedule, micro: torch.Tensor, *leaves: torch.Tensor):
        layers = {k: w.detach().requires_grad_(w.requires_grad)
                  for k, w in zip(LAYER_KEYS, leaves)}
        shape, dtype, device = micro.shape[1:], micro.dtype, micro.device
        ins, outs, sent = [], [], []
        with torch.set_grad_enabled(sched.grad):
            for i in range(sched.n_micro):
                x = micro[i] if sched.first else recv(
                    shape, dtype, device, sched.stages[sched.stage - 1], sched.group)
                x = x.detach().requires_grad_(True)
                y = sched.run(layers, x)
                if not sched.last:
                    sent.append(send(y, sched.stages[sched.stage + 1], sched.group))
                ins.append(x)
                outs.append(y)
        for work in sent:
            work.wait()
        h = (torch.stack([y.detach() for y in outs]) if sched.last
             else torch.empty_like(micro))
        broadcast(h, sched.stages[-1], sched.group)
        ctx.sched, ctx.layers, ctx.ins, ctx.outs = sched, layers, ins, outs
        ctx.micro_shape = micro.shape
        return h

    @staticmethod
    def backward(ctx, grad_h):
        sched, layers = ctx.sched, ctx.layers
        wanted = [w for w in layers.values() if w.requires_grad]
        acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w in wanted]
        d_micro = torch.zeros(ctx.micro_shape, dtype=grad_h.dtype, device=grad_h.device)
        sent = []
        for i in reversed(range(sched.n_micro)):
            y, x = ctx.outs[i], ctx.ins[i]
            g = grad_h[i] if sched.last else recv(
                y.shape, y.dtype, y.device, sched.stages[sched.stage + 1], sched.group)
            grads = torch.autograd.grad(y, [x, *wanted], g.to(y.dtype))
            if sched.first:
                d_micro[i] = grads[0]
            else:
                sent.append(send(grads[0], sched.stages[sched.stage - 1], sched.group))
            for a, gw in zip(acc, grads[1:]):
                a += gw.float()
            ctx.outs[i] = ctx.ins[i] = None
        for work in sent:
            work.wait()
        broadcast(d_micro, sched.stages[0], sched.group)
        it = iter(a.to(w.dtype) for a, w in zip(acc, wanted))
        d_leaves = [next(it) if w.requires_grad else None for w in layers.values()]
        return (None, d_micro, *d_leaves)


def _whole_over_dp(w: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A leaf every dp rank holds whole: its gradient summed over dp."""
    return reduce_backward(w, mesh, "dp") if mesh.shape["dp"] > 1 else w


def pipelined_forward(
    params: Params,
    tokens: torch.Tensor,  # [B/dp, T]: this rank's rows, microbatch by microbatch
    cfg: LlamaConfig,
    mesh: Mesh,
    n_micro: int,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Logits [B/dp, T, V] fp32, or the post-final-norm hidden [B/dp, T, D]
    when ``return_hidden`` (for the chunked cross-entropy), with the pp
    stages in a GPipe schedule. ``params`` are this rank's pieces
    (``shard_params_pp``); ``tokens`` its rows of the global batch [B, T]
    as ``data.rank_rows(B, n_micro, dp index, dp)`` lays them out (the
    reference cuts each microbatch over dp). Every pp rank returns the same
    result. ``mesh`` is a connected pipeline mesh (``make_pp_mesh``)."""
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp != 0:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    b, t = tokens.shape
    if (b * mesh.shape["dp"]) % n_micro != 0:
        raise ValueError(f"batch {b * mesh.shape['dp']} not divisible by n_micro={n_micro}")
    adt = model_lib.dtype_of(cfg.dtype)
    tokens = tokens.to(params["embed"].device).long()
    # Embed outside the pipeline (whole over pp; summed over dp).
    x = _whole_over_dp(params["embed"], mesh).to(adt)[tokens]
    micro = x.reshape(n_micro, b // n_micro, t, -1)
    leaves = [_whole_over_dp(params[k], mesh) for k in LAYER_KEYS]
    grad = torch.is_grad_enabled() and (micro.requires_grad or any(w.requires_grad
                                                                   for w in leaves))
    sched = _Schedule(cfg, mesh, n_micro, torch.arange(t, device=tokens.device), grad)
    h = _Pipeline.apply(sched, micro, *leaves).reshape(b, t, -1)
    h = model_lib._rms_norm(h, _whole_over_dp(params["final_norm"], mesh), cfg.norm_eps)
    if return_hidden:
        return h
    return model_lib._logits(h, _whole_over_dp(params["lm_head"], mesh).to(adt), "none")


def pipelined_loss_fn(
    params: Params,
    tokens: torch.Tensor,
    targets: torch.Tensor,
    cfg: LlamaConfig,
    mesh: Mesh,
    n_micro: int,
) -> torch.Tensor:
    """Mean cross-entropy over the global batch's targets >= 0 (chunked
    over the sequence with cfg.loss_chunk), the same number on every rank;
    ``tokens``/``targets`` are this rank's rows, as ``pipelined_forward``
    takes them."""
    targets = targets.to(params["embed"].device)
    chunk = model_lib.pick_loss_chunk(cfg, tokens.shape[1])
    if chunk:
        hidden = pipelined_forward(params, tokens, cfg, mesh, n_micro, return_hidden=True)
        lm_head = _whole_over_dp(params["lm_head"], mesh).to(model_lib.dtype_of(cfg.dtype))
        total, count = model_lib._chunked_nll(hidden, lm_head, targets, chunk)
    else:
        logits = pipelined_forward(params, tokens, cfg, mesh, n_micro)
        total, count = model_lib._nll_sum(logits, targets)
    if mesh.shape["dp"] == 1:
        return total / torch.clamp(count, min=1)
    return model_lib.global_mean(total, count, mesh, ("dp",))
