"""Mixture-of-Experts decoder with expert parallelism over an ``ep`` mesh axis.

The port of ``dstack_tpu/workloads/moe.py``: the Mixtral-class family. Each
block keeps the dense model's attention (``model.attention_sublayer``) and
replaces the SwiGLU MLP with token-choice top-k routing over E experts.

Routing is the JAX package's dense dispatch (GShard/Switch): the tokens are
regrouped into groups of about ``router_group``, each group's router picks
its top k experts per token (ties to the lower index, as ``lax.top_k``),
tokens claim expert slots in slot-major priority (every first choice before
any second choice) up to the capacity, and the rest are dropped for that
expert. Two one-hot einsums carry tokens to expert slots and back (the
combine weights are the renormalised gates); the experts run as batched
products over their E axis. Switch's auxiliary loss (on the first choice)
keeps the load balanced. Router logits are fp32.

Under an MoE mesh (``sharding.make_moe_mesh``) each rank holds E/ep
experts and its rows of the batch, which splits over (dp, fsdp, ep). The
all-to-all that GSPMD inserts between the dispatch einsum's token-sharded
input and its expert-sharded output is written out
(``kernels/collective.all_to_all``): on rank (dp i, ep j) the dispatched
[E, G_local, C, D] goes out and [E/ep, ep * G_local, C, D] comes in, the
tokens of every ep rank for this rank's experts; the expert outputs take
the way back. The experts' D axis is gathered on use over (dp, fsdp), as
every dense weight's. Under tp (``MOE_PARAM_SPECS``' "tp" entries) the
experts' hidden F splits over it, the Megatron way: w_gate and w_up are
column-parallel (the expert inputs' gradient summed over tp), w_down
row-parallel, its partial outputs all-reduced over tp before the combine;
attention, the embed and the lm_head split over tp as the dense model's,
and the cross-entropy is vocab-parallel. Gradients: the experts' come out
of the exchange's backward already holding every ep rank's tokens and are
reduce-scattered over (dp, fsdp) only; the dense leaves, whole over ep,
are summed over it too; the router and the norms, whole everywhere, over
the three batch axes (the tp ranks already agree on them). The aux loss
and the cross-entropy are means over the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.profiler import record_function

from dstack_tpu_torch.workloads import model as model_lib
from dstack_tpu_torch.workloads import quantize as quant_lib
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import train as train_lib
from dstack_tpu_torch.workloads.config import LlamaConfig
from dstack_tpu_torch.workloads.kernels.collective import (
    all_to_all,
    gather_on_use,
    max_over,
    reduce_backward,
    reduce_forward,
)
from dstack_tpu_torch.workloads.sharding import DATA_AXES, MOE_DATA_AXES

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert slots = top_k * group * capacity_factor / E (rounded up):
    # 1.0 is exact under perfect balance; more absorbs imbalance.
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # Routing group size in tokens: the largest divisor of the sequence
    # length not above it (the GShard group trick keeps the one-hot tensors
    # O(group^2)).
    router_group: int = 1024

    def num_params(self) -> int:
        d, v = self.d_model, self.vocab_size
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        attn += self.n_heads * self.head_dim * d
        moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts  # experts + router
        per_layer = attn + moe + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v

    def active_params(self) -> int:
        """Parameters a token touches (its top_k experts)."""
        d, v = self.d_model, self.vocab_size
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        attn += self.n_heads * self.head_dim * d
        moe = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        per_layer = attn + moe + 2 * d
        return v * d + self.n_layers * per_layer + d + d * v


MOE_PRESETS = {
    "moe_test": MoeConfig(
        vocab_size=4096, d_model=256, n_layers=2, n_heads=8, n_kv_heads=4, d_ff=512,
        max_seq_len=2048, param_dtype="float32", n_experts=4, top_k=2,
    ),
    # Mixtral-8x7B geometry; loss_chunk keeps [B, T, V] fp32 logits from
    # ever being whole.
    "mixtral_8x7b": MoeConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192, n_experts=8, top_k=2, loss_chunk=512,
    ),
}


def moe_param_shapes(cfg: MoeConfig) -> Dict[str, tuple]:
    """The shape of every leaf of ``init_moe_params``, in the JAX tree's
    names and layout."""
    d, v, f, e = cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.n_experts
    h, kh, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {
        "embed": (v, d), "wq": (L, d, h * hd), "wk": (L, d, kh * hd), "wv": (L, d, kh * hd),
        "wo": (L, h * hd, d), "router": (L, d, e), "w_gate": (L, e, d, f),
        "w_up": (L, e, d, f), "w_down": (L, e, f, d), "attn_norm": (L, d),
        "mlp_norm": (L, d), "final_norm": (d,), "lm_head": (d, v),
    }


def init_moe_params(cfg: MoeConfig, generator: torch.Generator, device: torch.device,
                    dtype: Optional[torch.dtype] = None,
                    mesh: Optional[sharding.Mesh] = None) -> Params:
    """Synthetic weights from ``generator`` (``model.init_params``' recipe:
    normal / sqrt(fan_in) in fp32, norms at one, one layer's draw at a
    time). Under an MoE ``mesh`` every rank draws the meshless tree and
    keeps its pieces (``sharding.MOE_PARAM_SPECS``). The JAX package draws
    other numbers from the same seed."""
    return model_lib.init_params(cfg, generator, device, dtype, mesh,
                                 shapes=moe_param_shapes(cfg))


def shard_moe_params(params: Params, mesh: sharding.Mesh,
                     rank: Optional[int] = None) -> Params:
    """``rank``'s pieces of a whole MoE tree on an MoE mesh (views)."""
    return sharding.shard_params(params, mesh, rank)


def expert_capacity(cfg: MoeConfig, tokens_per_group: int) -> int:
    cap = int(math.ceil(cfg.top_k * tokens_per_group * cfg.capacity_factor / cfg.n_experts))
    return max(cap, 1)


def _route(router_logits: torch.Tensor, top_k: int, capacity: int):
    """(combine [G,S,E,C] fp32, dispatch [G,S,E,C] bool, each group's
    balance term sum_e(fraction routed_e * mean prob_e) [G])."""
    g, s, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    # A stable descending sort puts the lower index first among equal
    # probabilities, as lax.top_k does; torch.topk promises no order.
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = ranked[..., :top_k], order[..., :top_k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    onehot = torch.nn.functional.one_hot(gate_idx, e).float()      # [G,S,K,E]
    # Switch counts the FIRST choice as "routed to".
    balance = (onehot[:, :, 0, :].mean(1) * probs.mean(1)).sum(-1)
    # Slot-major priority: every slot-0 claim before any slot-1 claim; a
    # running count per expert gives each claim its position.
    oh_flat = onehot.transpose(1, 2).reshape(g, top_k * s, e)
    pos = torch.cumsum(oh_flat, dim=1) * oh_flat - 1.0             # [G,K*S,E]
    keep = (pos >= 0) & (pos < capacity)
    # jax.nn.one_hot gives a zero row for an index outside [0, C): -1 (an
    # expert the token did not choose) and C or more (past capacity).
    slots = torch.arange(capacity, device=pos.device)
    pos_oh = (pos.long()[..., None] == slots).float()
    disp = (oh_flat[..., None] * pos_oh * keep[..., None]).reshape(g, top_k, s, e, capacity)
    combine = (disp.transpose(1, 2) * gate_vals[..., None, None]).sum(2)
    return combine, combine > 0.0, balance


def top_k_routing(router_logits: torch.Tensor, top_k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(combine [G,S,E,C], dispatch [G,S,E,C] bool, aux loss): token-choice
    top-k with per-expert capacity, the JAX package's ``top_k_routing``.
    The aux loss is Switch's eq. 4, E * mean over groups of
    sum_e(fraction routed_e * mean prob_e), least under uniform load."""
    combine, dispatch, balance = _route(router_logits, top_k, capacity)
    return combine, dispatch, router_logits.shape[-1] * balance.sum() / balance.shape[0]


def _expert_weight(params: Params, name: str, layer: int, cfg: MoeConfig,
                   mesh: Optional[sharding.Mesh], adt: torch.dtype) -> torch.Tensor:
    """A layer's expert weight [E/ep, K, N] in the activation dtype, its D
    axis gathered over the data ranks on use; under quant=int8 on the int8
    grid over K with straight-through gradients (fp8 leaves the experts
    alone, as the JAX package does), w_down's scales joined over tp, which
    splits its K."""
    w = params[name][layer]
    if mesh is None:
        w = w.to(adt)
    else:
        if mesh.shape["sp"] > 1:
            # Each sp rank runs the experts on its own tokens.
            w = reduce_backward(w, mesh, "sp")
        w = gather_on_use(w, 2 if name == "w_down" else 1, mesh, DATA_AXES, adt)
    if cfg.quant != "int8":
        return w
    row_parallel = name == "w_down" and model_lib._tp(mesh) > 1
    return quant_lib.fake_quant(w, axis=1, reduce=max_over(mesh, "tp") if row_parallel else None)


def _to_experts(x: torch.Tensor, mesh: sharding.Mesh) -> torch.Tensor:
    """[E, G, C, D] of this rank's groups -> [E/ep, ep * G, C, D]: every ep
    rank's groups for this rank's experts, in ep order."""
    ep = mesh.shape["ep"]
    e, g, c, d = x.shape
    y = all_to_all(x, mesh, "ep")                      # block j from ep rank j
    return y.unflatten(0, (ep, e // ep)).transpose(0, 1).reshape(e // ep, ep * g, c, d)


def _to_tokens(y: torch.Tensor, mesh: sharding.Mesh) -> torch.Tensor:
    """The way back: [E/ep, ep * G, C, D] -> [E, G, C, D] of this rank's
    groups, every expert's outputs."""
    ep = mesh.shape["ep"]
    e_loc, n, c, d = y.shape
    blocks = y.unflatten(1, (ep, n // ep)).transpose(0, 1).reshape(ep * e_loc, n // ep, c, d)
    return all_to_all(blocks, mesh, "ep")


def routing_group(cfg: MoeConfig, seq: int) -> int:
    """The routing group of a sequence of ``seq`` positions: the largest
    divisor of it that is at most cfg.router_group."""
    return next((c for c in range(min(cfg.router_group, seq), 0, -1) if seq % c == 0), seq)


def moe_mlp(x: torch.Tensor, params: Params, layer: int, cfg: MoeConfig,
            mesh: Optional[sharding.Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, D], aux loss) of layer ``layer``'s experts on ``x``
    [B, S, D] (activation dtype; under a mesh this rank's rows, under sp
    its chunk of the sequence). The aux loss is the global batch's under a
    mesh.

    Under sp the routing groups are the reference's, cut from the global
    sequence. When a group divides the chunk, every group lies inside one
    rank and the chunk routes alone. When groups straddle ranks, the chunks
    are gathered over sp (the gather's backward reduce-scatters), every sp
    rank routes and runs the experts on the whole sequence of its rows and
    keeps its chunk of the output, and its aux loss counts 1/sp (each sp
    rank computes the same one)."""
    adt = x.dtype
    sp = mesh.shape["sp"] if mesh is not None else 1
    s_loc = x.shape[1]
    group = routing_group(cfg, s_loc * sp)
    straddle = sp > 1 and s_loc % group != 0
    if straddle:
        x = gather_on_use(x, 1, mesh, "sp")
    b, s, d = x.shape
    g = b * (s // group)
    x = x.reshape(g, group, d)
    cap = expert_capacity(cfg, group)
    exchange = mesh is not None and mesh.shape["ep"] > 1

    with record_function("moe.route"):
        # Routing stays full precision under quant (a mis-rounded router
        # moves tokens between experts): bf16 x bf16 products are exact in
        # fp32, so this is the reference's fp32-accumulated einsum.
        router = params["router"][layer]
        if mesh is not None:
            router = reduce_backward(router, mesh, sharding.token_axes(mesh))
        logits = x.float() @ router.to(adt).float()                # [G, S, E]
        combine, dispatch, balance = _route(logits, cfg.top_k, cap)
    with record_function("moe.dispatch"):
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(adt), x)
        if exchange:
            expert_in = _to_experts(expert_in, mesh)
    with record_function("moe.experts"):
        # One fp32-accumulated product rounded once to the activation dtype
        # (the reference's preferred_element_type=float32, then astype).
        # Under tp each rank holds F/tp of the hidden: the inputs' gradient
        # is summed over tp, the w_down partials in fp32 before the rounding.
        tp = model_lib._tp(mesh)
        e_loc = expert_in.shape[0]
        xe = expert_in.reshape(e_loc, -1, d)
        if tp > 1:
            xe = reduce_backward(xe, mesh, "tp")
        gate = torch.bmm(xe, _expert_weight(params, "w_gate", layer, cfg, mesh, adt))
        up = torch.bmm(xe, _expert_weight(params, "w_up", layer, cfg, mesh, adt))
        hidden = torch.nn.functional.silu(gate.float()).to(adt) * up
        w_down = _expert_weight(params, "w_down", layer, cfg, mesh, adt)
        if tp > 1:
            expert_out = reduce_forward(torch.bmm(hidden.float(), w_down.float()), mesh,
                                        "tp").to(adt)
        else:
            expert_out = torch.bmm(hidden, w_down)
        expert_out = expert_out.reshape(expert_in.shape)
    with record_function("moe.combine"):
        if exchange:
            expert_out = _to_tokens(expert_out, mesh)
        out = torch.einsum("gsec,egcd->gsd", combine.to(adt), expert_out)
    out = out.reshape(b, s, d)
    total, groups = balance.sum(), g
    if straddle:
        i = mesh.index("sp")
        out = out[:, i * s_loc:(i + 1) * s_loc]
        total = total / sp
        groups *= mesh.axis_size(MOE_DATA_AXES)
    elif mesh is not None:
        groups *= mesh.axis_size(sharding.token_axes(mesh))
    if mesh is not None:
        total = reduce_forward(total, mesh, sharding.token_axes(mesh))
    return out, cfg.n_experts * total / groups


def _block(x: torch.Tensor, params: Params, layer: int, cfg: MoeConfig,
           positions: torch.Tensor, mesh: Optional[sharding.Mesh]):
    axes = sharding.token_axes(mesh)
    x = model_lib.attention_sublayer(x, params, layer, cfg, positions, mesh, axes)
    norm = model_lib._norm_weight(params, "mlp_norm", layer, mesh, axes)
    out, aux = moe_mlp(model_lib._rms_norm(x, norm, cfg.norm_eps), params, layer, cfg, mesh)
    return x + out, aux


def forward(params: Params, tokens: torch.Tensor, cfg: MoeConfig,
            mesh: Optional[sharding.Mesh] = None, return_hidden: bool = False):
    """(logits [B, T, V] fp32, total aux loss), or (hidden [B, T, D], aux)
    when ``return_hidden`` (for the chunked cross-entropy). Under cfg.remat
    each block is recomputed in the backward pass, its all-to-alls with it.
    Under an MoE ``mesh``: this rank's rows, under sp its chunk of the
    sequence (attention runs the ring, as the dense model's)."""
    if mesh is not None:
        sharding.validate_moe_mesh(cfg, mesh)
    adt = model_lib.dtype_of(cfg.dtype)
    axes = sharding.token_axes(mesh)
    tokens = tokens.to(params["embed"].device).long()
    x = model_lib._embed_lookup(params["embed"], tokens, mesh, adt, axes)
    positions = model_lib.positions_of(tokens.shape[1], mesh, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = model_lib.remat_policy_of(cfg) if remat else None
    auxes = []
    for layer in range(cfg.n_layers):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _block, x, params, layer, cfg, positions, mesh,
                use_reentrant=False, context_fn=context_fn,
            )
        else:
            x, aux = _block(x, params, layer, cfg, positions, mesh)
        auxes.append(aux)
    norm = model_lib._norm_weight(params, "final_norm", None, mesh, axes)
    x = model_lib._rms_norm(x, norm, cfg.norm_eps)
    aux_total = torch.stack(auxes).sum()
    if return_hidden:
        return x, aux_total
    # The MoE lm_head is the fp product under every quant mode, as the
    # reference's; under tp the logits are this rank's V/tp columns.
    return model_lib._logits(model_lib._tp_input(x, mesh),
                             model_lib._lm_head(params, cfg, mesh, adt, axes),
                             "none"), aux_total


def loss_fn(params: Params, tokens: torch.Tensor, targets: torch.Tensor, cfg: MoeConfig,
            mesh: Optional[sharding.Mesh] = None) -> torch.Tensor:
    """Masked mean cross-entropy (chunked over the sequence with
    cfg.loss_chunk) plus aux_loss_weight x the aux loss; under a mesh both
    are the global batch's, the same number on every rank."""
    targets = targets.to(params["embed"].device)
    chunk = model_lib.pick_loss_chunk(cfg, tokens.shape[1])
    tp_mesh = mesh if model_lib._tp(mesh) > 1 else None
    if chunk:
        hidden, aux = forward(params, tokens, cfg, mesh, return_hidden=True)
        lm_head = model_lib._lm_head(params, cfg, mesh, model_lib.dtype_of(cfg.dtype),
                                     sharding.token_axes(mesh))
        total, count = model_lib._chunked_nll(model_lib._tp_input(hidden, mesh), lm_head,
                                              targets, chunk, tp_mesh=tp_mesh)
    else:
        logits, aux = forward(params, tokens, cfg, mesh)
        total, count = model_lib._nll_sum(logits, targets, tp_mesh)
    if mesh is None:
        ce = total / torch.clamp(count, min=1)
    else:
        ce = model_lib.global_mean(total, count, mesh, sharding.token_axes(mesh))
    return ce + cfg.aux_loss_weight * aux


def init_moe_train_state(cfg: MoeConfig, optimizer: train_lib.OptimizerConfig,
                         device: Optional[torch.device] = None, params: Optional[Params] = None,
                         mesh: Optional[sharding.Mesh] = None) -> train_lib.MoeTrainState:
    """Synthetic parameters from seed 0 on ``device`` (or the given
    ``params``, used as they are), trainable, and their optimizer; under an
    MoE ``mesh`` this rank's pieces."""
    if params is None:
        device = torch.device(device)
        params = init_moe_params(cfg, torch.Generator(device=device).manual_seed(0), device,
                                 mesh=mesh)
    for p in params.values():
        p.requires_grad_(True)
    return train_lib.MoeTrainState(params=params, opt=optimizer.build(params))


def make_moe_train_step(cfg: MoeConfig, optimizer: train_lib.OptimizerConfig,
                        mesh: Optional[sharding.Mesh] = None, grad_accum: int = 1):
    """(state, tokens, targets) -> (state, metrics): one AdamW update of the
    MoE loss over ``grad_accum`` microbatches, with global-norm clipping,
    as ``train.make_train_step``. Under an MoE ``mesh`` the state holds this
    rank's pieces and tokens/targets its rows (``data.rank_rows`` over
    dp x fsdp x ep)."""
    if mesh is not None:
        sharding.validate_moe_mesh(cfg, mesh)
    return train_lib.make_train_step(cfg, optimizer, mesh, grad_accum, loss=loss_fn)
