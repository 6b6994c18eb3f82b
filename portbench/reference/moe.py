"""Plain fp32 reference of the Mixtral-style sparse block.

Mixtral 8x7B (arXiv:2401.04088): the Mistral block's attention with its
MLP replaced by a softmax router over E experts, each token sent to its top
k experts (SwiGLU each) and their outputs summed with the top-k gates
renormalised to one. Mixtral as published drops no token; this reference
follows the routing the benchmarked program states (configuration file,
``assumed``): tokens route in groups of ``router_group`` consecutive
positions of a row, each expert takes at most ceil(k * group *
capacity_factor / E) claims per group, first choices claim before any
second choice (slot-major), token order within a slot, ties to the lower
expert index; a claim past the capacity is dropped (the token keeps its
residual only). The auxiliary loss is Switch's: E x the mean over groups
of sum_e(share of first choices on e x mean router probability of e).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from portbench.reference.dense import Params, RefConfig, attention_sublayer, rms_norm, swiglu


def routing_group(c: RefConfig, seq: int) -> int:
    """The largest divisor of ``seq`` that is at most the router group."""
    return next(g for g in range(min(c.router_group, seq), 0, -1) if seq % g == 0)


def moe_mlp(h: torch.Tensor, w: Params, c: RefConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output [B, T, D], this layer's aux loss) for h [B, T, D]."""
    b, t, d = h.shape
    group = routing_group(c, t)
    x = h.reshape(-1, group, d)                                   # [G, S, D]
    n_groups, e, k = x.shape[0], c.n_experts, c.top_k
    probs = torch.softmax(x @ w["router"], dim=-1)                # [G, S, E]
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = ranked[..., :k] / (ranked[..., :k].sum(-1, keepdim=True) + 1e-9)
    chosen = order[..., :k]                                       # [G, S, K]
    capacity = max(1, math.ceil(k * group * c.capacity_factor / e))
    claims = chosen.transpose(1, 2).reshape(n_groups, k * group)  # slot-major
    onehot = F.one_hot(claims, e)
    place = (onehot.cumsum(1) * onehot).sum(-1) - 1               # claim's place at its expert
    kept = place < capacity
    out = torch.zeros_like(x)
    for expert in range(e):
        g_idx, claim = torch.nonzero((claims == expert) & kept, as_tuple=True)
        if g_idx.numel() == 0:
            continue
        s_idx, slot = claim % group, claim // group
        y = swiglu(x[g_idx, s_idx], w["w_gate"][expert], w["w_up"][expert], w["w_down"][expert])
        out = out.index_put((g_idx, s_idx), y * gates[g_idx, s_idx, slot][:, None],
                            accumulate=True)
    first = F.one_hot(chosen[..., 0], e).float().mean(1)          # [G, E]
    balance = (first * probs.mean(1)).sum(-1)                     # [G]
    return out.reshape(b, t, d), e * balance.mean()


def moe_block(x, w: Params, c: RefConfig, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    x = attention_sublayer(x, w, c, positions)
    out, aux = moe_mlp(rms_norm(x, w["mlp_norm"], c.norm_eps), w, c)
    return x + out, aux
