"""Plain fp32 reference of the Mistral-style decoder.

Written from the published description (Mistral 7B, arXiv:2310.06825, and
the Llama-style block it shares): pre-norm RMSNorm, grouped-query attention
with rotary position embeddings (rotate-half form) under a causal mask
whose band keeps the last ``window`` keys, the query's own included
(``key > query - window``; 0 = no band), a SwiGLU MLP, a final RMSNorm and
an untied lm_head. The weights are the benchmark's tree: stacked over
layers and used as ``x @ w``.

Plain PyTorch in float32 with TF32 off, no kernels of any program, no cache
and no batching of unequal rows. Memory is kept in bounds by computing, not
by cutting the sizes: attention runs over blocks of queries, each block
recomputed in the backward pass (``torch.utils.checkpoint``), and so is
each layer and each block of the loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

Params = Dict[str, torch.Tensor]


def strict_fp32() -> None:
    """float32 products are float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclasses.dataclass(frozen=True)
class RefConfig:
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    window: int = 0          # 0: full causal
    # Mixture of experts (0 experts: the dense MLP).
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    router_group: int = 0
    aux_weight: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def ref_config(config: dict, n_layers: int) -> RefConfig:
    """The reference's view of a configuration file: its published keys and
    the sizes it states as assumed."""
    pub, assumed = config["published"], config.get("assumed_values", {})
    return RefConfig(
        d_model=pub["hidden_size"], n_layers=n_layers, n_heads=pub["num_attention_heads"],
        n_kv_heads=pub["num_key_value_heads"], d_ff=pub["intermediate_size"],
        vocab=pub["vocab_size"], rope_theta=float(pub["rope_theta"]),
        norm_eps=float(pub["rms_norm_eps"]), window=int(pub.get("sliding_window") or 0),
        n_experts=int(pub.get("num_local_experts", 0)),
        top_k=int(pub.get("num_experts_per_tok", 0)),
        capacity_factor=float(assumed.get("capacity_factor", 0.0)),
        router_group=int(assumed.get("router_group", 0)),
        aux_weight=float(pub.get("router_aux_loss_coef", 0.0)),
    )


def tree_shapes(c: RefConfig) -> Dict[str, Tuple[int, ...]]:
    """The leaves of the weight tree, in draw order."""
    d, v, f, L = c.d_model, c.vocab, c.d_ff, c.n_layers
    hq, hk = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    shapes = {"embed": (v, d), "wq": (L, d, hq), "wk": (L, d, hk), "wv": (L, d, hk),
              "wo": (L, hq, d)}
    if c.n_experts:
        e = c.n_experts
        shapes.update(router=(L, d, e), w_gate=(L, e, d, f), w_up=(L, e, d, f),
                      w_down=(L, e, f, d))
    else:
        shapes.update(w_gate=(L, d, f), w_up=(L, d, f), w_down=(L, f, d))
    shapes.update(attn_norm=(L, d), mlp_norm=(L, d), final_norm=(d,), lm_head=(d, v))
    return shapes


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, D]; rotate-half rotary embedding at ``positions`` [T]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = positions.float()[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0: int, k0: int, window: int) -> torch.Tensor:
    """One block of queries (absolute positions from q0) over keys from k0;
    q [B, tq, H, D], k/v [B, tk, Kh, D] -> [B, tq, H, D]."""
    b, tq, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qg = q.reshape(b, tq, kh, rep, d)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(d)
    qp = q0 + torch.arange(tq, device=q.device)[:, None]
    kp = k0 + torch.arange(tk, device=q.device)[None, :]
    keep = kp <= qp
    if window:
        keep = keep & (kp > qp - window)
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v)
    return o.reshape(b, tq, h, d)


def attention(q, k, v, window: int, block: int = 1024) -> torch.Tensor:
    """Causal (banded when ``window``) GQA attention over blocks of queries;
    each block sees only the keys its band reaches."""
    t = q.shape[1]
    outs = []
    for q0 in range(0, t, block):
        q1 = min(t, q0 + block)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window)
        outs.append(ckpt.checkpoint(_attend, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(outs, dim=1)


def attention_sublayer(x, w: Params, c: RefConfig, positions) -> torch.Tensor:
    b, t, _ = x.shape
    h = rms_norm(x, w["attn_norm"], c.norm_eps)
    q = (h @ w["wq"]).view(b, t, c.n_heads, c.head_dim)
    k = (h @ w["wk"]).view(b, t, c.n_kv_heads, c.head_dim)
    v = (h @ w["wv"]).view(b, t, c.n_kv_heads, c.head_dim)
    q, k = rope(q, positions, c.rope_theta), rope(k, positions, c.rope_theta)
    o = attention(q, k, v, c.window).reshape(b, t, c.n_heads * c.head_dim)
    return x + o @ w["wo"]


def swiglu(h, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def dense_block(x, w: Params, c: RefConfig, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    x = attention_sublayer(x, w, c, positions)
    h = rms_norm(x, w["mlp_norm"], c.norm_eps)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"]), x.new_zeros(())


def layer_weights(params: Params, layer: int, dtype=None) -> Params:
    """Layer ``layer``'s slice of every stacked leaf (cast to ``dtype``)."""
    out = {}
    for k, v in params.items():
        if k in ("embed", "final_norm", "lm_head"):
            continue
        out[k] = v[layer] if dtype is None else v[layer].to(dtype)
    return out


def hidden(params: Params, tokens: torch.Tensor, c: RefConfig, block: Callable = dense_block
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden [B, T, D] after the final norm, summed aux loss)."""
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    aux = x.new_zeros(())
    for layer in range(c.n_layers):
        w = layer_weights(params, layer)
        if torch.is_grad_enabled():
            x, a = ckpt.checkpoint(block, x, w, c, positions, use_reentrant=False)
        else:
            x, a = block(x, w, c, positions)
        aux = aux + a
    return rms_norm(x, params["final_norm"], c.norm_eps), aux


def _nll_sum(x, lm_head, targets) -> torch.Tensor:
    logits = x @ lm_head
    return -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None]).sum()


def loss(params: Params, tokens, targets, c: RefConfig, block: Callable = dense_block,
         chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy, plus aux_weight x the summed aux loss."""
    x, aux = hidden(params, tokens, c, block)
    total = x.new_zeros(())
    for c0 in range(0, x.shape[1], chunk):
        total = total + ckpt.checkpoint(_nll_sum, x[:, c0:c0 + chunk], params["lm_head"],
                                        targets[:, c0:c0 + chunk], use_reentrant=False)
    return total / targets.numel() + c.aux_weight * aux


# -- training: AdamW with global-norm clipping -----------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps=1e-8,
    weight_decay, mu_dtype)) as jitted: the update in fp32, the first
    moment stored in ``mu_dtype`` with b1 taken in that type."""

    lr: float
    b1: float
    b2: float
    weight_decay: float
    clip: float
    mu_dtype: torch.dtype = torch.float32
    eps: float = 1e-8


def train(params: Params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], c: RefConfig,
          opt: AdamW, block: Callable = dense_block,
          initial: Optional[Callable[[str], torch.Tensor]] = None) -> dict:
    """Runs ``len(batches)`` AdamW steps on ``params`` (fp32, updated in
    place). Returns each step's loss, each leaf's norm of the first
    gradient as the optimizer gets it (after clipping), and each leaf's norm
    of the parameters' change over all the steps (``initial(name)`` gives
    the leaf as it started; by default a copy is kept)."""
    names = list(params)
    start = {} if initial else {k: params[k].detach().clone() for k in names}
    mu = {k: torch.zeros_like(params[k], dtype=opt.mu_dtype) for k in names}
    nu = {k: torch.zeros_like(params[k]) for k in names}
    b1 = torch.tensor(opt.b1, dtype=opt.mu_dtype).item()
    losses, first = [], {}
    for step, (tokens, targets) in enumerate(batches, start=1):
        leaves = [params[k].requires_grad_(True) for k in names]
        value = loss(params, tokens, targets, c, block)
        grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            norm = torch.sqrt(sum(torch.dot(g.flatten(), g.flatten()) for g in grads))
            scale = 1.0 if float(norm) < opt.clip else opt.clip / float(norm)
            bc1, bc2 = 1.0 - opt.b1 ** step, 1.0 - opt.b2 ** step
            for k, p, g in zip(names, leaves, grads):
                g = g * scale
                if step == 1:
                    first[k] = float(torch.linalg.vector_norm(g.double()))
                m = (1.0 - opt.b1) * g + b1 * mu[k].float()
                nu[k].mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
                mu[k].copy_(m)
                upd = (m / bc1) / (torch.sqrt(nu[k] / bc2) + opt.eps)
                p.sub_(opt.lr * (upd + opt.weight_decay * p))
                del g, m, upd
            del grads
    change = {}
    with torch.no_grad():
        for k in names:
            p0 = initial(k) if initial else start.pop(k)
            change[k] = float(torch.linalg.vector_norm((params[k] - p0).double()))
            del p0
    return {"losses": losses, "first_grad": first, "change": change}


# -- serving: the logits of served tokens ------------------------------------------


@torch.no_grad()
def served_gaps(weights: Params, seqs: List[Tuple[List[int], List[int]]], c: RefConfig,
                device) -> List[List[float]]:
    """For each (prompt, served tokens): at each served position, how far
    the served token's logit lies below the reference's best logit there.
    ``weights`` in any float type, read one layer at a time in fp32; one
    full forward pass per sequence over the prompt and the served tokens."""
    xs, marks = [], []
    for prompt, served in seqs:
        toks = torch.tensor(prompt + served[:-1], device=device)
        xs.append(weights["embed"][toks].float()[None])
        marks.append((len(prompt), served))
    for layer in range(c.n_layers):
        w = layer_weights(weights, layer, torch.float32)
        for i, x in enumerate(xs):
            positions = torch.arange(x.shape[1], device=device)
            xs[i] = dense_block(x, w, c, positions)[0]
        del w
    final, head = weights["final_norm"].float(), weights["lm_head"].float()
    gaps = []
    for x, (n_prompt, served) in zip(xs, marks):
        rows = rms_norm(x[0, n_prompt - 1:], final, c.norm_eps) @ head
        picked = rows.gather(-1, torch.tensor(served, device=device)[:, None])[:, 0]
        gaps.append((rows.max(-1).values - picked).tolist())
    return gaps
