"""Llama-style decoder in plain PyTorch: parameter init, the dense forward,
the training loss and the speculative-decode draft head.

Ports ``dstack_tpu/workloads/model.py`` without a mesh: the parameter dict
keeps the JAX package's names and stacked-layer layout (``wq`` is
[L, d_model, H*hd], used as ``x @ w``), so a tree made by the JAX
``init_params`` loads as it is (``convert.params_from_numpy``). The layer
loop is a Python loop in place of ``lax.scan``; ``torch.utils.checkpoint``
takes the place of ``jax.checkpoint``.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint

from dstack_tpu_torch.workloads import quantize as quant_lib
from dstack_tpu_torch.workloads.attention import attention_core
from dstack_tpu_torch.workloads.config import LlamaConfig

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Synthetic weights from ``generator``: normal / sqrt(fan_in) drawn in
    fp32, norms at one, stored in ``dtype`` (default cfg.param_dtype). Drawn
    one layer at a time, so the fp32 draw never holds more than one layer's
    slice. The JAX package draws other numbers from the same seed."""
    dtype = dtype or dtype_of(cfg.param_dtype)
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    h, kh, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def dense(*shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0] if len(shape) == 3 else 1):
            dst = out[i] if len(shape) == 3 else out
            draw = torch.randn(dst.shape, generator=generator, dtype=torch.float32, device=device)
            dst.copy_(draw / fan_in ** 0.5)
        return out

    def norm(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": dense(v, d, fan_in=d),
        "wq": dense(L, d, h * hd, fan_in=d),
        "wk": dense(L, d, kh * hd, fan_in=d),
        "wv": dense(L, d, kh * hd, fan_in=d),
        "wo": dense(L, h * hd, d, fan_in=h * hd),
        "w_gate": dense(L, d, f, fan_in=d),
        "w_up": dense(L, d, f, fan_in=d),
        "w_down": dense(L, f, d, fan_in=f),
        "attn_norm": norm(L, d),
        "mlp_norm": norm(L, d),
        "final_norm": norm(d),
        "lm_head": dense(d, v, fan_in=d),
    }


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """The shape of every leaf of ``init_params``, without allocating it."""
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    h, kh, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    return {
        "embed": (v, d), "wq": (L, d, h * hd), "wk": (L, d, kh * hd), "wv": (L, d, kh * hd),
        "wo": (L, h * hd, d), "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
        "attn_norm": (L, d), "mlp_norm": (L, d), "final_norm": (d,), "lm_head": (d, v),
    }


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    """cos, sin of the rotary angles, [..., D/2] fp32 for positions [...]."""
    freqs = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d)
    )
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding; x [B,T,H,D], positions [T]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def dense_proj(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` in the activation dtype, under cfg.quant: the
    fp product (the weight cast to x.dtype on use), or the dynamically
    quantized int8/fp8 product with straight-through gradients. Meshless,
    this is both of the reference's ``up_proj`` and ``down_proj``."""
    return quant_lib.matmul(x, w, cfg.quant, adt=x.dtype)


def attention_sublayer(
    x: torch.Tensor, params: Params, layer: int, cfg: LlamaConfig, positions: torch.Tensor
) -> torch.Tensor:
    """Pre-norm attention + residual on ``attention_core(cfg.attn_impl)``."""
    b, t = x.shape[0], x.shape[1]
    h_in = _rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
    q = dense_proj(h_in, params["wq"][layer], cfg).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = dense_proj(h_in, params["wk"][layer], cfg).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = dense_proj(h_in, params["wv"][layer], cfg).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attention_core(q, k, v, cfg.attn_impl, window=cfg.attn_window)
    o = o.to(x.dtype).reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + dense_proj(o, params["wo"][layer], cfg)


def transformer_block(
    x: torch.Tensor, params: Params, layer: int, cfg: LlamaConfig, positions: torch.Tensor
) -> torch.Tensor:
    """One dense decoder block (attention + SwiGLU MLP, both pre-norm residual)."""
    x = attention_sublayer(x, params, layer, cfg, positions)
    h2 = _rms_norm(x, params["mlp_norm"][layer], cfg.norm_eps)
    gate = dense_proj(h2, params["w_gate"][layer], cfg)
    up = dense_proj(h2, params["w_up"][layer], cfg)
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + dense_proj(hidden, params["w_down"][layer], cfg)


def remat_policy_of(cfg: LlamaConfig) -> Callable:
    """cfg.remat_policy -> the ``context_fn`` of ``torch.utils.checkpoint``:
    "full" recomputes the whole block; "dots" saves the outputs of the
    projection matmuls (``aten.mm``; the reference's dots without batch
    dimensions) and recomputes the rest."""
    if cfg.remat_policy == "full":
        return torch.utils.checkpoint.noop_context_fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default],
        )
    if cfg.remat_policy == "save_proj":
        raise NotImplementedError(
            "remat_policy=save_proj is not yet ported to PyTorch (ROADMAP item 12)"
        )
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    return_hidden: bool = False,
) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] fp32, or the final hidden state
    [B, T, D] (post final_norm, pre lm_head) when ``return_hidden``, which the
    chunked cross-entropy uses. Every weight is cast to cfg.dtype on use, so
    fp32 masters and weights stored in cfg.dtype give the same result. Under
    cfg.remat each block is recomputed in the backward pass (when gradients
    are recorded)."""
    adt = dtype_of(cfg.dtype)
    tokens = tokens.to(params["embed"].device)
    x = params["embed"].to(adt)[tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = remat_policy_of(cfg) if remat else None
    for layer in range(cfg.n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                transformer_block, x, params, layer, cfg, positions,
                use_reentrant=False, context_fn=context_fn,
            )
        else:
            x = transformer_block(x, params, layer, cfg, positions)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    if cfg.quant == "int8":
        return quant_lib.int8_matmul_ste(x, params["lm_head"])
    # bf16 x bf16 products are exact in fp32: an fp32 product of the rounded
    # operands is the reference's dot with fp32 accumulation. Under fp8 the
    # lm_head stays this fp product, as the reference's does.
    return x.float() @ params["lm_head"].to(adt).float()


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of -log p(target) over targets >= 0, their count); logits fp32,
    targets -1 = ignore."""
    mask = targets >= 0
    safe = torch.where(mask, targets, 0).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum()


def _chunk_nll(x_blk: torch.Tensor, t_blk: torch.Tensor, lm_head: torch.Tensor, quant: str):
    if quant == "int8":
        return _nll_sum(quant_lib.int8_matmul_ste(x_blk, lm_head), t_blk)
    return _nll_sum(x_blk.float() @ lm_head.float(), t_blk)


def _chunked_nll(
    x: torch.Tensor,        # [B, T, D] final hidden (post final_norm)
    lm_head: torch.Tensor,  # [D, V] in the activation dtype
    targets: torch.Tensor,  # [B, T]; -1 = ignore
    chunk: int,
    quant: str = "none",
):
    """Cross-entropy without materializing [B,T,V] fp32 logits: the sequence
    goes in chunks, each chunk's logits and log-softmax are recomputed in the
    backward pass (``torch.utils.checkpoint``). Returns (total nll, count)."""
    total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    total_cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        nll, cnt = torch.utils.checkpoint.checkpoint(
            _chunk_nll, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], lm_head, quant,
            use_reentrant=False,
        )
        total_nll = total_nll + nll
        total_cnt = total_cnt + cnt
    return total_nll, total_cnt


def pick_loss_chunk(cfg: LlamaConfig, seq_len: int) -> int:
    """Largest divisor of seq_len that is <= cfg.loss_chunk, keeping the
    chunked path for any length; 0 = full logits (loss_chunk off, or no
    usable divisor)."""
    if not cfg.loss_chunk:
        return 0
    chunk = next(
        (c for c in range(min(cfg.loss_chunk, seq_len), 0, -1) if seq_len % c == 0), 1
    )
    if chunk < max(1, cfg.loss_chunk // 8):
        warnings.warn(
            f"loss_chunk={cfg.loss_chunk} has no usable divisor of seq_len="
            f"{seq_len} (best {chunk}); falling back to full logits",
            stacklevel=3,
        )
        return 0
    return chunk


def masked_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over targets >= 0 (-1 = ignore); logits fp32."""
    total, count = _nll_sum(logits, targets)
    return total / torch.clamp(count, min=1)


def loss_fn(
    params: Params,
    tokens: torch.Tensor,   # [B, T]
    targets: torch.Tensor,  # [B, T]; -1 = ignore
    cfg: LlamaConfig,
) -> torch.Tensor:
    targets = targets.to(params["embed"].device)
    chunk = pick_loss_chunk(cfg, tokens.shape[1])
    if chunk:
        hidden = forward(params, tokens, cfg, return_hidden=True)
        lm_head = params["lm_head"].to(dtype_of(cfg.dtype))
        total_nll, total_cnt = _chunked_nll(hidden, lm_head, targets, chunk, quant=cfg.quant)
        return total_nll / torch.clamp(total_cnt, min=1)
    return masked_ce(forward(params, tokens, cfg), targets)


# ---------------------------------------------------------------------------
# Speculative-decode draft head (EAGLE-style conditioning), as the
# reference's: the target's last hidden state (post final_norm) and the
# embedding of the token it emitted go through a [2D, D] fusion and a short
# stack of pre-norm residual SwiGLU blocks, and the result is read through
# the TARGET's lm_head. No attention and no KV cache of its own, so
# preemption and re-prefill need no head state.


def init_draft_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device,
    n_layers: int = 2,
    d_ff: int = 0,
) -> Params:
    """The draft head's tree (stacked layers), normal / sqrt(fan_in) in
    fp32, stored in cfg.param_dtype. ``d_ff`` defaults to 2 * d_model. The
    JAX package draws other numbers from the same seed."""
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    f = d_ff or 2 * d

    def dense(*shape, fan_in):
        draw = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (draw / fan_in ** 0.5).to(dtype)

    return {
        "w_fuse": dense(2 * d, d, fan_in=2 * d),
        "mlp_norm": torch.ones((n_layers, d), dtype=dtype, device=device),
        "w_gate": dense(n_layers, d, f, fan_in=d),
        "w_up": dense(n_layers, d, f, fan_in=d),
        "w_down": dense(n_layers, f, d, fan_in=f),
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }


def _draft_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's ``_draft_mm``: fp32-accumulated, returned in x.dtype."""
    return x @ w.to(x.dtype)


def draft_apply(draft: Params, hidden: torch.Tensor, tok_emb: torch.Tensor,
                cfg: LlamaConfig) -> torch.Tensor:
    """One head application: (target hidden [..., D], condition-token
    embedding [..., D]) -> predicted next hidden [..., D], in the basis the
    target's lm_head reads (post final_norm)."""
    x = _draft_mm(torch.cat([hidden, tok_emb], dim=-1), draft["w_fuse"])
    for layer in range(draft["mlp_norm"].shape[0]):
        h2 = _rms_norm(x, draft["mlp_norm"][layer], cfg.norm_eps)
        gate = _draft_mm(h2, draft["w_gate"][layer])
        up = _draft_mm(h2, draft["w_up"][layer])
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        x = x + _draft_mm(act, draft["w_down"][layer])
    return _rms_norm(x, draft["final_norm"], cfg.norm_eps)


def draft_distill_loss(draft: Params, params: Params, tokens: torch.Tensor,
                       cfg: LlamaConfig, rollout: int = 2) -> torch.Tensor:
    """Distillation loss against the frozen target on one batch: the head's
    cross-entropy against the target's own argmax. Position t conditions on
    (target hidden_t, embedding of token_{t+1}) and predicts the target's
    argmax at t+1; rollout step j >= 2 feeds the head its own previous
    output and proposed token, labelled j ahead. The target's forward runs
    without gradients and its labels are constants, so gradients reach
    ``draft`` only."""
    adt = dtype_of(cfg.dtype)
    tokens = tokens.to(params["embed"].device).long()
    with torch.no_grad():
        hidden = forward(params, tokens, cfg, return_hidden=True)  # [B, T, D]
        labels = _draft_mm(hidden, params["lm_head"]).float().argmax(-1)  # a_t
    h = hidden[:, :-1]          # rows t = 0..T-2
    cond = tokens[:, 1:]        # x_{t+1}
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for j in range(1, rollout + 1):
        e = params["embed"].to(adt)[cond]
        h = draft_apply(draft, h, e, cfg)
        logits_j = _draft_mm(h, params["lm_head"]).float()
        # Row t's label at depth j is a_{t+j}; rows past T-1-j have none.
        lab = torch.nn.functional.pad(labels[:, j:], (0, j - 1), value=-1)
        total = total + masked_ce(logits_j, lab)
        cond = logits_j.argmax(-1)
    return total / rollout
