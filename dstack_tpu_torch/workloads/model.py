"""Llama-style decoder in plain PyTorch: parameter init and the dense forward.

Ports ``dstack_tpu/workloads/model.py`` without a mesh: the parameter dict
keeps the JAX package's names and stacked-layer layout (``wq`` is
[L, d_model, H*hd], used as ``x @ w``), so a tree made by the JAX
``init_params`` loads as it is (``convert.params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dstack_tpu_torch.workloads.attention import blockwise_attention
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


def transformer_block(
    x: torch.Tensor, params: Params, layer: int, cfg: LlamaConfig, positions: torch.Tensor
) -> torch.Tensor:
    """One dense decoder block (attention + SwiGLU MLP, both pre-norm residual)."""
    b, t = x.shape[0], x.shape[1]
    h_in = _rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
    q = (h_in @ params["wq"][layer]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (h_in @ params["wk"][layer]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (h_in @ params["wv"][layer]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = blockwise_attention(q, k, v, causal=True)
    o = o.to(x.dtype).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + o @ params["wo"][layer]
    h2 = _rms_norm(x, params["mlp_norm"][layer], cfg.norm_eps)
    gate = h2 @ params["w_gate"][layer]
    up = h2 @ params["w_up"][layer]
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + hidden @ params["w_down"][layer]


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] fp32. Weights are used in
    cfg.dtype (``convert.params_from_numpy`` stores them so)."""
    adt = dtype_of(cfg.dtype)
    tokens = tokens.to(params["embed"].device)
    x = params["embed"].to(adt)[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for layer in range(cfg.n_layers):
        x = transformer_block(x, params, layer, cfg, positions)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["lm_head"].float()
