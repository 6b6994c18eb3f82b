"""Weight-only int8 and fp8 quantization for serving, in PyTorch.

The serving half of ``dstack_tpu/workloads/quantize.py``, with its names and
its numerics: per-output-channel absmax scales (symmetric, no zero point,
fp32), computed once at engine build, and weights dequantized on use into
the activation dtype with an fp32-accumulated product.

- **int8**: ``round(w / scale)`` clipped to [-127, 127]; ``torch.round``
  rounds half to even, as ``jnp.round`` does.
- **fp8** (e4m3 by default, e5m2 too): each channel is scaled so its absmax
  lands on the format's largest finite value, and the cast to the fp8 dtype
  is the rounding (round to nearest even, in both libraries).

On seeded data both give values bit-equal to the JAX package's and equal
scales. No Pallas kernel backs this module: the dequantize-on-use product is
a PyTorch matmul (see ``weight_only_matmul``). Training's quantized
projections (the STE matmuls) are not ported yet (ROADMAP item 3b).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

INT8_MAX = 127.0

# fp8 representable maxima: the absmax scale maps each channel's peak onto
# these, so the cast never overflows.
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
FP8_DEFAULT_FORMAT = "e4m3"


class QuantizedWeight(NamedTuple):
    """int8/fp8 values + fp32 per-output-channel scales (shape [..., 1, N],
    so a stacked [L, K, N] weight carries [L, 1, N] scales)."""

    values: torch.Tensor  # int8 or float8_*
    scales: torch.Tensor  # float32


def _absmax(x: torch.Tensor, axis: int, max_val: float) -> torch.Tensor:
    # |x| and its max are exact in any float dtype, so they run before the
    # upcast: one fp32 channel row instead of an fp32 copy of the weight.
    # The divisor is a tensor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which is one rounding away from JAX's scales.
    a = x.abs().amax(dim=axis, keepdim=True).float()
    s = a / torch.full_like(a, max_val)
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _scaled(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x / scales in fp32, in a new tensor (never the caller's)."""
    return x.to(torch.float32, copy=True).div_(scales)


def absmax_scales(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Symmetric per-channel int8 scales over ``axis`` (fp32, keepdim). Zero
    channels get scale 1 so dequantization never divides by zero."""
    return _absmax(x, axis, INT8_MAX)


def quantize_int8(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 keepdim scales); round-to-nearest-even, clipped."""
    scales = absmax_scales(x, axis)
    q = _scaled(x, scales).round_().clamp_(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scales


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.float() * scales


def quantize_fp8(
    x: torch.Tensor, axis: int, fmt: str = FP8_DEFAULT_FORMAT
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp8 values, fp32 keepdim scales). The cast is the rounding."""
    scales = _absmax(x, axis, FP8_MAX[fmt])
    return _scaled(x, scales).to(FP8_DTYPES[fmt]), scales


def quantize_weight(w: torch.Tensor, axis: int = -2, mode: str = "int8") -> QuantizedWeight:
    """Per-output-channel weight quantization; ``axis`` is the contraction
    dim (default: K of [..., K, N]). ``mode`` is "int8" or "fp8" (e4m3)."""
    if mode == "fp8":
        values, scales = quantize_fp8(w, axis)
    else:
        values, scales = quantize_int8(w, axis)
    return QuantizedWeight(values, scales)


def weight_only_matmul(
    x: torch.Tensor,        # [..., K] activation dtype
    values: torch.Tensor,   # [K, N] int8 or fp8
    scales: torch.Tensor,   # [1, N] fp32
) -> torch.Tensor:
    """Serve path: dequantize on use, fp32 accumulation; returns fp32.

    The rounding order is the JAX package's: the product stays fp32 and is
    scaled before any cast, so a bf16 caller rounds once, after the scale.
    ``values.to(x.dtype)`` is exact for int8 and fp8 (both fit bf16). On an
    fp32 ``x`` the product is a plain fp32 matmul. On a bf16 ``x`` on the
    card it is ``torch.mm(..., out_dtype=torch.float32)``: bf16 operands,
    fp32 accumulation and an fp32 output, never rounded to bf16. On the CPU,
    where that overload does not exist, both operands are upcast to fp32,
    which gives the same exact products and an fp32 sum."""
    w = values.to(x.dtype)
    if x.dtype == torch.float32:
        acc = x @ w
    elif x.is_cuda:
        acc = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        acc = acc.reshape(*x.shape[:-1], w.shape[-1])
    else:
        acc = x.float() @ w.float()
    return acc * scales


QUANT_MODES = ("none", "int8", "fp8")

# The quant modes whose serve path pre-quantizes weights once at engine build
# (quantize_serve_params) and dequantizes on use (weight_only_matmul).
WEIGHT_ONLY_MODES = ("int8", "fp8")


def is_weight_only(quant: str) -> bool:
    return quant in WEIGHT_ONLY_MODES


def leaf_dtype(key: str, t: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter leaf is kept in: the quantized layout's ``*_q``
    values keep their own (int8 or fp8), its ``*_s`` scales are fp32, and
    every other leaf takes ``dtype``."""
    if key.endswith("_q"):
        return t.dtype
    return torch.float32 if key.endswith("_s") else dtype


def check_quant(quant: str) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}; expected one of {QUANT_MODES}")
