"""Int8 and fp8 quantized matmuls for training (straight-through) and
serving (weight-only), in PyTorch.

The port of ``dstack_tpu/workloads/quantize.py``, with its names and its
numerics: per-channel absmax scales (symmetric, no zero point, fp32).

- **int8**: ``round(w / scale)`` clipped to [-127, 127]; ``torch.round``
  rounds half to even, as ``jnp.round`` does.
- **fp8** (e4m3 by default, e5m2 too): each channel is scaled so its absmax
  lands on the format's largest finite value, and the cast to the fp8 dtype
  is the rounding (round to nearest even, in both libraries).

On seeded data both give values bit-equal to the JAX package's and equal
scales.

- **Training** (``int8_matmul_ste``, ``fp8_matmul_ste``): both operands are
  quantized on every call (activations per row over K, weights per output
  channel), the product is summed in int32 (int8) or fp32 (fp8), and both
  scales multiply the fp32 sum, in JAX's order, before any cast. The
  backward pass is straight-through: the exact fp32 gradients of ``x @ w``
  against the original operands.
- **Serving** (``quantize_weight``, ``weight_only_matmul``): weights are
  quantized once at engine build and dequantized on use into the activation
  dtype, with an fp32-accumulated product.

No Pallas kernel backs this module: JAX computes these products with
``dot_general``. On the card the int8 product is ``torch._int_mm`` (exact
int32 sums) and the fp8 product ``torch._scaled_mm`` with unit scales, an
fp32 output and cuBLAS's fp32 accumulation (``use_fast_accum=False``); on
the CPU both upcast (int64 sums, which are exact; fp32 products of the fp8
values, which are exact too, summed in fp32).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

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


# An in-place max over the ranks that hold the rest of a contraction
# (collective.max_over): a row-parallel product's scales then span the whole
# contraction, as GSPMD computes them on the sharded operands.
Reduce = Optional[Callable[[torch.Tensor], None]]


def _absmax(x: torch.Tensor, axis: int, max_val: float, reduce: Reduce = None) -> torch.Tensor:
    # |x| and its max are exact in any float dtype, so they run before the
    # upcast: one fp32 channel row instead of an fp32 copy of the weight.
    # The divisor is a tensor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which is one rounding away from JAX's scales.
    a = x.abs().amax(dim=axis, keepdim=True).float()
    if reduce is not None:
        reduce(a)
    s = a / torch.full_like(a, max_val)
    return torch.where(s == 0.0, torch.ones_like(s), s)


def _scaled(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x / scales in fp32, in a new tensor (never the caller's)."""
    return x.to(torch.float32, copy=True).div_(scales)


def absmax_scales(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Symmetric per-channel int8 scales over ``axis`` (fp32, keepdim). Zero
    channels get scale 1 so dequantization never divides by zero."""
    return _absmax(x, axis, INT8_MAX)


def quantize_int8(x: torch.Tensor, axis: int,
                  reduce: Reduce = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 keepdim scales); round-to-nearest-even, clipped."""
    scales = _absmax(x, axis, INT8_MAX, reduce)
    q = _scaled(x, scales).round_().clamp_(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scales


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return values.float() * scales


def quantize_fp8(
    x: torch.Tensor, axis: int, fmt: str = FP8_DEFAULT_FORMAT, reduce: Reduce = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp8 values, fp32 keepdim scales). The cast is the rounding."""
    scales = _absmax(x, axis, FP8_MAX[fmt], reduce)
    return _scaled(x, scales).to(FP8_DTYPES[fmt]), scales


def quantize_weight(w: torch.Tensor, axis: int = -2, mode: str = "int8",
                    reduce: Reduce = None) -> QuantizedWeight:
    """Per-output-channel weight quantization; ``axis`` is the contraction
    dim (default: K of [..., K, N]). ``mode`` is "int8" or "fp8" (e4m3).
    ``reduce`` joins the absmax of a contraction split over ranks (a
    row-parallel shard), so the scales are the whole weight's."""
    if mode == "fp8":
        values, scales = quantize_fp8(w, axis, reduce=reduce)
    else:
        values, scales = quantize_int8(w, axis, reduce=reduce)
    return QuantizedWeight(values, scales)


def _int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of ``xq[M, K] @ wq[K, N]`` (int8). ``torch._int_mm``
    wants more than 16 rows and K, N multiples of 8: fewer rows are padded
    with zero rows, which add nothing."""
    if not xq.is_cuda:
        return (xq.long() @ wq.long()).int()
    m, k = xq.shape
    n = wq.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"int8 matmul on the card needs K and N multiples of 8, got K={k} N={n}")
    if m <= 16:
        xq = torch.cat([xq, xq.new_zeros(17 - m, k)])
    return torch._int_mm(xq, wq)[:m]


def _fp8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """fp32 sums of ``xq[M, K] @ wq[K, N]`` (fp8 values). On the card:
    ``torch._scaled_mm`` with unit scales, an fp32 output and fp32
    accumulation; the second operand goes in column-major, as cuBLASLt
    wants it. On the CPU: the exact fp32 products, summed in fp32."""
    if not xq.is_cuda:
        return xq.float() @ wq.float()
    k, n = wq.shape
    if k % 16 or n % 16:
        raise ValueError(f"fp8 matmul on the card needs K and N multiples of 16, got K={k} N={n}")
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    return torch._scaled_mm(
        xq, wq.t().contiguous().t(), scale_a=one, scale_b=one,
        out_dtype=torch.float32, use_fast_accum=False,
    )


def _quantized_matmul(x: torch.Tensor, w: torch.Tensor, quantize, dot,
                      reduce: Reduce = None) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` through ``quantize`` (activations per row,
    weights per output channel) and ``dot``: the fp32 sum times the
    activation scales times the weight scales, in that order."""
    xq, xs = quantize(x, -1, reduce=reduce)   # xs [..., 1]
    wq, ws = quantize(w, 0, reduce=reduce)    # ws [1, N]
    acc = dot(xq.reshape(-1, x.shape[-1]), wq).reshape(*x.shape[:-1], w.shape[-1])
    return acc.float() * xs * ws


def int8_matmul(x: torch.Tensor, w: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """Dynamically quantized ``x[..., K] @ w[K, N]`` -> fp32: int8 operands,
    exact int32 sums; the only error is the rounding of the operands.
    ``reduce`` joins the scales of a contraction split over ranks."""
    return _quantized_matmul(x, w, quantize_int8, _int8_dot, reduce)


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, fmt: str = FP8_DEFAULT_FORMAT,
               reduce: Reduce = None) -> torch.Tensor:
    """Dynamically quantized fp8 ``x[..., K] @ w[K, N]`` -> fp32: the same
    scale algebra as ``int8_matmul`` on fp8 operands, fp32 sums."""
    return _quantized_matmul(
        x, w, lambda a, axis, reduce: quantize_fp8(a, axis, fmt, reduce), _fp8_dot, reduce)


def _ste_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Straight-through: the gradients of ``y = x @ w`` as if nothing were
    quantized, against the original operands, in fp32 (g is fp32), returned
    in x's and w's dtypes."""
    dx = g @ w.float().t()
    dw = x.reshape(-1, x.shape[-1]).float().t() @ g.reshape(-1, g.shape[-1])
    return dx.to(x.dtype), dw.to(w.dtype)


class _Int8MatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, reduce=None):
        ctx.save_for_backward(x, w)
        return int8_matmul(x, w, reduce)

    @staticmethod
    def backward(ctx, g):
        return (*_ste_grads(*ctx.saved_tensors, g.float()), None)


class _Fp8MatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, reduce=None):
        ctx.save_for_backward(x, w)
        return fp8_matmul(x, w, reduce=reduce)

    @staticmethod
    def backward(ctx, g):
        return (*_ste_grads(*ctx.saved_tensors, g.float()), None)


def int8_matmul_ste(x: torch.Tensor, w: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """int8_matmul with straight-through gradients (the train path)."""
    return _Int8MatmulSTE.apply(x, w, reduce)


def fp8_matmul_ste(x: torch.Tensor, w: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """fp8_matmul with straight-through gradients: forward in e4m3, the
    backward the exact fp gradients, as int8_matmul_ste's."""
    return _Fp8MatmulSTE.apply(x, w, reduce)


def fake_quant(w: torch.Tensor, axis: int, reduce: Reduce = None) -> torch.Tensor:
    """Quantize-dequantize onto the int8 grid with straight-through
    gradients, for weights ``int8_matmul`` cannot take (the MoE experts'
    [E, D, F] tensors, contracted by a batched product): per-channel scales
    over ``axis``, the values int8-grid exact, the gradient that of ``w``.
    The arithmetic is the JAX package's, ``w + (deq - w)`` with the
    difference detached. ``reduce`` joins the scales over ranks that split
    ``axis``."""
    values, scales = quantize_int8(w, axis, reduce)
    deq = (values.float() * scales).to(w.dtype)
    return w + (deq - w).detach()


def matmul(x: torch.Tensor, w: torch.Tensor, quant: str, adt=None,
           reduce: Reduce = None) -> torch.Tensor:
    """The model-side dispatch: ``x[..., K] @ w[K, N]`` under the config's
    ``quant`` mode, returned in ``adt`` (default x.dtype). ``w`` is the fp
    master weight. The quantized products are cast to ``adt`` only after
    their scales; the fp product casts the weight to ``adt`` on use.
    ``reduce`` joins the quantized products' scales over a contraction that
    ranks split (the fp product needs nothing)."""
    adt = adt or x.dtype
    if quant == "int8":
        return int8_matmul_ste(x, w, reduce).to(adt)
    if quant == "fp8":
        return fp8_matmul_ste(x, w, reduce).to(adt)
    return (x @ w.to(adt)).to(adt)


class Dot(NamedTuple):
    """A chunk product for the collective rings (``kernels/collective.py``)
    with its gradients written out: ``forward(x2d, w2d)`` -> fp32,
    ``dx(g, w, dtype)`` and ``dw(x2d, g)`` (fp32) for the fp32 gradient
    ``g`` of the product."""

    forward: Callable
    dx: Callable
    dw: Callable


def _ste_dx(g: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (g @ w.float().t()).to(dtype)


def _ste_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return x.float().t() @ g


# The rings' quantized partials: each chunk quantized with its own scales
# (per row and per output channel of the chunk), straight-through gradients.
INT8_DOT = Dot(int8_matmul, _ste_dx, _ste_dw)
FP8_DOT = Dot(fp8_matmul, _ste_dx, _ste_dw)


def supports_fp8(device: torch.device) -> bool:
    """fp8 products run on the CPU (the exact products, upcast) and on
    cards of compute capability 8.9 or higher (fp8 tensor cores)."""
    device = torch.device(device)
    return device.type == "cpu" or torch.cuda.get_device_capability(device) >= (8, 9)


def fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` with ``w`` cast to x's dtype, fp32 sums and
    an fp32 result, never rounded to x's dtype. On an fp32 ``x`` a plain
    fp32 matmul. On a bf16 ``x`` on the card ``torch.mm(...,
    out_dtype=torch.float32)``: bf16 operands, fp32 accumulation and an fp32
    output. On the CPU, where that overload does not exist, both operands
    are upcast to fp32, which gives the same exact products and an fp32
    sum."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        acc = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return acc.reshape(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def weight_only_matmul(
    x: torch.Tensor,        # [..., K] activation dtype
    values: torch.Tensor,   # [K, N] int8 or fp8
    scales: torch.Tensor,   # [1, N] fp32
) -> torch.Tensor:
    """Serve path: dequantize on use, fp32 accumulation; returns fp32.

    The rounding order is the JAX package's: the product stays fp32
    (``fp32_product``) and is scaled before any cast, so a bf16 caller
    rounds once, after the scale. ``values.to(x.dtype)`` is exact for int8
    and fp8 (both fit bf16)."""
    return fp32_product(x, values) * scales


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
