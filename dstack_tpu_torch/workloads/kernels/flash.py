"""Flash attention for training: CUDA kernels for Hopper, their plain PyTorch
versions, and the autograd function that joins them.

``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace the three
Pallas kernels of ``dstack_tpu/workloads/kernels/flash.py`` (``_fwd_kernel``
through ``_flash_fwd_3d``; ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
through ``_flash_bwd_3d``); the source is ``csrc/flash_attention.cu``. Each
wrapper takes the plain version for tensors that lie on the CPU, and
launches its kernel for CUDA tensors or raises; ``launches`` counts the
kernel launches per wrapper. All three run on bf16 tensor cores for bf16
inputs at D = 32, 64 and 128, with fp32 operands split into bf16 terms so
that every product stays exact; fp32 inputs and other head dims run on CUDA
cores (``instantiation`` names what a launch runs).

Tiles. A (block_q, block_kv) pair of ``TILE_MENU`` sets the tile of each
tensor-core kernel: the wrappers pass each kernel its tile edge, and the
library returns an error for an edge it is not built at. ``DEFAULT_BLOCKS``
runs the tiles the kernels had before the menu.
``flash_attention`` takes explicit blocks, else the autotune cache's entry
for this card, head dim and length (``kernels/autotune.py``), else the
default. The CUDA-core kernels keep their own tiles whatever the pair. On
the CPU the blocks keep the JAX kernel's contract (they must divide the
lengths) and the plain versions compute the same result at every pair.

Layout is the Pallas kernels': q3 [B*H, T, D], k3/v3 [B*Kh, S, D], with the
query heads of one KV head adjacent (row b*H + g*n_rep + r reads KV row
(b*H + g*n_rep + r) // n_rep), so GQA never copies K or V. Outputs are fp32:
o [B*H, T, D] and the logsumexp lse [B*H, T]; gradients dq, dk, dv fp32.
Causal masking compares row index with key index from 0 on both sides.

The plain versions keep the Pallas kernels' exact semantics (scale
1/sqrt(D); masked scores -1e30; the NEG_INF-safe running max; output
o / max(l, 1e-20); lse = -1e30 on a fully masked row and zero gradients
there) and walk K/V in blocks, so the [T, S] scores are never whole.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dstack_tpu_torch.workloads.kernels import autotune, build

NEG_INF = -1e30

# Block edges the public wrapper accepts, largest first (the JAX kernel's
# menu): a sequence length must divide one of them.
_BLOCKS = (512, 256, 128, 64, 32, 16, 8)

# KV positions per step of the plain versions' walk.
_PLAIN_BLOCK = 512


class Tiles(NamedTuple):
    """The tensor-core tiles of one menu pair, each (q rows, keys): the
    forward's streamed K/V tile, dq's, and dk/dv's q step over its KV block."""

    fwd: Tuple[int, int]
    dq: Tuple[int, int]
    dkv: Tuple[int, int]


# (block_q, block_kv) -> tiles. Forward and dq blocks own 64 q rows and dk/dv
# blocks 64 keys at every pair (4 warps of 16 a block); the pair sets the
# rest. (64, 64) holds the tiles of the kernels before the menu and is the
# default; (64, 32) halves the forward's K/V tile; (128, 64) doubles dq's
# K/V tile (32 -> 64 keys) and dk/dv's q step; (32, 32) halves all three.
TILE_MENU: Dict[Tuple[int, int], Tiles] = {
    (64, 64): Tiles(fwd=(64, 64), dq=(64, 32), dkv=(32, 64)),
    (64, 32): Tiles(fwd=(64, 32), dq=(64, 32), dkv=(32, 64)),
    (128, 64): Tiles(fwd=(64, 64), dq=(64, 64), dkv=(64, 64)),
    (32, 32): Tiles(fwd=(64, 32), dq=(64, 16), dkv=(16, 64)),
}
DEFAULT_BLOCKS = (64, 64)

# Kernel launches per wrapper since the last reset, and the same split by
# the menu pair each launch ran; tests and chip_smoke.py read these to show
# which path, and which tiles, a run went through.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
pair_launches: Dict[str, Counter] = {name: Counter() for name in launches}
# The (block_q, block_kv) that the last flash_attention call resolved, on
# either device.
resolved_blocks: Dict[str, Optional[Tuple[int, int]]] = {"flash": None}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        pair_launches[name].clear()


def resolve_blocks(kernel: str, t: int, s_len: int, d: int, device: torch.device,
                   block_q: Optional[int] = None, block_k: Optional[int] = None
                   ) -> Tuple[int, int]:
    """The (block_q, block_kv) a ``kernel`` ("flash" or "splash") call runs.

    Off the CPU (CUDA; any other device then fails in the wrappers):
    explicit blocks, else the autotune cache's entry for this card, head dim
    and max(T, S) when it is a menu pair, else DEFAULT_BLOCKS; a pair off
    the menu raises. On the CPU, JAX's contract: explicit blocks, else the
    cache's entry where it divides the lengths, else the largest block that
    divides them; a ValueError when the blocks do not divide."""
    bq, bk = block_q, block_k
    if device.type != "cpu":
        base = DEFAULT_BLOCKS
        if bq is None or bk is None:
            tuned = autotune.lookup(kernel, d, max(t, s_len),
                                    gen=autotune.generation_of(device))
            if tuned in TILE_MENU:
                base = tuned
        pair = (base[0] if bq is None else bq, base[1] if bk is None else bk)
        if pair not in TILE_MENU:
            raise ValueError(
                f"{kernel} attention on CUDA: blocks {pair} are not on the tile menu"
                f" {sorted(TILE_MENU)}"
            )
        return pair
    if bq is None or bk is None:
        tuned = autotune.lookup(kernel, d, max(t, s_len), gen="cpu")
        if tuned is not None:
            if bq is None and t % tuned[0] == 0:
                bq = tuned[0]
            if bk is None and s_len % tuned[1] == 0:
                bk = tuned[1]
        bq = bq or pick_flash_block(t)
        bk = bk or pick_flash_block(s_len)
    if bq is None or bk is None or t % bq or s_len % bk:
        raise ValueError(
            f"{kernel} attention needs block-divisible sequence lengths; "
            f"T={t} S={s_len} have no usable block (pass attn_impl=xla "
            f"or pad the sequence)"
        )
    return bq, bk


def pick_flash_block(seq_len: int, cap: int = 512) -> Optional[int]:
    """Largest candidate block <= cap that divides seq_len (None when none
    does, e.g. a prime length: flash cannot run)."""
    for b in _BLOCKS:
        if b <= cap and seq_len >= b and seq_len % b == 0:
            return b
    return None


# -- plain versions ------------------------------------------------------------


def _grouped(x3: torch.Tensor, bkh: int) -> torch.Tensor:
    """[B*H, T, ...] fp32 -> [B*Kh, n_rep, T, ...]: the query rows of one KV
    row side by side."""
    return x3.float().reshape(bkh, x3.shape[0] // bkh, *x3.shape[1:])


def _kv_blocks(k3: torch.Tensor, v3: torch.Tensor, t: int, causal: bool):
    """(s0, s1, r0, k_blk, v_blk) per KV block; under causal masking rows
    before r0 = s0 see nothing of the block and are left out of its work."""
    s_len = k3.shape[1]
    for s0 in range(0, s_len, _PLAIN_BLOCK):
        r0 = s0 if causal else 0
        if r0 >= t:
            return
        s1 = min(s0 + _PLAIN_BLOCK, s_len)
        yield s0, s1, r0, k3[:, s0:s1].float(), v3[:, s0:s1].float()


def _causal_mask(r0: int, t: int, s0: int, s1: int, device) -> torch.Tensor:
    """[t - r0, s1 - s0]: key position <= query position."""
    return (
        torch.arange(s0, s1, device=device)[None, :]
        <= torch.arange(r0, t, device=device)[:, None]
    )


def flash_fwd_plain(
    q3: torch.Tensor, k3: torch.Tensor, v3: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B*H, T, D] fp32, lse [B*H, T] fp32): the online softmax of
    ``_fwd_kernel`` over KV blocks."""
    bh, t, d = q3.shape
    bkh = k3.shape[0]
    scale = 1.0 / (d ** 0.5)
    q = _grouped(q3, bkh)
    o = torch.zeros_like(q)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.full_like(l, NEG_INF)
    for s0, s1, r0, k_blk, v_blk in _kv_blocks(k3, v3, t, causal):
        s = torch.einsum("grtd,gsd->grts", q[:, :, r0:], k_blk) * scale
        if causal:
            mask = _causal_mask(r0, t, s0, s1, q.device)
            s = torch.where(mask, s, NEG_INF)
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, s.amax(-1))
        # An all-masked row keeps m_new == NEG_INF; clamp the reference so
        # exp(NEG_INF - NEG_INF) cannot poison l.
        safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
        corr = torch.exp(torch.where(m_old == NEG_INF, NEG_INF, m_old - safe_m))
        p = torch.exp(s - safe_m[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(-1)
        o[:, :, r0:] = o[:, :, r0:] * corr[..., None] + torch.einsum("grts,gsd->grtd", p, v_blk)
        m[:, :, r0:] = m_new
    l_safe = torch.clamp(l, min=1e-20)
    lse = torch.where(m == NEG_INF, NEG_INF, m) + torch.log(l_safe)
    return (o / l_safe[..., None]).reshape(bh, t, d), lse.reshape(bh, t)


def _bwd_blocks(q3, k3, v3, do3, lse, delta, causal):
    """Per KV block of the backward walk: (s0, s1, r0, p, ds, k_blk) with
    p = exp(s - lse) (zero on masked keys and on rows whose lse is NEG_INF)
    and ds = p * (dp - delta) * scale, grouped [B*Kh, n_rep, T - r0, block]."""
    bh, t, d = q3.shape
    bkh = k3.shape[0]
    scale = 1.0 / (d ** 0.5)
    q, do = _grouped(q3, bkh), _grouped(do3, bkh)
    lse, delta = _grouped(lse, bkh), _grouped(delta, bkh)
    live = lse != NEG_INF
    lse_safe = torch.where(live, lse, 0.0)
    for s0, s1, r0, k_blk, v_blk in _kv_blocks(k3, v3, t, causal):
        s = torch.einsum("grtd,gsd->grts", q[:, :, r0:], k_blk) * scale
        p = torch.where(
            live[:, :, r0:, None], torch.exp(s - lse_safe[:, :, r0:, None]), 0.0
        )
        if causal:
            p = torch.where(_causal_mask(r0, t, s0, s1, q.device), p, 0.0)
        dp = torch.einsum("grtd,gsd->grts", do[:, :, r0:], v_blk)
        ds = p * (dp - delta[:, :, r0:, None]) * scale
        yield s0, s1, r0, p, ds, k_blk


def flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, causal: bool) -> torch.Tensor:
    """dq [B*H, T, D] fp32 of ``_bwd_dq_kernel``: sum over KV blocks of
    ds @ k."""
    bh, t, d = q3.shape
    dq = torch.zeros((k3.shape[0], bh // k3.shape[0], t, d), dtype=torch.float32,
                     device=q3.device)
    for _, _, r0, _, ds, k_blk in _bwd_blocks(q3, k3, v3, do3, lse, delta, causal):
        dq[:, :, r0:] += torch.einsum("grts,gsd->grtd", ds, k_blk)
    return dq.reshape(bh, t, d)


def flash_bwd_dkv_plain(
    q3, k3, v3, do3, lse, delta, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B*Kh, S, D] fp32 of ``_bwd_dkv_kernel``: each KV block sums
    p^T @ do and ds^T @ q over the n_rep query heads of its KV row.

    Those sums run over up to n_rep x T products of fp32 values, and they
    are taken in fp64 (rounded to fp32 once, at the end): summed by fp32
    GEMMs over the 16,384 queries of a llama3_1b KV head at T 8192, they
    drift from the exact sums by about twice the kernels' tolerance on an
    H100. ``chip_smoke.py`` holds these sums, and the kernel, to that
    tolerance against an fp64 computation and prints the fp32 drift."""
    bkh = k3.shape[0]
    q, do = _grouped(q3, bkh).double(), _grouped(do3, bkh).double()
    dk = torch.zeros(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.zeros_like(dk)
    for s0, s1, r0, p, ds, _ in _bwd_blocks(q3, k3, v3, do3, lse, delta, causal):
        dv[:, s0:s1] = torch.einsum("grts,grtd->gsd", p.double(), do[:, :, r0:]).float()
        dk[:, s0:s1] = torch.einsum("grts,grtd->gsd", ds.double(), q[:, :, r0:]).float()
    return dk, dv


# -- the CUDA kernels ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    lib = build.load("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # BH, BKh, T, S, D, causal, scale, tile, stream
    shape = [i32, i32, i32, i32, i32, i32, f32, i32, ptr]
    lib.flash_fwd_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, *shape]
    lib.flash_bwd_dq_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, *shape]
    lib.flash_bwd_dkv_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, *shape]
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_dq_launch, lib.flash_bwd_dkv_launch):
        fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_instantiation.argtypes = [i32, i32, i32]
    lib.flash_instantiation.restype = ctypes.c_char_p
    return lib


def instantiation(name: str, dtype: torch.dtype, d: int) -> str:
    """What a launch of wrapper ``name`` runs on the card for inputs of
    ``dtype`` and head dim ``d``, as the library's dispatch decides it (the
    kernel, its route and its mma work a live pair). Builds the library."""
    which = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").index(name)
    desc = _library().flash_instantiation(which, _DTYPE_CODES[dtype], d)
    if desc is None:
        raise ValueError(f"{name}: no kernel for {dtype} at D={d}")
    return f"{desc.decode()}, D={d}"


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(q3, k3, v3, do3=None, lse=None, delta=None, what="flash attention kernel") -> None:
    """Raise on anything the kernels do not take (``what`` names them)."""
    tensors = [t for t in (q3, k3, v3, do3, lse, delta) if t is not None]
    dev = q3.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every tensor must be on one CUDA device")
    if q3.dtype not in _DTYPE_CODES or k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise ValueError(
            f"{what}: q, k and v must share float32 or bfloat16,"
            f" got {q3.dtype}/{k3.dtype}/{v3.dtype}"
        )
    if any(t.dtype != torch.float32 for t in (do3, lse, delta) if t is not None):
        raise ValueError(f"{what}: do, lse and delta must be float32")
    if q3.dim() != 3 or k3.dim() != 3 or k3.shape != v3.shape:
        raise ValueError(
            f"{what}: q [B*H, T, D] and k, v [B*Kh, S, D] expected,"
            f" got {tuple(q3.shape)}, {tuple(k3.shape)}, {tuple(v3.shape)}"
        )
    bh, t, d = q3.shape
    bkh, _, dk = k3.shape
    if dk != d or d % 32 or d > 256:
        raise ValueError(f"{what}: D must be a multiple of 32 up to 256, got {d}")
    if bkh == 0 or bh % bkh:
        raise ValueError(f"{what}: B*H={bh} must be a multiple of B*Kh={bkh}")
    if do3 is not None and do3.shape != q3.shape:
        raise ValueError(f"{what}: do must match q")
    if any(x is not None and x.shape != (bh, t) for x in (lse, delta)):
        raise ValueError(f"{what}: lse and delta must be [B*H, T]")
    if any(not x.is_contiguous() for x in tensors):
        raise ValueError(f"{what}: every tensor must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"{what}: every tensor must be 16-byte aligned")


def menu_tiles(blocks: Tuple[int, int]) -> Tiles:
    """The tiles of a menu pair; a ValueError for a pair off the menu."""
    tiles = TILE_MENU.get(tuple(blocks))
    if tiles is None:
        raise ValueError(f"blocks {tuple(blocks)} are not on the tile menu {sorted(TILE_MENU)}")
    return tiles


def _shape_args(q3, k3, causal: bool, tile: int):
    """The launch functions' shape arguments; ``tile`` is the tensor-core
    kernel's tile edge (the library returns an error for one it is not
    built at)."""
    bh, t, d = q3.shape
    bkh, s_len, _ = k3.shape
    return (bh, bkh, t, s_len, d, int(causal), 1.0 / math.sqrt(d), tile,
            torch.cuda.current_stream(q3.device).cuda_stream)


def _count(name: str, blocks: Tuple[int, int]) -> None:
    launches[name] += 1
    pair_launches[name][tuple(blocks)] += 1


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def flash_fwd(q3, k3, v3, causal: bool, blocks: Tuple[int, int] = DEFAULT_BLOCKS
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B*H, T, D] fp32, lse [B*H, T] fp32); ``blocks`` a TILE_MENU pair."""
    if _on_cpu(q3, k3, v3):
        return flash_fwd_plain(q3, k3, v3, causal)
    _check(q3, k3, v3)
    bh, t, d = q3.shape
    o = torch.empty((bh, t, d), dtype=torch.float32, device=q3.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    lib = _library()
    rc = lib.flash_fwd_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        o.data_ptr(), lse.data_ptr(),
        *_shape_args(q3, k3, causal, menu_tiles(blocks).fwd[1]),
    )
    _raise_on(rc, lib, "flash fwd")
    _count("flash_fwd", blocks)
    return o, lse


def flash_bwd_dq(q3, k3, v3, do3, lse, delta, causal: bool,
                 blocks: Tuple[int, int] = DEFAULT_BLOCKS) -> torch.Tensor:
    """dq [B*H, T, D] fp32 from do (fp32), lse and delta = rowsum(do * o)."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return flash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, causal)
    _check(q3, k3, v3, do3, lse, delta)
    dq = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    lib = _library()
    rc = lib.flash_bwd_dq_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        do3.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_shape_args(q3, k3, causal, menu_tiles(blocks).dq[1]),
    )
    _raise_on(rc, lib, "flash bwd dq")
    _count("flash_bwd_dq", blocks)
    return dq


def flash_bwd_dkv(q3, k3, v3, do3, lse, delta, causal: bool,
                  blocks: Tuple[int, int] = DEFAULT_BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B*Kh, S, D] fp32."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return flash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, causal)
    _check(q3, k3, v3, do3, lse, delta)
    dk = torch.empty(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.empty(k3.shape, dtype=torch.float32, device=k3.device)
    lib = _library()
    rc = lib.flash_bwd_dkv_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        do3.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q3, k3, causal, menu_tiles(blocks).dkv[0]),
    )
    _raise_on(rc, lib, "flash bwd dk/dv")
    _count("flash_bwd_dkv", blocks)
    return dk, dv


# -- autograd on the [B*H, T, D] layout ------------------------------------------


class _Flash3d(torch.autograd.Function):
    """o = flash(q3, k3, v3): the forward kernel, then the dq and dk/dv
    kernels on the residuals (q3, k3, v3, o, lse), as ``_flash_3d``'s custom
    VJP. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q3, k3, v3, causal, blocks):
        o, lse = flash_fwd(q3, k3, v3, causal, blocks)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.causal, ctx.blocks = causal, blocks
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse = ctx.saved_tensors
        do3 = do3.float().contiguous()
        delta = (do3 * o).sum(-1)
        dq = flash_bwd_dq(q3, k3, v3, do3, lse, delta, ctx.causal, ctx.blocks)
        dk, dv = flash_bwd_dkv(q3, k3, v3, do3, lse, delta, ctx.causal, ctx.blocks)
        return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype), None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Kh, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Fused flash attention with a backward; returns fp32 [B, T, H, D] (the
    blockwise contract). The CUDA kernels tile by their own edge and mask a
    ragged last tile, so CUDA tensors take any length, and run the menu pair
    ``resolve_blocks`` picks. CPU tensors keep the JAX kernel's contract: a
    ValueError when the blocks (given, tuned or the largest that divides) do
    not divide the sequence lengths."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    blocks = resolve_blocks("flash", t, s_len, d, q.device, block_q, block_k)
    resolved_blocks["flash"] = blocks
    # GQA: q rows of one KV head are adjacent after the reshape (row
    # b*h + g*n_rep + r floors to KV row b*kh + g under // n_rep).
    q3 = q.transpose(1, 2).reshape(b * h, t, d).contiguous()
    k3 = k.transpose(1, 2).reshape(b * kh, s_len, d).contiguous()
    v3 = v.transpose(1, 2).reshape(b * kh, s_len, d).contiguous()
    o3 = _Flash3d.apply(q3, k3, v3, causal, blocks)
    return o3.reshape(b, h, t, d).transpose(1, 2)
