"""Splash attention: block-sparse flash attention for training, as CUDA
kernels for Hopper, their plain PyTorch versions, and the autograd function
that joins them.

``splash_fwd``, ``splash_bwd_dq`` and ``splash_bwd_dkv`` replace the three
Pallas kernels of ``dstack_tpu/workloads/kernels/splash.py``
(``_splash_fwd_kernel`` through ``_splash_fwd_3d``;
``_splash_bwd_dq_kernel`` and ``_splash_bwd_dkv_kernel`` through
``_splash_bwd_3d``); the source is ``csrc/splash_attention.cu``. Each
wrapper takes the plain version for tensors that lie on the CPU, and
launches its kernel for CUDA tensors or raises; ``launches`` counts the
kernel launches per wrapper. For bf16 inputs at D = 32, 64 and 128 the
forward, dq and dk/dv run on bf16 tensor cores, on the bodies that the
flash kernels run (``csrc/attention_mma_kernels.cuh``) under the band mask,
with fp32 operands split into bf16 terms so that every product stays exact;
fp32 inputs and other head dims run on CUDA cores (``instantiation`` names
what a launch runs).

The mask is causal (key <= query) AND a local window (key > query - window,
the query's own position included; 0 = no window) AND, where document ids
are given, same document. The kernels turn the causal and window bounds
into loop bounds (KV tiles outside a q tile's band are never read; the dk/dv
kernel walks only the transposed band of q tiles) and apply the element
mask inside live tiles. Document ids stay element masks, as in the TPU
kernel. Layout and GQA are ``kernels/flash.py``'s: q3 [B*H, T, D], k3/v3
[B*Kh, S, D]; document ids docq [B, T] and dock [B, S] int32, or None (then
no document plane is read at all). Outputs and gradients are fp32; a row
that sees no key has o = 0, lse = -1e30 and zero gradients. Tiles come from
``kernels/flash.py``'s ``TILE_MENU`` as for flash: explicit blocks, else the
autotune cache's entry for "splash", else the default pair.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Dict, Optional, Tuple

import torch

from dstack_tpu_torch.workloads.kernels import build
from dstack_tpu_torch.workloads.kernels.flash import (
    _DTYPE_CODES,
    DEFAULT_BLOCKS,
    NEG_INF,
    _check,
    _grouped,
    _on_cpu,
    menu_tiles,
    resolve_blocks,
)

# KV positions per step of the plain versions' walk.
_PLAIN_BLOCK = 512

# Kernel launches per wrapper since the last reset; tests and chip_smoke.py
# read these to show which path a run went through.
launches = {"splash_fwd": 0, "splash_bwd_dq": 0, "splash_bwd_dkv": 0}
# The same split by the menu pair each launch ran, and the pair the last
# splash_attention call resolved (as in kernels/flash.py).
pair_launches: Dict[str, Counter] = {name: Counter() for name in launches}
resolved_blocks: Dict[str, Optional[Tuple[int, int]]] = {"splash": None}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        pair_launches[name].clear()


def _count(name: str, blocks: Tuple[int, int]) -> None:
    launches[name] += 1
    pair_launches[name][tuple(blocks)] += 1


# -- the materialized reference -------------------------------------------------


def splash_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Kh, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    doc_ids: Optional[torch.Tensor] = None,  # [B, S] int
) -> torch.Tensor:
    """Materialized attention under the splash mask; fp32 [B, T, H, D].
    O(T*S) memory: the correctness reference and the CPU fallback for
    lengths no block divides. Rows that see no key come out zero."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    n_rep = h // kh
    k = k.float().repeat_interleave(n_rep, dim=2)
    v = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k) * (1.0 / math.sqrt(d))
    q_pos = torch.arange(t, device=q.device)[:, None]
    kv_pos = torch.arange(s_len, device=q.device)[None, :]
    mask = torch.ones((t, s_len), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    mask = mask.expand(b, t, s_len)
    if doc_ids is not None:
        mask = mask & (doc_ids[:, :t, None] == doc_ids[:, None, :s_len])
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, :, None], p, 0.0)
    return torch.einsum("bhts,bshd->bthd", p, v)


# -- plain versions ------------------------------------------------------------


def _doc_rows(doc: Optional[torch.Tensor], bkh: int) -> Optional[torch.Tensor]:
    """[B, L] document ids -> [B*Kh, L]: the row of each KV row's batch
    (KV row g belongs to batch g // Kh)."""
    if doc is None:
        return None
    return doc.repeat_interleave(bkh // doc.shape[0], dim=0)


def _live_blocks(k3, v3, t: int, causal: bool, window: int):
    """(s0, s1, r0, r1, k_blk, v_blk) per KV block: rows outside [r0, r1)
    see nothing of the block (causal: rows before s0; window: rows past the
    last one whose band reaches key s1 - 1) and are left out of its work."""
    s_len = k3.shape[1]
    for s0 in range(0, s_len, _PLAIN_BLOCK):
        s1 = min(s0 + _PLAIN_BLOCK, s_len)
        r0 = s0 if causal else 0
        r1 = min(t, s1 - 1 + window) if window else t
        if r0 < r1:
            yield s0, s1, r0, r1, k3[:, s0:s1].float(), v3[:, s0:s1].float()


def _block_mask(r0, r1, s0, s1, causal, window, docq, dock, device):
    """The element mask of rows [r0, r1) and keys [s0, s1), broadcastable to
    [B*Kh, n_rep, rows, keys]; None when nothing is masked. docq/dock are
    per KV row ([B*Kh, T] / [B*Kh, S]) or None."""
    q_pos = torch.arange(r0, r1, device=device)[:, None]
    kv_pos = torch.arange(s0, s1, device=device)[None, :]
    mask = None
    if causal:
        mask = kv_pos <= q_pos
    if window:
        band = kv_pos > q_pos - window
        mask = band if mask is None else mask & band
    if docq is not None:
        same = docq[:, None, r0:r1, None] == dock[:, None, None, s0:s1]
        return same if mask is None else same & mask
    return mask


def splash_fwd_plain(q3, k3, v3, docq, dock, causal: bool, window: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B*H, T, D] fp32, lse [B*H, T] fp32): the online softmax of
    ``_splash_fwd_kernel`` over the live KV blocks."""
    bh, t, d = q3.shape
    bkh = k3.shape[0]
    scale = 1.0 / (d ** 0.5)
    q = _grouped(q3, bkh)
    docq, dock = _doc_rows(docq, bkh), _doc_rows(dock, bkh)
    o = torch.zeros_like(q)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.full_like(l, NEG_INF)
    for s0, s1, r0, r1, k_blk, v_blk in _live_blocks(k3, v3, t, causal, window):
        s = torch.einsum("grtd,gsd->grts", q[:, :, r0:r1], k_blk) * scale
        mask = _block_mask(r0, r1, s0, s1, causal, window, docq, dock, q.device)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_old = m[:, :, r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1))
        # An all-masked row keeps m_new == NEG_INF; clamp the reference so
        # exp(NEG_INF - NEG_INF) cannot poison l.
        safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
        corr = torch.exp(torch.where(m_old == NEG_INF, NEG_INF, m_old - safe_m))
        p = torch.exp(s - safe_m[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        l[:, :, r0:r1] = l[:, :, r0:r1] * corr + p.sum(-1)
        o[:, :, r0:r1] = (o[:, :, r0:r1] * corr[..., None]
                          + torch.einsum("grts,gsd->grtd", p, v_blk))
        m[:, :, r0:r1] = m_new
    l_safe = torch.clamp(l, min=1e-20)
    lse = torch.where(m == NEG_INF, NEG_INF, m) + torch.log(l_safe)
    return (o / l_safe[..., None]).reshape(bh, t, d), lse.reshape(bh, t)


def _bwd_blocks(q3, k3, v3, do3, lse, delta, docq, dock, causal, window):
    """Per live KV block of the backward walk: (s0, s1, r0, r1, p, ds, k_blk)
    with p = exp(s - lse) (zero on masked keys and on rows whose lse is
    NEG_INF) and ds = p * (dp - delta) * scale, grouped [B*Kh, n_rep, rows,
    keys]."""
    t, d = q3.shape[1], q3.shape[2]
    bkh = k3.shape[0]
    scale = 1.0 / (d ** 0.5)
    q, do = _grouped(q3, bkh), _grouped(do3, bkh)
    lse, delta = _grouped(lse, bkh), _grouped(delta, bkh)
    docq, dock = _doc_rows(docq, bkh), _doc_rows(dock, bkh)
    live = lse != NEG_INF
    lse_safe = torch.where(live, lse, 0.0)
    for s0, s1, r0, r1, k_blk, v_blk in _live_blocks(k3, v3, t, causal, window):
        s = torch.einsum("grtd,gsd->grts", q[:, :, r0:r1], k_blk) * scale
        p = torch.where(live[:, :, r0:r1, None],
                        torch.exp(s - lse_safe[:, :, r0:r1, None]), 0.0)
        mask = _block_mask(r0, r1, s0, s1, causal, window, docq, dock, q.device)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = torch.einsum("grtd,gsd->grts", do[:, :, r0:r1], v_blk)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        yield s0, s1, r0, r1, p, ds, k_blk


def splash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, docq, dock, causal: bool,
                        window: int) -> torch.Tensor:
    """dq [B*H, T, D] fp32 of ``_splash_bwd_dq_kernel``: ds @ k summed over
    the live KV blocks."""
    bh, t, d = q3.shape
    bkh = k3.shape[0]
    dq = torch.zeros((bkh, bh // bkh, t, d), dtype=torch.float32, device=q3.device)
    for _, _, r0, r1, _, ds, k_blk in _bwd_blocks(q3, k3, v3, do3, lse, delta, docq, dock,
                                                  causal, window):
        dq[:, :, r0:r1] += torch.einsum("grts,gsd->grtd", ds, k_blk)
    return dq.reshape(bh, t, d)


def splash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, docq, dock, causal: bool,
                         window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B*Kh, S, D] fp32 of ``_splash_bwd_dkv_kernel``: each KV
    block sums p^T @ do and ds^T @ q over the n_rep query heads of its KV
    row and the rows of its transposed band, in fp64 and rounded to fp32
    once (as ``flash.flash_bwd_dkv_plain``, whose docstring says why)."""
    bkh = k3.shape[0]
    q, do = _grouped(q3, bkh).double(), _grouped(do3, bkh).double()
    dk = torch.zeros(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.zeros_like(dk)
    for s0, s1, r0, r1, p, ds, _ in _bwd_blocks(q3, k3, v3, do3, lse, delta, docq, dock,
                                                causal, window):
        dv[:, s0:s1] = torch.einsum("grts,grtd->gsd", p.double(), do[:, :, r0:r1]).float()
        dk[:, s0:s1] = torch.einsum("grts,grtd->gsd", ds.double(), q[:, :, r0:r1]).float()
    return dk, dv


# -- the CUDA kernels ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    lib = build.load("splash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B, BH, BKh, T, S, D, causal, window, scale, tile, stream
    shape = [i32, i32, i32, i32, i32, i32, i32, i32, f32, i32, ptr]
    lib.splash_fwd_launch.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, *shape]
    lib.splash_bwd_dq_launch.argtypes = [i32, *[ptr] * 9, *shape]
    lib.splash_bwd_dkv_launch.argtypes = [i32, *[ptr] * 10, *shape]
    for fn in (lib.splash_fwd_launch, lib.splash_bwd_dq_launch, lib.splash_bwd_dkv_launch):
        fn.restype = i32
    lib.splash_attention_error_string.argtypes = [i32]
    lib.splash_attention_error_string.restype = ctypes.c_char_p
    lib.splash_instantiation.argtypes = [i32, i32, i32]
    lib.splash_instantiation.restype = ctypes.c_char_p
    return lib


def instantiation(name: str, dtype: torch.dtype, d: int) -> str:
    """What a launch of wrapper ``name`` runs on the card for inputs of
    ``dtype`` and head dim ``d``, as the library's dispatch decides it (the
    kernel, its route and its mma work a live pair). Builds the library."""
    which = ("splash_fwd", "splash_bwd_dq", "splash_bwd_dkv").index(name)
    desc = _library().splash_instantiation(which, _DTYPE_CODES[dtype], d)
    if desc is None:
        raise ValueError(f"{name}: no kernel for {dtype} at D={d}")
    return f"{desc.decode()}, D={d}"


def _check_docs(q3, k3, docq, dock) -> None:
    """Raise on document planes the kernels do not take: both or neither,
    int32 [B, T] and [B, S] on the kernels' device, B dividing B*H and
    B*Kh."""
    if (docq is None) != (dock is None):
        raise ValueError("splash attention kernel: docq and dock come together or not at all")
    if docq is None:
        return
    b = docq.shape[0] if docq.dim() == 2 else 0
    if (docq.dim() != 2 or dock.dim() != 2 or b == 0 or dock.shape[0] != b
            or docq.shape[1] != q3.shape[1] or dock.shape[1] != k3.shape[1]
            or q3.shape[0] % b or k3.shape[0] % b):
        raise ValueError(
            f"splash attention kernel: docq [B, T] and dock [B, S] with B dividing B*H and B*Kh"
            f" expected, got {tuple(docq.shape)}, {tuple(dock.shape)}"
        )
    for x in (docq, dock):
        if x.dtype != torch.int32 or x.device != q3.device or not x.is_contiguous():
            raise ValueError("splash attention kernel: doc ids must be contiguous int32 on the"
                             " kernels' device")


def _args(q3, k3, docq, dock, causal: bool, window: int, tile: int):
    """(docq ptr, dock ptr) and the shape arguments; null pointers and B = 1
    without documents (the kernels then read no document plane). ``tile``:
    the tensor-core kernel's tile edge."""
    bh, t, d = q3.shape
    bkh, s_len, _ = k3.shape
    ptrs = (None, None) if docq is None else (docq.data_ptr(), dock.data_ptr())
    b = 1 if docq is None else docq.shape[0]
    return ptrs, (b, bh, bkh, t, s_len, d, int(causal), int(window), 1.0 / math.sqrt(d),
                  tile, torch.cuda.current_stream(q3.device).cuda_stream)


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.splash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def splash_fwd(q3, k3, v3, docq, dock, causal: bool, window: int,
               blocks: Tuple[int, int] = DEFAULT_BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B*H, T, D] fp32, lse [B*H, T] fp32); ``blocks`` a TILE_MENU pair."""
    if _on_cpu(q3, k3, v3):
        return splash_fwd_plain(q3, k3, v3, docq, dock, causal, window)
    _check(q3, k3, v3, what="splash attention kernel")
    _check_docs(q3, k3, docq, dock)
    bh, t, d = q3.shape
    o = torch.empty((bh, t, d), dtype=torch.float32, device=q3.device)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q3.device)
    lib = _library()
    docs, shape = _args(q3, k3, docq, dock, causal, window, menu_tiles(blocks).fwd[1])
    rc = lib.splash_fwd_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), *docs,
        o.data_ptr(), lse.data_ptr(), *shape,
    )
    _raise_on(rc, lib, "splash fwd")
    _count("splash_fwd", blocks)
    return o, lse


def splash_bwd_dq(q3, k3, v3, do3, lse, delta, docq, dock, causal: bool, window: int,
                  blocks: Tuple[int, int] = DEFAULT_BLOCKS) -> torch.Tensor:
    """dq [B*H, T, D] fp32 from do (fp32), lse and delta = rowsum(do * o)."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return splash_bwd_dq_plain(q3, k3, v3, do3, lse, delta, docq, dock, causal, window)
    _check(q3, k3, v3, do3, lse, delta, what="splash attention kernel")
    _check_docs(q3, k3, docq, dock)
    dq = torch.empty(q3.shape, dtype=torch.float32, device=q3.device)
    lib = _library()
    docs, shape = _args(q3, k3, docq, dock, causal, window, menu_tiles(blocks).dq[1])
    rc = lib.splash_bwd_dq_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *docs, dq.data_ptr(), *shape,
    )
    _raise_on(rc, lib, "splash bwd dq")
    _count("splash_bwd_dq", blocks)
    return dq


def splash_bwd_dkv(q3, k3, v3, do3, lse, delta, docq, dock, causal: bool, window: int,
                   blocks: Tuple[int, int] = DEFAULT_BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B*Kh, S, D] fp32."""
    if _on_cpu(q3, k3, v3, do3, lse, delta):
        return splash_bwd_dkv_plain(q3, k3, v3, do3, lse, delta, docq, dock, causal, window)
    _check(q3, k3, v3, do3, lse, delta, what="splash attention kernel")
    _check_docs(q3, k3, docq, dock)
    dk = torch.empty(k3.shape, dtype=torch.float32, device=k3.device)
    dv = torch.empty(k3.shape, dtype=torch.float32, device=k3.device)
    lib = _library()
    docs, shape = _args(q3, k3, docq, dock, causal, window, menu_tiles(blocks).dkv[0])
    rc = lib.splash_bwd_dkv_launch(
        _DTYPE_CODES[q3.dtype], q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *docs, dk.data_ptr(), dv.data_ptr(), *shape,
    )
    _raise_on(rc, lib, "splash bwd dk/dv")
    _count("splash_bwd_dkv", blocks)
    return dk, dv


# -- autograd on the [B*H, T, D] layout ------------------------------------------


class _Splash3d(torch.autograd.Function):
    """o = splash(q3, k3, v3): the forward kernel, then the dq and dk/dv
    kernels on the residuals, as ``_splash_3d``'s custom VJP. Gradients come
    back in the inputs' dtypes; the document ids get none."""

    @staticmethod
    def forward(ctx, q3, k3, v3, docq, dock, causal, window, blocks):
        o, lse = splash_fwd(q3, k3, v3, docq, dock, causal, window, blocks)
        ctx.save_for_backward(q3, k3, v3, o, lse, docq, dock)
        ctx.causal, ctx.window, ctx.blocks = causal, window, blocks
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, lse, docq, dock = ctx.saved_tensors
        do3 = do3.float().contiguous()
        delta = (do3 * o).sum(-1)
        args = (q3, k3, v3, do3, lse, delta, docq, dock, ctx.causal, ctx.window, ctx.blocks)
        dq = splash_bwd_dq(*args)
        dk, dv = splash_bwd_dkv(*args)
        return (dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype), None, None, None, None,
                None)


def splash_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Kh, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    doc_ids: Optional[torch.Tensor] = None,  # [B, max(T, S)] int
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Block-sparse flash attention with a backward; returns fp32
    [B, T, H, D]. ``window`` > 0 restricts each query to the last ``window``
    positions (its own included) and needs ``causal``; ``doc_ids`` adds a
    same-document mask. The CUDA kernels tile by their own edge, so CUDA
    tensors take any length, and run the menu pair ``resolve_blocks`` picks;
    CPU tensors keep the JAX kernel's contract, a ValueError when the blocks
    (given, tuned or the largest that divides) do not divide the lengths."""
    b, t, h, d = q.shape
    s_len, kh = k.shape[1], k.shape[2]
    if window and not causal:
        raise ValueError("splash window masks are causal bands; "
                         "window > 0 requires causal=True")
    blocks = resolve_blocks("splash", t, s_len, d, q.device, block_q, block_k)
    resolved_blocks["splash"] = blocks
    q3 = q.transpose(1, 2).reshape(b * h, t, d).contiguous()
    k3 = k.transpose(1, 2).reshape(b * kh, s_len, d).contiguous()
    v3 = v.transpose(1, 2).reshape(b * kh, s_len, d).contiguous()
    docq = dock = None
    if doc_ids is not None:
        docq = doc_ids[:, :t].to(torch.int32).contiguous()
        dock = doc_ids[:, :s_len].to(torch.int32).contiguous()
    o3 = _Splash3d.apply(q3, k3, v3, docq, dock, causal, int(window), blocks)
    return o3.reshape(b, h, t, d).transpose(1, 2)
