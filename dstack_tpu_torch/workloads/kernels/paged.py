"""Paged attention kernels of the serving engine: CUDA for Hopper, with their
plain PyTorch versions.

``paged_decode_attention_cuda`` and ``paged_chunk_attention_cuda`` replace
the Pallas kernels ``paged_decode_attention_pallas`` and
``paged_chunk_attention_pallas`` of ``dstack_tpu/workloads/kernels/paged.py``
(source: ``csrc/paged_attention.cu``). Each wrapper takes the plain version
for tensors that lie on the CPU, and launches its kernel for CUDA tensors or
raises; ``launches`` counts the calls that launched their kernels. Decode
splits each slot's positions across blocks (split-KV) and joins the splits'
partial softmaxes in a second, small kernel of the same call; its
arithmetic is fp32 on CUDA cores at every type and head dim. The chunk walk
runs on bf16 tensor cores for bf16 q and pages at D = 32, 64 and 128, with
P split into bf16 terms so that every product stays exact, and on CUDA
cores for fp32 inputs and other head dims (``instantiation`` names what a
launch runs).

The plain versions have the Pallas kernels' exact semantics, which differ
from the gather references in ``attention.py`` in two places: a row that
sees no position (``kv_len == 0``) gives zeros, and the chunk walk masks
``pos < kv_len`` as well as causality.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dstack_tpu_torch.workloads.kernels import build

NEG_INF = -1e30

# Kernel launches per wrapper since the last reset; tests and chip_smoke.py
# read these to show which path a run went through.
launches = {"paged_decode_attention": 0, "paged_chunk_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WARPS = 16  # CUDA-core chunk tile: rows per block = _MAX_WARPS // n_rep
_MAX_SMEM = 232448  # dynamic shared memory one block may use on sm_90
_DECODE_SPLIT = 256  # positions a decode block walks, at least
_MAX_SPLITS = 32  # decode blocks per (slot, KV head), at most


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def decode_split(positions: int) -> int:
    """Positions each block of the split-KV decode kernel walks, for a page
    table of ``positions`` positions: ``_DECODE_SPLIT``, doubled until at
    most ``_MAX_SPLITS`` splits cover the table (blocks whose split starts
    past a slot's kv_len exit at once, but each still takes a slot on the
    card)."""
    split = _DECODE_SPLIT
    while -(-positions // split) > _MAX_SPLITS:
        split *= 2
    return split


def _paged_walk(q, k_pages, v_pages, page_table, starts, kv_lens):
    """q [S, C, H, D]; row i of slot s attends pos <= starts[s] + i and
    pos < kv_lens[s], page by page with the kernels' online softmax; fp32
    [S, C, H, D]."""
    s, c, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    n_rep = h // kh
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(s, c, kh, n_rep, d)
    n_pages = (kv_lens + page - 1).div(page, rounding_mode="floor").clamp(
        max=page_table.shape[1]
    )
    limit = torch.minimum(
        kv_lens[:, None], starts[:, None] + torch.arange(c, device=dev)[None, :] + 1
    )  # [S, C]: row i sees pos < limit
    o = torch.zeros((s, c, kh, n_rep, d), dtype=torch.float32, device=dev)
    l = torch.zeros((s, c, kh, n_rep), dtype=torch.float32, device=dev)
    m = torch.full((s, c, kh, n_rep), NEG_INF, dtype=torch.float32, device=dev)
    for p in range(int(n_pages.max()) if s else 0):
        # Slots past their last page read page 0 and mask it all, as the
        # kernels never read the page at all.
        pid = torch.where(p < n_pages, page_table[:, p], 0).long()
        k_blk = k_pages[pid].float()  # [S, page, Kh, D]
        v_blk = v_pages[pid].float()
        sc = torch.einsum("sckrd,stkd->sckrt", qf, k_blk) * scale
        pos = p * page + torch.arange(page, device=dev)
        valid = (pos[None, None, :] < limit[:, :, None])[:, :, None, None, :]
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        safe_m = torch.where(m_new == NEG_INF, 0.0, m_new)
        corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - safe_m))
        prob = torch.where(valid, torch.exp(sc - safe_m[..., None]), 0.0)
        l = l * corr + prob.sum(-1)
        o = o * corr[..., None] + torch.einsum("sckrt,stkd->sckrd", prob, v_blk)
        m = m_new
    o = o / torch.clamp(l, min=1e-20)[..., None]
    return o.reshape(s, c, h, d)


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_lens):
    """q [S, H, D] -> fp32 [S, H, D]; slot s attends its first kv_lens[s]
    positions (zeros when kv_lens[s] == 0)."""
    kv_lens = kv_lens.long()
    return _paged_walk(
        q[:, None], k_pages, v_pages, page_table, kv_lens - 1, kv_lens
    )[:, 0]


def paged_chunk_attention_plain(q, k_pages, v_pages, page_table, starts, kv_lens):
    """q [S, C, H, D] -> fp32 [S, C, H, D]; query i of slot s at position
    starts[s] + i attends pos <= starts[s] + i and pos < kv_lens[s]."""
    return _paged_walk(
        q, k_pages, v_pages, page_table, starts.long(), kv_lens.long()
    )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never cuts them to 32 bits)."""
    lib = build.load("paged_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_attention_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
    ]
    lib.paged_decode_attention_launch.restype = i32
    lib.paged_chunk_attention_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr,
    ]
    lib.paged_chunk_attention_launch.restype = i32
    lib.paged_attention_error_string.argtypes = [i32]
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.paged_instantiation.argtypes = [i32, i32, i32]
    lib.paged_instantiation.restype = ctypes.c_char_p
    return lib


def instantiation(name: str, dtype: torch.dtype, d: int) -> str:
    """What a launch of wrapper ``name`` runs on the card for inputs of
    ``dtype`` and head dim ``d``, as the library's dispatch decides it (the
    kernel, its route and its mma work a live pair). Builds the library."""
    which = ("paged_decode_attention", "paged_chunk_attention").index(name)
    desc = _library().paged_instantiation(which, _DTYPE_CODES[dtype], d)
    if desc is None:
        raise ValueError(f"{name}: no kernel for {dtype} at D={d}")
    return f"{desc.decode()}, D={d}"


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(q, k_pages, v_pages, page_table, kv_lens, starts=None) -> None:
    tensors = [q, k_pages, v_pages, page_table, kv_lens]
    if starts is not None:
        tensors.append(starts)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged attention kernel: every tensor must be on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(
            f"paged attention kernel: q and pages must share float32 or bfloat16,"
            f" got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    for name, t in (("page_table", page_table), ("kv_lens", kv_lens), ("starts", starts)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"paged attention kernel: {name} must be int32, got {t.dtype}")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged attention kernel: every tensor must be contiguous")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged attention kernel: pages must be [N, page, Kh, D], got"
            f" {tuple(k_pages.shape)} and {tuple(v_pages.shape)}"
        )
    _, page, kh, d = k_pages.shape
    if starts is not None and 4 * page * d * k_pages.element_size() > _MAX_SMEM:
        raise ValueError(
            f"paged chunk kernel: a double-buffered K and V page of {page} x {d}"
            f" {k_pages.dtype} exceeds a block's {_MAX_SMEM} bytes of shared memory"
        )
    h = q.shape[-2]
    if q.shape[-1] != d or d % 32 or d > 256:
        raise ValueError(f"paged attention kernel: D must be a multiple of 32 up to 256, got {d}")
    if h % kh or h // kh > 32:
        raise ValueError(f"paged attention kernel: H={h} must be a multiple of Kh={kh}, at most 32x")
    s = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != s or kv_lens.shape != (s,):
        raise ValueError("paged attention kernel: page_table [S, P] and kv_lens [S] must match q")
    if starts is not None and starts.shape != (s,):
        raise ValueError("paged attention kernel: starts must be [S]")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged attention kernel: q and pages must be 16-byte aligned")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.paged_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, kv_lens):
    """q [S, H, D]; pages [N, page, Kh, D]; page_table [S, P] int32; kv_lens
    [S] int32 -> fp32 [S, H, D]."""
    if _on_cpu(q, k_pages, v_pages, page_table, kv_lens):
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_lens)
    _check(q, k_pages, v_pages, page_table, kv_lens)
    if q.dim() != 3:
        raise ValueError(f"paged decode kernel: q must be [S, H, D], got {tuple(q.shape)}")
    s, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    n_table = page_table.shape[1]
    split = decode_split(n_table * page)
    n_split = -(-n_table * page // split)
    out = torch.empty((s, h, d), dtype=torch.float32, device=q.device)
    # Each split's unnormalised o and (max, sum) per head, read by the
    # combine kernel of the same call.
    ws = (s, kh, n_split, h // kh)
    o_part = torch.empty((*ws, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((*ws, 2), dtype=torch.float32, device=q.device)
    lib = _library()
    rc = lib.paged_decode_attention_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_lens.data_ptr(), out.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), s, h, kh, d, page, n_table, split, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, lib, "paged decode")
    launches["paged_decode_attention"] += 1
    return out


def paged_chunk_attention_cuda(q, k_pages, v_pages, page_table, starts, kv_lens):
    """q [S, C, H, D]; starts, kv_lens [S] int32 -> fp32 [S, C, H, D]."""
    if _on_cpu(q, k_pages, v_pages, page_table, starts, kv_lens):
        return paged_chunk_attention_plain(
            q, k_pages, v_pages, page_table, starts, kv_lens
        )
    _check(q, k_pages, v_pages, page_table, kv_lens, starts)
    if q.dim() != 4:
        raise ValueError(f"paged chunk kernel: q must be [S, C, H, D], got {tuple(q.shape)}")
    s, c, h, d = q.shape
    _, page, kh, _ = k_pages.shape
    tile_rows = max(1, min(c, _MAX_WARPS // (h // kh)))
    out = torch.empty((s, c, h, d), dtype=torch.float32, device=q.device)
    lib = _library()
    rc = lib.paged_chunk_attention_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), starts.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
        s, c, h, kh, d, page, page_table.shape[1], tile_rows, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, lib, "paged chunk")
    launches["paged_chunk_attention"] += 1
    return out
