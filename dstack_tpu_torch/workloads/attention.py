"""Attention: the blockwise (flash-style) core the prefill runs, the training
forward's dispatch, and the gather references of paged attention.

Ports ``dstack_tpu/workloads/attention.py``: ``blockwise_attention`` and its
online-softmax helpers, ``plain_attention``, ``flash_attention_tpu`` (on the
port's flash kernels) and ``attention_core`` (which also routes to the
splash kernels, meshless or on a rank's local heads), and
``paged_decode_attention`` / ``paged_chunk_attention``, the gather references
that the serving engine's ``decode_impl="plain"`` runs, and
``ring_attention``, the sequence-parallel core that ``attention_core`` runs
whenever the mesh splits the sequence (sp > 1). Layouts are the JAX
package's: q [B, T, H, D],
k/v [B, S, Kh, D]; outputs are fp32. Score products take fp32 inputs, which
reproduces the reference's bf16 x bf16 -> fp32 accumulation exactly, since
each bf16 product is exact in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from dstack_tpu_torch.workloads.kernels.flash import flash_attention, pick_flash_block
from dstack_tpu_torch.workloads.kernels.splash import splash_attention, splash_reference

NEG_INF = -1e30

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads. [B,S,Kh,D] -> [B,S,Kh*n_rep,D]."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(b, s, kh * n_rep, d)


def _attn_state_init(q: torch.Tensor) -> State:
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, t, h), dtype=torch.float32, device=q.device)
    m = torch.full((b, t, h), NEG_INF, dtype=torch.float32, device=q.device)
    return o, l, m


def _attn_block_accum(
    state: State,
    q: torch.Tensor,  # [B,Tq,H,D]
    k: torch.Tensor,  # [B,S,H,D] (kv heads already repeated)
    v: torch.Tensor,
    q_positions: torch.Tensor,   # [Tq] global positions
    kv_positions: torch.Tensor,  # [S] global positions
    causal: bool,
    kv_valid: Optional[torch.Tensor] = None,  # [S] bool; False = padded key
) -> State:
    """Online-softmax accumulation of one KV block into the running (o, l, m) state."""
    o, l, m = state
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bthd,bshd->bths", q.float(), k.float()) * scale
    mask = None  # [Tq, S]; padding is masked independently of causality
    if causal:
        mask = kv_positions[None, :] <= q_positions[:, None]
    if kv_valid is not None:
        valid = kv_valid[None, :].expand(q_positions.shape[0], kv_valid.shape[0])
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))  # [B,Tq,H]
    # All-masked blocks (m_new == NEG_INF) must not poison l: clamp the
    # correction instead of exp(NEG_INF - NEG_INF) = 1.
    safe_m_new = torch.where(m_new == NEG_INF, 0.0, m_new)
    corr = torch.exp(torch.where(m == NEG_INF, NEG_INF, m - safe_m_new))
    p = torch.exp(s - safe_m_new[..., None])  # [B,Tq,H,S]
    if mask is not None:
        p = torch.where(mask[None, :, None, :], p, 0.0)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bths,bshd->bthd", p, v.float())
    return o * corr[..., None] + pv, l_new, m_new


def _finalize(state: State) -> torch.Tensor:
    o, l, _ = state
    return o / torch.clamp(l, min=1e-20)[..., None]


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_offset: int = 0,
    block_size: int = 512,
) -> torch.Tensor:
    """Memory-efficient causal attention. q [B,T,H,D]; k,v [B,S,Kh,D]; returns
    fp32 [B,T,H,D]. Walks KV in blocks with an online softmax; the last block
    is padded and its padded keys masked, as in the reference."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    s_len = k.shape[1]
    dev = q.device
    q_pos = q_offset + torch.arange(q.shape[1], device=dev)
    state = _attn_state_init(q)

    if s_len <= block_size:
        kv_pos = kv_offset + torch.arange(s_len, device=dev)
        return _finalize(_attn_block_accum(state, q, k, v, q_pos, kv_pos, causal))

    n_blocks = -(-s_len // block_size)
    pad = n_blocks * block_size - s_len
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    for blk in range(n_blocks):
        sl = slice(blk * block_size, (blk + 1) * block_size)
        rel_pos = blk * block_size + torch.arange(block_size, device=dev)
        kv_valid = rel_pos < s_len  # mask the padded tail regardless of causality
        state = _attn_block_accum(
            state, q, k[:, sl], v[:, sl], q_pos, kv_offset + rel_pos, causal, kv_valid
        )
    return _finalize(state)


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Fully materialized attention. q [B,T,H,D]; k,v [B,S,Kh,D]; returns
    fp32 [B,T,H,D]. Scores are [B,H,T,S]; the softmax weights are rounded to
    q.dtype before the PV product, as in the reference."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    t, s_len = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.arange(s_len, device=q.device)[None, :] <= torch.arange(t, device=q.device)[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", p.float(), v.float())


def flash_available(device: torch.device) -> bool:
    """True where the flash kernels run: tensors on a CUDA device (the
    counterpart of the JAX package's "a real TPU" check)."""
    return torch.device(device).type == "cuda"


def _flash_block(seq_len: int) -> Optional[int]:
    """Largest of (512, 256, 128) that divides seq_len; None when none does
    (the public TPU kernel's block menu)."""
    for b in (512, 256, 128):
        if seq_len >= b and seq_len % b == 0:
            return b
    return None


def flash_attention_tpu(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """The counterpart of the JAX package's call into the public TPU flash
    kernel, on the port's flash kernels: q [B,T,H,D]; k,v [B,S,Kh,D]; returns
    [B,T,H,D] in q.dtype. CUDA tensors run the kernels at every length; on
    the CPU, lengths off the 512/256/128 block menu take the blockwise path
    (fp32 output), as the reference does."""
    if q.device.type == "cpu" and (
        _flash_block(q.shape[1]) is None or _flash_block(k.shape[1]) is None
    ):
        return blockwise_attention(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal).to(q.dtype)


def attention_core(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, Kh, D]
    v: torch.Tensor,
    attn_impl: str,
    mesh=None,
    *,
    causal: bool = True,
    window: int = 0,
    doc_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The one attention dispatch of the training forward.

    - ``auto``: ``flash_tpu`` on a CUDA device, blockwise on the CPU;
    - ``flash``: the flash kernels (``kernels/flash.py``) at every length on
      a CUDA device; on the CPU their plain versions, or blockwise when a
      length is not block-divisible;
    - ``splash``: the block-sparse kernels (``kernels/splash.py``) under
      causal, ``window`` and same-``doc_ids`` masks, at every length on a
      CUDA device; on the CPU their plain versions, or the masked reference
      (``splash_reference``) when a length is not block-divisible. The only
      core that honours ``window`` and ``doc_ids``; the others ignore them;
    - ``flash_tpu``: the public kernel's contract on the same kernels
      (CUDA only; blockwise elsewhere, as the reference off a TPU);
    - ``plain``: materialized scores; ``xla``/``blockwise``: the online-softmax
      walk.

    Under a ``mesh`` q/k/v are this rank's rows and its H/tp query and Kh/tp
    KV heads (whole GQA groups), which the same kernels take as they are;
    ``auto`` and ``flash_tpu`` run blockwise there, as the reference's (the
    public kernel runs meshless only). Sequence parallelism (sp > 1) always
    runs ``ring_attention`` on this rank's sequence chunk, whatever
    ``attn_impl`` says, as the reference's dispatch does.
    """
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        return ring_attention(q, k, v, mesh, causal=causal)
    impl = attn_impl
    if impl == "auto":
        impl = "flash_tpu" if (mesh is None and flash_available(q.device)) else "blockwise"
    off_menu = q.device.type == "cpu" and (
        pick_flash_block(q.shape[1]) is None or pick_flash_block(k.shape[1]) is None
    )
    if impl == "splash":
        if off_menu:
            return splash_reference(q, k, v, causal=causal, window=window, doc_ids=doc_ids)
        return splash_attention(q, k, v, causal=causal, window=window, doc_ids=doc_ids)
    if impl == "flash":
        if off_menu:
            return blockwise_attention(q, k, v, causal=causal)
        return flash_attention(q, k, v, causal=causal)
    if impl == "flash_tpu":
        if mesh is None and flash_available(q.device):
            return flash_attention_tpu(q, k, v, causal=causal)
        return blockwise_attention(q, k, v, causal=causal)
    if impl == "plain":
        return plain_attention(q, k, v, causal=causal)
    return blockwise_attention(q, k, v, causal=causal)


def ring_attention(
    q: torch.Tensor,  # [B, T/sp, H, D]: this rank's chunk of the sequence
    k: torch.Tensor,  # [B, T/sp, Kh, D]
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = True,
    block_size: int = 512,
) -> torch.Tensor:
    """Sequence-parallel attention over the mesh's ``sp`` axis (the JAX
    package's ``ring_attention``): each rank holds one contiguous chunk of
    the sequence, its queries at positions ``chunk * T/sp + i``. The K/V
    chunks go sp times around the sp ring (``collective.ppermute``, whose
    gradient takes the way back), each accumulating into the blockwise
    core's online-softmax state, walked in blocks of ``block_size`` keys;
    when gradients are recorded each block is recomputed in the backward
    pass, so a rank keeps one block's scores at a time, not sp x T/sp /
    block_size of them. Heads stay as the rank holds them (split over tp). Every chunk is
    walked, as in the reference, one wholly in the causal future of this
    rank's queries too (it adds nothing): every rank's backward pass then
    runs the same hops in the same order. Returns [B, T/sp, H, D] in
    q.dtype."""
    from dstack_tpu_torch.workloads.kernels.collective import ppermute

    sp = mesh.shape["sp"]
    if sp == 1:
        return blockwise_attention(q, k, v, causal=causal, block_size=block_size)
    t = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    mine = mesh.index("sp")
    q_pos = mine * t + torch.arange(t, device=q.device)
    state = _attn_state_init(q)
    kv = torch.stack([k, v])
    remat = torch.is_grad_enabled()

    def accum(o, l, m, k_blk, v_blk, kv_pos):
        return _attn_block_accum((o, l, m), q, k_blk, v_blk, q_pos, kv_pos, causal)

    for step in range(sp):
        src = (mine - step) % sp
        k_cur, v_cur = _repeat_kv(kv[0], n_rep), _repeat_kv(kv[1], n_rep)
        for b0 in range(0, t, block_size):
            sl = slice(b0, min(b0 + block_size, t))
            kv_pos = src * t + torch.arange(sl.start, sl.stop, device=q.device)
            args = (*state, k_cur[:, sl], v_cur[:, sl], kv_pos)
            state = (torch.utils.checkpoint.checkpoint(accum, *args, use_reentrant=False)
                     if remat else accum(*args))
        if step + 1 < sp:
            kv = ppermute(kv, mesh, "sp")
    return _finalize(state).to(q.dtype)


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[N, page, Kh, D] pages of each slot's table -> [S, P*page, Kh*n_rep, D]."""
    s, p = page_table.shape
    _, page, kh, d = pages.shape
    dense = pages[page_table.long()].reshape(s, p * page, kh, d)
    return _repeat_kv(dense, n_rep)


def paged_decode_attention(
    q: torch.Tensor,           # [S, H, D] — one query per decode slot
    k_pages: torch.Tensor,     # [N, page, Kh, D] — one layer's page pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, P] page ids into the pool
    kv_lens: torch.Tensor,     # [S] valid KV length per slot (past + current token)
) -> torch.Tensor:
    """Single-query attention over a paged KV cache: each slot gathers its
    pages, then runs a masked softmax over its valid prefix. Returns fp32
    [S, H, D]. Slots with kv_lens == 0 give finite garbage (uniform weights),
    which the engine discards."""
    s, p = page_table.shape
    page = k_pages.shape[1]
    n_rep = q.shape[1] // k_pages.shape[2]
    k = _gather_pages(k_pages, page_table, n_rep)
    v = _gather_pages(v_pages, page_table, n_rep)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("shd,sthd->sht", q.float(), k.float()) * scale
    valid = torch.arange(p * page, device=q.device)[None, :] < kv_lens[:, None]  # [S, T]
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("sht,sthd->shd", weights, v.float())


def paged_chunk_attention(
    q: torch.Tensor,           # [S, C, H, D] — C chunk queries per slot
    k_pages: torch.Tensor,     # [N, page, Kh, D] — one layer's page pool
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [S, P] page ids into the pool
    starts: torch.Tensor,      # [S] absolute position of each slot's first query
) -> torch.Tensor:
    """Multi-query paged attention (chunked prefill): query i of slot s sits
    at position starts[s] + i and attends causally over the slot's pages,
    the chunk's own K/V included. Masks by causality alone, as the reference
    does; rows past a slot's valid tokens are garbage the engine discards.
    Returns fp32 [S, C, H, D]."""
    s, c, h, _ = q.shape
    page = k_pages.shape[1]
    p = page_table.shape[1]
    n_rep = h // k_pages.shape[2]
    k = _gather_pages(k_pages, page_table, n_rep)
    v = _gather_pages(v_pages, page_table, n_rep)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("schd,sthd->scht", q.float(), k.float()) * scale
    q_pos = starts[:, None] + torch.arange(c, device=q.device)[None, :]  # [S, C]
    valid = torch.arange(p * page, device=q.device)[None, None, :] <= q_pos[:, :, None]
    scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("scht,sthd->schd", weights, v.float())
