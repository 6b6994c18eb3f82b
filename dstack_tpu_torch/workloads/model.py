"""Llama-style decoder in plain PyTorch: parameter init, the dense forward,
the training loss and the speculative-decode draft head.

Ports ``dstack_tpu/workloads/model.py``: the parameter dict keeps the JAX
package's names and stacked-layer layout (``wq`` is [L, d_model, H*hd],
used as ``x @ w``), so a tree made by the JAX ``init_params`` loads as it is
(``convert.params_from_numpy``). The layer loop is a Python loop in place of
``lax.scan``; ``torch.utils.checkpoint`` takes the place of
``jax.checkpoint``.

Under a ``sharding.Mesh`` every rank holds its local pieces of the tree
(``sharding.PARAM_SPECS``) and its rows of the batch, and the forward runs
the collectives GSPMD would insert for the JAX package, written out in
``kernels/collective.py``: each weight gathered over the data ranks on use
(or, with ``cfg.fsdp_overlap``, the all-gather ring), the Megatron tp split
(column-parallel q/k/v and gate/up on the local heads and hidden, row-
parallel wo and w_down all-reduced, or the reduce-scatter ring with
``cfg.tp_overlap``), a vocab-sharded embedding lookup and a vocab-parallel
cross-entropy. The attention kernels run unchanged on the local heads.
The shared pieces take ``batch_axes``, the axes the tokens split over, as
the JAX package's do: the MoE decoder (``moe.py``) adds ``ep``, and a mesh
with sp > 1 adds ``sp`` (``sharding.token_axes``); the weights are whole
over those, so their gradients are summed over them too. Under sp a rank
holds one contiguous chunk of each row, its RoPE positions offset by the
chunk's start, and attention runs ``attention.ring_attention``.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from dstack_tpu_torch.workloads import quantize as quant_lib
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.attention import attention_core
from dstack_tpu_torch.workloads.config import LlamaConfig
from dstack_tpu_torch.workloads.kernels.collective import (
    allgather_matmul,
    can_fsdp_overlap,
    can_overlap,
    collective_matmul,
    gather_on_use,
    max_over,
    reduce_backward,
    reduce_forward,
)
from dstack_tpu_torch.workloads.sharding import DATA_AXES

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator,
    device: torch.device,
    dtype: Optional[torch.dtype] = None,
    mesh: Optional[sharding.Mesh] = None,
    shapes: Optional[Dict[str, tuple]] = None,
) -> Params:
    """Synthetic weights from ``generator``: normal / sqrt(fan_in) drawn in
    fp32, norms at one, stored in ``dtype`` (default cfg.param_dtype). Drawn
    one layer at a time, so the fp32 draw never holds more than one layer's
    slice. Under ``mesh`` (a training, an MoE or a serve mesh, each cut by
    its own layout, ``sharding.param_specs``) each rank draws the same
    numbers and keeps its local piece of every leaf, so the pieces of all
    ranks form exactly the meshless tree of the same generator. ``shapes``
    (default ``param_shapes(cfg)``) names the leaves: the MoE tree passes
    its own; a leaf of three dimensions or more is stacked over layers, and
    fan_in is the second-last dimension (d_model for the embed). The JAX
    package draws other numbers from the same seed."""
    dtype = dtype or dtype_of(cfg.param_dtype)
    specs = sharding.param_specs(mesh)
    out = {}
    for name, shape in (shapes or param_shapes(cfg)).items():
        where = (sharding.local_slices(specs[name], shape, mesh)
                 if mesh is not None else tuple(slice(0, n) for n in shape))
        local = tuple(sl.stop - sl.start for sl in where)
        if name.endswith("norm"):
            out[name] = torch.ones(local, dtype=dtype, device=device)
            continue
        fan_in = cfg.d_model if name == "embed" else shape[-2]
        leaf = torch.empty(local, dtype=dtype, device=device)
        stacked = len(shape) >= 3
        for i in range(shape[0] if stacked else 1):
            draw = torch.randn(shape[1:] if stacked else shape, generator=generator,
                               dtype=torch.float32, device=device)
            (leaf[i] if stacked else leaf).copy_((draw / fan_in ** 0.5)[where[1:] if stacked
                                                                         else where])
        out[name] = leaf
    return out


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


# -- the save_proj remat policy --------------------------------------------------
# JAX names the up-projections' outputs (q, k, v, gate, up) and the attention
# output before wo "proj" (checkpoint_name) and saves only those. PyTorch's
# selective checkpointing sees dispatcher ops, not names, so the named
# tensors come from two ops of their own, which the policy saves: the fp
# up-projection product itself (so the recompute reuses it and runs no
# product; its gradients are the ones ``x @ w`` has), and a copy that marks
# the attention output. Everything else recomputes, wo's and w_down's
# products included. Under int8/fp8 and the all-gather ring the
# up-projections keep their own products, which then recompute.


@torch.library.custom_op("dstack_tpu_torch::proj_matmul", mutates_args=())
def _proj_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


@_proj_matmul.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


def _proj_matmul_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _proj_matmul_backward(ctx, g):
    x, w = ctx.saved_tensors
    g2 = g.reshape(-1, g.shape[-1])
    dx = (g2 @ w.t()).reshape(x.shape)
    dw = x.reshape(-1, x.shape[-1]).t() @ g2
    return dx, dw


_proj_matmul.register_autograd(_proj_matmul_backward, setup_context=_proj_matmul_setup)


@torch.library.custom_op("dstack_tpu_torch::proj_saved", mutates_args=())
def _proj_saved(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


@_proj_saved.register_fake
def _(x):
    return torch.empty_like(x)


_proj_saved.register_autograd(lambda ctx, g: g, setup_context=lambda ctx, inputs, output: None)

_SAVE_PROJ_OPS = (torch.ops.dstack_tpu_torch.proj_matmul.default,
                  torch.ops.dstack_tpu_torch.proj_saved.default)


def _save_proj_policy(ctx, op, *args, **kwargs):
    if op in _SAVE_PROJ_OPS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _saves_proj(cfg: LlamaConfig) -> bool:
    return cfg.remat and cfg.remat_policy == "save_proj" and torch.is_grad_enabled()


def dense_proj(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig,
               saved: bool = False) -> torch.Tensor:
    """``x[..., K] @ w[K, N]`` in the activation dtype, under cfg.quant: the
    fp product (the weight cast to x.dtype on use), or the dynamically
    quantized int8/fp8 product with straight-through gradients. Meshless,
    this is both of the reference's ``up_proj`` and ``down_proj``.
    ``saved``: an up-projection under the save_proj policy (the fp product
    then runs as the op the policy saves)."""
    if saved and cfg.quant in ("", "none") and _saves_proj(cfg):
        return _proj_matmul(x, w.to(x.dtype))
    return quant_lib.matmul(x, w, cfg.quant, adt=x.dtype)


def _quant_partial_mm(cfg: LlamaConfig) -> Optional[quant_lib.Dot]:
    """The chunk product of a collective ring under cfg.quant (None = the
    fp product): straight-through dots, each chunk quantized with its own
    scales."""
    return {"int8": quant_lib.INT8_DOT, "fp8": quant_lib.FP8_DOT}.get(cfg.quant)


def _gather_dtype(cfg: LlamaConfig, adt: torch.dtype) -> Optional[torch.dtype]:
    """The dtype a weight is gathered in: the quantized products quantize
    the master weight itself, the fp product its cast to the activation
    dtype (gathered after the cast, half the bytes of fp32)."""
    return None if cfg.quant in ("int8", "fp8") else adt


def _tp(mesh: Optional[sharding.Mesh]) -> int:
    return mesh.shape["tp"] if mesh is not None else 1


def _norm_weight(params: Params, name: str, layer: Optional[int],
                 mesh: Optional[sharding.Mesh],
                 batch_axes: Tuple[str, ...] = DATA_AXES) -> torch.Tensor:
    """A norm's weight, whole on every rank: its gradient is summed over the
    batch axes (the tp ranks already agree on it)."""
    w = params[name] if layer is None else params[name][layer]
    return w if mesh is None else reduce_backward(w, mesh, batch_axes)


def _whole_over_batch(w: torch.Tensor, mesh: sharding.Mesh,
                      batch_axes: Tuple[str, ...]) -> torch.Tensor:
    """A weight split over the data axes and whole over the other batch axes
    (``ep``): its gradient, which each rank there has for its own rows only,
    is summed over them (the data axes' sum is the gather's)."""
    extra = tuple(a for a in batch_axes if a not in DATA_AXES)
    return reduce_backward(w, mesh, extra) if extra else w


def _ring_axes(x: torch.Tensor, mesh: sharding.Mesh,
               batch_axes: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    """The axes the all-gather ring of an up-projection walks, or None
    when it does not apply (the plain gather runs): the batch axes without
    sp (each sp rank rings over its own chunk), when K splits over them.
    The reference also requires the global batch, sequence and output
    columns to split over the batch axes, sp and tp; here ``x`` and the
    weight are a rank's local pieces, so those splits hold already."""
    ring = tuple(a for a in batch_axes if a != "sp")
    return ring if can_fsdp_overlap(mesh, x.shape[-1], ring) else None


def up_proj(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig,
            mesh: Optional[sharding.Mesh],
            batch_axes: Tuple[str, ...] = DATA_AXES) -> torch.Tensor:
    """The column-parallel projections (wq/wk/wv/w_gate/w_up): ``x`` [B, T, D]
    this rank's rows, ``w`` its [D/data, N/tp] piece. The weight is gathered
    over the data ranks on use, or with cfg.fsdp_overlap its shards ride the
    all-gather ring (kernels/collective.py) when d_model splits over them;
    the result is this rank's N/tp columns."""
    if mesh is None:
        return dense_proj(x, w, cfg, saved=True)
    w = _whole_over_batch(w, mesh, batch_axes)
    ring = _ring_axes(x, mesh, batch_axes) if cfg.fsdp_overlap else None
    if ring:
        # The ring walks K over its axes (the reference reshards w to K over
        # them): beyond dp and fsdp (ep on an MoE mesh) this rank's piece is
        # cut once more, at its coordinate there; the cut's gradient is
        # summed back over those axes by _whole_over_batch.
        extra = tuple(a for a in ring if a not in DATA_AXES)
        if extra:
            n = mesh.axis_size(extra)
            w = w.unflatten(0, (n, w.shape[0] // n))[mesh.index(extra)]
        return allgather_matmul(x, w, mesh, batch_axes=ring, matmul=_quant_partial_mm(cfg),
                                dtype=_gather_dtype(cfg, x.dtype)).to(x.dtype)
    w = gather_on_use(w, 0, mesh, DATA_AXES, _gather_dtype(cfg, x.dtype))
    return dense_proj(x, w, cfg, saved=True)


def down_proj(x: torch.Tensor, w: torch.Tensor, cfg: LlamaConfig,
              mesh: Optional[sharding.Mesh],
              batch_axes: Tuple[str, ...] = DATA_AXES) -> torch.Tensor:
    """The row-parallel projections (wo/w_down): ``x`` [B, T, K/tp] this
    rank's heads or hidden, ``w`` its [K/tp, D/data] piece, gathered over the
    data ranks on use. Under tp the partial products are summed over tp: by
    an all-reduce, or with cfg.tp_overlap by the reduce-scatter ring
    (kernels/collective.py) when the local rows split into tp chunks. The
    quantized plain path joins its scales over tp, so they span the whole
    contraction as GSPMD's do."""
    if mesh is None:
        return dense_proj(x, w, cfg)
    w = gather_on_use(_whole_over_batch(w, mesh, batch_axes), 1, mesh, DATA_AXES,
                      _gather_dtype(cfg, x.dtype))
    if _tp(mesh) == 1:
        return dense_proj(x, w, cfg)
    rows = x.shape[0] * mesh.axis_size(DATA_AXES)
    if cfg.tp_overlap and can_overlap(mesh, rows, x.shape[1]):
        return collective_matmul(x, w, mesh, matmul=_quant_partial_mm(cfg)).to(x.dtype)
    reduce = max_over(mesh, "tp") if cfg.quant in ("int8", "fp8") else None
    return reduce_forward(quant_lib.matmul(x, w, cfg.quant, x.dtype, reduce), mesh, "tp")


def attention_sublayer(
    x: torch.Tensor, params: Params, layer: int, cfg: LlamaConfig, positions: torch.Tensor,
    mesh: Optional[sharding.Mesh] = None, batch_axes: Tuple[str, ...] = DATA_AXES,
) -> torch.Tensor:
    """Pre-norm attention + residual on ``attention_core(cfg.attn_impl)``;
    under tp on this rank's H/tp query and Kh/tp KV heads (whole GQA
    groups). ``batch_axes``: the mesh axes the batch splits over (the MoE
    decoder adds ``ep``)."""
    b, t = x.shape[0], x.shape[1]
    heads, kv_heads = cfg.n_heads // _tp(mesh), cfg.n_kv_heads // _tp(mesh)
    h_in = _rms_norm(x, _norm_weight(params, "attn_norm", layer, mesh, batch_axes),
                     cfg.norm_eps)
    if _tp(mesh) > 1:
        h_in = reduce_backward(h_in, mesh, "tp")

    def proj(name):
        return up_proj(h_in, params[name][layer], cfg, mesh, batch_axes)

    q = proj("wq").reshape(b, t, heads, cfg.head_dim)
    k = proj("wk").reshape(b, t, kv_heads, cfg.head_dim)
    v = proj("wv").reshape(b, t, kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attention_core(q, k, v, cfg.attn_impl, mesh, window=cfg.attn_window)
    o = o.to(x.dtype).reshape(b, t, heads * cfg.head_dim)
    if _saves_proj(cfg):
        o = _proj_saved(o)
    return x + down_proj(o, params["wo"][layer], cfg, mesh, batch_axes)


def transformer_block(
    x: torch.Tensor, params: Params, layer: int, cfg: LlamaConfig, positions: torch.Tensor,
    mesh: Optional[sharding.Mesh] = None, batch_axes: Tuple[str, ...] = DATA_AXES,
) -> torch.Tensor:
    """One dense decoder block (attention + SwiGLU MLP, both pre-norm residual)."""
    x = attention_sublayer(x, params, layer, cfg, positions, mesh, batch_axes)
    h2 = _rms_norm(x, _norm_weight(params, "mlp_norm", layer, mesh, batch_axes), cfg.norm_eps)
    if _tp(mesh) > 1:
        h2 = reduce_backward(h2, mesh, "tp")
    gate = up_proj(h2, params["w_gate"][layer], cfg, mesh, batch_axes)
    up = up_proj(h2, params["w_up"][layer], cfg, mesh, batch_axes)
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + down_proj(hidden, params["w_down"][layer], cfg, mesh, batch_axes)


def positions_of(seq: int, mesh: Optional[sharding.Mesh], device) -> torch.Tensor:
    """The global positions of this rank's ``seq`` tokens of each row: its
    chunk of the sequence under sp (chunk i starts at i * seq)."""
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    start = mesh.index("sp") * seq if sp > 1 else 0
    return start + torch.arange(seq, device=device)


def remat_policy_of(cfg: LlamaConfig) -> Callable:
    """cfg.remat_policy -> the ``context_fn`` of ``torch.utils.checkpoint``:
    "full" recomputes the whole block; "dots" saves the outputs of the
    projection matmuls (``aten.mm``; the reference's dots without batch
    dimensions) and recomputes the rest; "save_proj" saves q, k, v, gate,
    up and the attention output before wo (the reference's "proj" names)
    and recomputes the rest, wo's and w_down's products included."""
    if cfg.remat_policy == "full":
        return torch.utils.checkpoint.noop_context_fn
    if cfg.remat_policy == "dots":
        return functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default],
        )
    if cfg.remat_policy == "save_proj":
        return functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts, _save_proj_policy)
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")


def _embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, mesh: Optional[sharding.Mesh],
                  adt: torch.dtype, batch_axes: Tuple[str, ...] = DATA_AXES) -> torch.Tensor:
    """Token embedding lookup. Under a mesh the table's d_model is gathered
    over the data ranks on use; under tp its vocab is sharded, so each rank
    gathers the rows it owns, zeros the rest, and the partial rows are
    summed over tp (the reference's shard_map'd lookup)."""
    if mesh is None:
        return embed.to(adt)[tokens]
    table = gather_on_use(_whole_over_batch(embed, mesh, batch_axes), 1, mesh, DATA_AXES,
                          adt)  # [V/tp, D]
    if _tp(mesh) == 1:
        return table[tokens]
    v_loc = table.shape[0]
    local = tokens - mesh.index("tp") * v_loc
    ok = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_forward(rows, mesh, "tp")


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    return_hidden: bool = False,
    mesh: Optional[sharding.Mesh] = None,
) -> torch.Tensor:
    """tokens [B, T] -> logits [B, T, V] fp32, or the final hidden state
    [B, T, D] (post final_norm, pre lm_head) when ``return_hidden``, which the
    chunked cross-entropy uses. Every weight is cast to cfg.dtype on use, so
    fp32 masters and weights stored in cfg.dtype give the same result. Under
    cfg.remat each block is recomputed in the backward pass (when gradients
    are recorded). Under ``mesh``: this rank's rows (under sp its chunk of
    the sequence), and under tp its V/tp vocab columns of the logits."""
    adt = dtype_of(cfg.dtype)
    axes = sharding.token_axes(mesh)
    tokens = tokens.to(params["embed"].device).long()
    x = _embed_lookup(params["embed"], tokens, mesh, adt, axes)
    positions = positions_of(tokens.shape[1], mesh, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = remat_policy_of(cfg) if remat else None
    for layer in range(cfg.n_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                transformer_block, x, params, layer, cfg, positions, mesh, axes,
                use_reentrant=False, context_fn=context_fn,
            )
        else:
            x = transformer_block(x, params, layer, cfg, positions, mesh, axes)
    x = _rms_norm(x, _norm_weight(params, "final_norm", None, mesh, axes), cfg.norm_eps)
    if return_hidden:
        return x
    lm_head = _lm_head(params, cfg, mesh, None if cfg.quant == "int8" else adt, axes)
    return _logits(_tp_input(x, mesh), lm_head, cfg.quant)


def _lm_head(params: Params, cfg: LlamaConfig, mesh: Optional[sharding.Mesh],
             dtype: Optional[torch.dtype], batch_axes: Tuple[str, ...] = DATA_AXES
             ) -> torch.Tensor:
    """The lm_head in ``dtype`` (None: its own), [D, V/tp] under a mesh:
    gathered over the data ranks on use."""
    if mesh is None:
        return params["lm_head"] if dtype is None else params["lm_head"].to(dtype)
    return gather_on_use(_whole_over_batch(params["lm_head"], mesh, batch_axes), 0, mesh,
                         DATA_AXES, dtype)


def _tp_input(x: torch.Tensor, mesh: Optional[sharding.Mesh]) -> torch.Tensor:
    """The final hidden state entering the vocab-parallel lm_head: its
    gradient is summed over tp."""
    return reduce_backward(x, mesh, "tp") if _tp(mesh) > 1 else x


def _logits(x: torch.Tensor, lm_head: torch.Tensor, quant: str) -> torch.Tensor:
    if quant == "int8":
        return quant_lib.int8_matmul_ste(x, lm_head)
    # bf16 x bf16 products are exact in fp32: an fp32 product of the rounded
    # operands is the reference's dot with fp32 accumulation. Under fp8 the
    # lm_head stays this fp product, as the reference's does.
    return x.float() @ lm_head.float()


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor,
             tp_mesh: Optional[sharding.Mesh] = None):
    """(sum of -log p(target) over targets >= 0, their count); logits fp32,
    targets -1 = ignore. With ``tp_mesh`` (a mesh with tp > 1) the logits
    are this rank's block of the vocab: the max and the sum of exponentials
    are reduced over tp, and the target's logit comes from the rank that
    owns it (the max is a constant of the gradient, which it cancels from)."""
    mask = targets >= 0
    safe = torch.where(mask, targets, 0).long()
    if tp_mesh is None:
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
        return (nll * mask).sum(), mask.sum()
    v_loc = logits.shape[-1]
    m = logits.detach().amax(-1, keepdim=True)
    max_over(tp_mesh, "tp")(m)
    sum_exp = reduce_forward(torch.exp(logits - m).sum(-1), tp_mesh, "tp")
    local = safe - tp_mesh.index("tp") * v_loc
    ok = (local >= 0) & (local < v_loc)
    picked = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = reduce_forward(torch.where(ok, picked, 0.0), tp_mesh, "tp")
    nll = torch.log(sum_exp) + m[..., 0] - picked
    return (nll * mask).sum(), mask.sum()


def _chunk_nll(x_blk: torch.Tensor, t_blk: torch.Tensor, lm_head: torch.Tensor, quant: str,
               tp_mesh: Optional[sharding.Mesh] = None):
    return _nll_sum(_logits(x_blk, lm_head, quant), t_blk, tp_mesh)


def _chunked_nll(
    x: torch.Tensor,        # [B, T, D] final hidden (post final_norm)
    lm_head: torch.Tensor,  # [D, V] in the activation dtype ([D, V/tp] under tp)
    targets: torch.Tensor,  # [B, T]; -1 = ignore
    chunk: int,
    quant: str = "none",
    tp_mesh: Optional[sharding.Mesh] = None,
):
    """Cross-entropy without materializing [B,T,V] fp32 logits: the sequence
    goes in chunks, each chunk's logits and log-softmax are recomputed in the
    backward pass (``torch.utils.checkpoint``). Returns (total nll, count)."""
    total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    total_cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for c0 in range(0, x.shape[1], chunk):
        nll, cnt = torch.utils.checkpoint.checkpoint(
            _chunk_nll, x[:, c0:c0 + chunk], targets[:, c0:c0 + chunk], lm_head, quant,
            tp_mesh, use_reentrant=False,
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
    mesh: Optional[sharding.Mesh] = None,
) -> torch.Tensor:
    """Mean cross-entropy over the targets >= 0. Under ``mesh`` each rank
    passes its own rows (under sp its chunk of them): the sum and the count
    are reduced over the token axes, so every rank returns the loss of the
    global batch, and its gradient reaches this rank's tokens only (the
    data ranks' weight gradients are summed by the gathers' backward, the
    sp ranks' by one more sum). The loss chunk is picked from the global
    sequence length, as the reference's."""
    targets = targets.to(params["embed"].device)
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    chunk = pick_loss_chunk(cfg, tokens.shape[1] * sp)
    if mesh is None:
        if chunk:
            hidden = forward(params, tokens, cfg, return_hidden=True)
            lm_head = params["lm_head"].to(dtype_of(cfg.dtype))
            total_nll, total_cnt = _chunked_nll(hidden, lm_head, targets, chunk, quant=cfg.quant)
            return total_nll / torch.clamp(total_cnt, min=1)
        return masked_ce(forward(params, tokens, cfg), targets)
    adt = dtype_of(cfg.dtype)
    axes = sharding.token_axes(mesh)
    tp_mesh = mesh if _tp(mesh) > 1 else None
    hidden = _tp_input(forward(params, tokens, cfg, return_hidden=True, mesh=mesh), mesh)
    if chunk:
        lm_head = _lm_head(params, cfg, mesh, adt, axes)
        total, count = _chunked_nll(hidden, lm_head, targets, chunk, cfg.quant, tp_mesh)
    else:
        lm_head = _lm_head(params, cfg, mesh, None if cfg.quant == "int8" else adt, axes)
        total, count = _nll_sum(_logits(hidden, lm_head, cfg.quant), targets, tp_mesh)
    return global_mean(total, count, mesh, axes)


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh: sharding.Mesh,
                batch_axes: Tuple[str, ...] = DATA_AXES) -> torch.Tensor:
    """The mean over the global batch from each rank's (sum, count) of its
    rows: both summed over ``batch_axes``; the gradient reaches each rank's
    own sum."""
    count = count.clone()
    dist.all_reduce(count, group=mesh.group(batch_axes))
    return reduce_forward(total, mesh, batch_axes) / torch.clamp(count, min=1)


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
                       cfg: LlamaConfig, rollout: int = 2,
                       mesh: Optional[sharding.Mesh] = None) -> torch.Tensor:
    """Distillation loss against the frozen target on one batch: the head's
    cross-entropy against the target's own argmax. Position t conditions on
    (target hidden_t, embedding of token_{t+1}) and predicts the target's
    argmax at t+1; rollout step j >= 2 feeds the head its own previous
    output and proposed token, labelled j ahead. The target's forward runs
    without gradients and its labels are constants, so gradients reach
    ``draft`` only.

    Under a training ``mesh``: ``params`` are this rank's pieces and
    ``tokens`` its rows; the target's forward runs on the mesh, its embed
    and lm_head are gathered whole, and ``draft`` is whole on every rank.
    The value is the global mean (every rank holds as many rows, and each
    row as many labels), and the draft's gradients are summed over the data
    axes, so they are the global mean's (the tp ranks of a data shard hold
    the same rows: no sum over tp)."""
    adt = dtype_of(cfg.dtype)
    tokens = tokens.to(params["embed"].device).long()
    embed, lm_head = params["embed"], params["lm_head"]
    with torch.no_grad():
        hidden = forward(params, tokens, cfg, return_hidden=True, mesh=mesh)  # [B, T, D]
        if mesh is not None:
            embed = gather_on_use(gather_on_use(embed, 1, mesh, DATA_AXES), 0, mesh, ("tp",))
            lm_head = gather_on_use(gather_on_use(lm_head, 0, mesh, DATA_AXES), 1, mesh,
                                    ("tp",))
        labels = _draft_mm(hidden, lm_head).float().argmax(-1)  # a_t
    if mesh is not None:
        draft = {k: reduce_backward(w, mesh, DATA_AXES) for k, w in draft.items()}
    h = hidden[:, :-1]          # rows t = 0..T-2
    cond = tokens[:, 1:]        # x_{t+1}
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for j in range(1, rollout + 1):
        e = embed.to(adt)[cond]
        h = draft_apply(draft, h, e, cfg)
        logits_j = _draft_mm(h, lm_head).float()
        # Row t's label at depth j is a_{t+j}; rows past T-1-j have none.
        lab = torch.nn.functional.pad(labels[:, j:], (0, j - 1), value=-1)
        total = total + masked_ce(logits_j, lab)
        cond = logits_j.argmax(-1)
    if mesh is None:
        return total / rollout
    return reduce_forward(total / rollout / mesh.axis_size(DATA_AXES), mesh, DATA_AXES)
