"""Continuous-batching inference engine over the llama workload, in PyTorch.

The port of ``dstack_tpu/workloads/serve.py``'s tier-1 engine and chunked
prefill, on a CUDA card:

- **Paged KV cache**: one page pool per layer (``[L, N_pages, page, Kh,
  D]``); each request owns a page table of pool indices, pages allocated on
  demand and freed the step a request finishes; a dry pool preempts the
  youngest request, which re-prefills later from prompt + generated tokens.
- **Prefill/decode split**: admitted prompts run one batched whole-prompt
  prefill on blockwise attention (or, with ``prefill_chunk``, at most that
  many tokens per request per step over the paged prefix), and the running
  batch advances one token per step through single-query paged attention.
- **Prefix cache** (``prefix_cache=True``): full KV pages of prompt blocks
  are kept in a refcounted hash chain (``PrefixCache``); a request sharing a
  cached prefix reuses those pages and prefills only its suffix, through the
  chunk step. Cached pages are never written again; idle blocks are evicted
  LRU, leaves first, before a dry pool preempts.
- **Speculative decode** (``spec_tokens=k``): a host-side n-gram proposer
  drafts k tokens per slot, and one chunk step (``emit="all"``) scores all
  of them; greedy accept/reject emits 1..k+1 tokens a step, token-identical
  to one-token greedy decode. Every decode step is then a verify step.
- **Draft head** (``draft_params``, ``--spec-model``): a distilled
  EAGLE-style head (``model.draft_apply``) proposes the k drafts from the
  target's last hidden state instead; prefill, chunk and verify then hand
  that hidden state back (``with_hidden``). A request whose windowed accept
  rate falls under ``spec_fallback_threshold`` goes back to the n-gram
  proposer for the rest of its life.
- **Checkpoints** (``load_serve_params``, ``load_draft_params``): real
  weights from a train checkpoint in the JAX package's format, the
  ``.params`` subtree only, quantized as it is restored under ``quant``.
- **Weight-only int8/fp8** (``quant``): projection weights are quantized
  once at engine build (``quantize_serve_params``) and dequantized on use
  (``quantize.weight_only_matmul``).
- **Serve mesh** (``mesh``, ``--mesh tpN | ddMxtpN`` under torchrun): one
  process a rank, each holding its Megatron piece of the weights
  (``sharding.SERVE_PARAM_SPECS``) and of the KV pages (its ``n_kv_heads /
  tp`` heads), so the same ``--pages`` takes 1/tp of the bytes a rank. The
  step functions run on the rank's heads and all-reduce the row-parallel
  products (wo, w_down) and the lm_head logits over the tp group in fp32,
  rounding once, as the meshless path does. Every rank runs the same
  engine; rank 0 alone serves HTTP and broadcasts each step's new requests
  (``StepSync``), and the ranks check after each step that they emitted the
  same tokens.
- **Kernels**: ``decode_impl="cuda"`` (the default on a CUDA device) runs the
  hand-written paged decode and paged chunk kernels
  (``kernels/paged.py``); ``"plain"`` runs the gather references of
  ``attention.py``, as the JAX engine's ``"xla"`` does. Chunked prefill, the
  prefix cache's suffix prefill and speculative verify all run the chunk
  kernel.
- **HTTP**: the same aiohttp routes, headers and JSON keys as the JAX engine
  (``create_serve_app``), so the control plane's proxy serves either.

The step functions are plain eager functions; the host-side scheduling is
the JAX engine's, line for line. Decoding is greedy (argmax), and in fp32 the
engine is token-identical to the JAX engine on the same weights, meshless or
on a serve mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import re
import signal
import threading
import time
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dstack_tpu_torch.core import tracing
from dstack_tpu_torch.workloads import checkpoint as checkpoint_lib
from dstack_tpu_torch.workloads import convert as convert_lib
from dstack_tpu_torch.workloads import model as model_lib
from dstack_tpu_torch.workloads import quantize as quant_lib
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import telemetry as telemetry_lib
from dstack_tpu_torch.workloads.attention import (
    blockwise_attention,
    paged_chunk_attention,
    paged_decode_attention,
)
from dstack_tpu_torch.workloads.config import LlamaConfig, get_config
from dstack_tpu_torch.workloads.kernels.collective import max_over
from dstack_tpu_torch.workloads.kernels.paged import (
    paged_chunk_attention_cuda,
    paged_decode_attention_cuda,
)
from dstack_tpu_torch.workloads.kernels.platform import (
    DeviceLike,
    require_sm90,
    resolve_device,
    set_reference_matmul_precision,
)

logger = logging.getLogger(__name__)

_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORM_KEYS = ("attn_norm", "mlp_norm")
_LAYER_KEYS = _WEIGHT_KEYS + _NORM_KEYS

DECODE_IMPLS = ("auto", "plain", "cuda")


def resolve_decode_impl(impl: str, device: torch.device) -> str:
    """"auto" = the CUDA kernels on a CUDA device, the gather references on
    the CPU. The kernels take only CUDA tensors."""
    if impl not in DECODE_IMPLS:
        raise ValueError(f"unknown decode_impl {impl!r}; expected one of {DECODE_IMPLS}")
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "plain"
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"decode_impl='cuda' runs the CUDA kernels; device is {device}")
    return impl


def quantize_serve_params(params: dict, consume: bool = False, mode: str = "int8",
                          mesh: Optional[sharding.Mesh] = None) -> dict:
    """Weight-only quantization for serving: every projection weight becomes
    quantized values + per-output-channel fp32 scales (``<k>_q`` /
    ``<k>_s``); the embedding and the norms stay as they are. ``mode`` is
    "int8" or "fp8" (e4m3); both dequantize on use.

    With ``consume=True`` the input dict is drained as it is quantized: each
    fp weight is popped the moment its quantized twin exists, so peak memory
    is the fp tree plus one quantized copy of one weight, never two full
    trees.

    Under a serve ``mesh`` the tree is this rank's pieces. A column-parallel
    piece holds its channels' whole contraction, so its own absmax is the
    whole weight's; a row-parallel piece (wo, w_down, lm_head) holds a 1/tp
    slice of the contraction, and its absmax is taken as the max over the tp
    group. Each piece's values and scales are then the matching piece of
    the meshless quantization, bit for bit."""
    tp = mesh is not None and mesh.shape["tp"] > 1
    out = {
        k: params.pop(k) if consume else params[k]
        for k in ("embed", "final_norm", "attn_norm", "mlp_norm")
    }
    for k in _WEIGHT_KEYS + ("lm_head",):
        w = params.pop(k) if consume else params[k]
        split = tp and sharding.SERVE_PARAM_SPECS[k][-2] == "tp"
        qw = quant_lib.quantize_weight(  # contraction = 2nd-to-last
            w, mode=mode, reduce=max_over(mesh, "tp") if split else None)
        del w
        out[k + "_q"] = qw.values
        out[k + "_s"] = qw.scales
    return out


def parse_mesh_arg(spec: str, world: Optional[int] = None) -> Optional[sharding.Mesh]:
    """CLI serve-mesh spec -> Mesh over the process group's ranks (``world``
    of them, by default the group's size, 1 without one): "tp4" (dd absorbs
    the other ranks), "dd2xtp4" (an explicit replica axis), "" / "none" ->
    meshless. The JAX package's grammar and errors."""
    if not spec or spec == "none":
        return None
    m = re.fullmatch(r"(?:dd(\d+)x)?tp(\d+)", spec)
    if m is None:
        raise ValueError(
            f"bad mesh spec {spec!r}; expected tpN or ddMxtpN (e.g. tp4,"
            f" dd2xtp4)"
        )
    dd = int(m.group(1)) if m.group(1) else None
    return sharding.make_serve_mesh(tp=int(m.group(2)), dd=dd, world=world)


def load_serve_params(
    checkpoint_dir: str,
    cfg: LlamaConfig,
    mesh: Optional[sharding.Mesh] = None,
    quant: str = "none",
    step: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[dict, dict]:
    """Real weights for the engine from a train checkpoint: only the
    ``.params`` subtree's bytes are read (a TrainState's optimizer moments
    stay on disk; a params-only checkpoint restores too), each leaf in the
    param dtype on ``device``. Under a serve ``mesh`` (connected, or at
    least given this process's ``rank``) each leaf is restored at this
    rank's piece of ``sharding.SERVE_PARAM_SPECS``, from the checkpoint's
    pieces that meet it, whatever layout wrote them. Under a weight-only
    ``quant`` the tree is quantized as it is consumed
    (``quantize_serve_params(consume=True, mesh=mesh)``): the fp tree plus
    one quantized leaf at the peak, never two trees. Returns ``(params,
    manifest)`` in the layout ``ServeEngine`` takes for ``quant``."""
    quant_lib.check_quant(quant)
    if mesh is not None:
        sharding.validate_serve_mesh(cfg, mesh)
    device = resolve_device(device)
    manager = checkpoint_lib.CheckpointManager(checkpoint_dir, mesh=mesh)
    dtype = model_lib.dtype_of(cfg.param_dtype)
    template = {k: checkpoint_lib.LeafSpec(_piece_shape(k, shape, mesh), dtype, device)
                for k, shape in model_lib.param_shapes(cfg).items()}
    params, manifest = manager.restore_subtree(template, step=step, prefix=".params")
    if quant_lib.is_weight_only(quant):
        params = quantize_serve_params(params, consume=True, mode=quant, mesh=mesh)
    return params, manifest


def _serve_spec(key: str) -> sharding.Spec:
    """A serve leaf's layout, of the fp tree or the quantized one."""
    return sharding.serve_param_specs("int8" if key.endswith(("_q", "_s")) else "none")[key]


def _piece_shape(key: str, shape, mesh: Optional[sharding.Mesh]) -> tuple:
    """The shape of this rank's piece of a serve leaf of ``shape``."""
    if mesh is None:
        return tuple(shape)
    return tuple(sl.stop - sl.start
                 for sl in sharding.local_slices(_serve_spec(key), shape, mesh))


def shard_serve_params(params: dict, cfg: LlamaConfig, mesh: sharding.Mesh) -> dict:
    """This rank's pieces of a serve tree (fp, or the quantized layout):
    each whole leaf is cut to its piece (a view), and a leaf that already
    has its piece's shape (``load_serve_params(mesh=...)``,
    ``init_params(mesh=...)``) is kept as it is."""
    shapes = model_lib.param_shapes(cfg)
    out = {}
    for k, v in params.items():
        whole = list(shapes[k[:-2] if k.endswith(("_q", "_s")) else k])
        if k.endswith("_s"):
            whole[-2] = 1
        piece = _piece_shape(k, whole, mesh)
        if tuple(v.shape) == tuple(whole):
            v = v[sharding.local_slices(_serve_spec(k), whole, mesh)]
        elif tuple(v.shape) != piece:
            raise ValueError(f"{k}: shape {tuple(v.shape)} is neither the whole leaf"
                             f" {tuple(whole)} nor this rank's piece {piece}")
        out[k] = v
    return out


def load_draft_params(
    checkpoint_dir: str,
    cfg: LlamaConfig,
    mesh: Optional[sharding.Mesh] = None,
    step: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[dict, dict]:
    """The draft head for --spec-model: the ``.draft`` subtree a
    ``train --draft-head`` run saved. Its depth and width are what was
    trained, so the template comes from the manifest's ``.draft`` leaves.
    The head is never quantized, and on a serve ``mesh`` every rank
    restores it whole (JAX replicates it), so the mesh changes nothing
    here. Returns ``(draft_params, manifest)``."""
    device = resolve_device(device)
    manager = checkpoint_lib.CheckpointManager(checkpoint_dir)
    if step is None:
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {checkpoint_dir}")
    manifest = manager.read_manifest(step)
    template = {}
    for leaf in manifest["leaves"]:
        key = leaf["key"]
        if not key.startswith(".draft["):
            continue
        name = key[len(".draft"):].strip("[]'\"")
        dtype = convert_lib.torch_dtype(leaf["dtype"])
        template[name] = checkpoint_lib.LeafSpec(tuple(leaf["shape"]), dtype, device)
    if not template:
        raise ValueError(
            f"checkpoint step {step} in {checkpoint_dir} has no .draft subtree - distill"
            f" one with `train --draft-head`"
        )
    d = cfg.d_model
    if tuple(template["w_fuse"].shape) != (2 * d, d):
        raise ValueError(
            f"draft head was trained for d_model {template['w_fuse'].shape[1]},"
            f" engine config has {d}"
        )
    return manager.restore_subtree(template, step=step, prefix=".draft")


def _serve_layer_keys(quant: str):
    if not quant_lib.is_weight_only(quant):
        return _LAYER_KEYS
    return tuple(f"{k}_{suffix}" for k in _WEIGHT_KEYS for suffix in ("q", "s")) + _NORM_KEYS


def _place(params: dict, device: torch.device, adt: torch.dtype) -> dict:
    """The engine's copy of a tree on its device: quantized values in their
    own dtype, scales in fp32, every other leaf in the activation dtype,
    cast once here (the JAX engine casts on every use, to the same values),
    each contiguous (a rank's piece may be a view across the whole leaf)."""
    return {
        k: v.to(device=device, dtype=quant_lib.leaf_dtype(k, v, adt)).contiguous()
        for k, v in params.items()
    }


class _Tp(NamedTuple):
    """A step function's view of the serve mesh's tp axis: the group of
    this rank's tp peers, their number and this rank's index among them."""

    group: object
    size: int
    index: int


def _tp_of(mesh: Optional[sharding.Mesh]) -> Optional[_Tp]:
    """The tp split of ``mesh``; None meshless and at tp 1, where the step
    functions run exactly the meshless arithmetic."""
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    return _Tp(mesh.group("tp"), mesh.shape["tp"], mesh.index("tp"))


def _heads(cfg: LlamaConfig, tp: Optional[_Tp]) -> Tuple[int, int]:
    """This rank's query and KV heads: whole GQA groups, 1/tp of each."""
    n = tp.size if tp is not None else 1
    return cfg.n_heads // n, cfg.n_kv_heads // n


def _summed(partial: torch.Tensor, tp: _Tp) -> torch.Tensor:
    """The sum over the tp group of each rank's fp32 partial product, in
    place: one all-reduce, the same values on every rank."""
    dist.all_reduce(partial, group=tp.group)
    return partial


def _proj(x: torch.Tensor, params: dict, key: str, layer: int, quant: str,
          tp: Optional[_Tp] = None) -> torch.Tensor:
    """x[..., K] @ params[key][layer] in the activation dtype: the fp weight
    (stored in that dtype, so this is the JAX engine's cast-on-use dot), or
    weight-only int8/fp8, scaled in fp32 and rounded once. ``tp`` is given
    for a row-parallel weight (wo, w_down) on a serve mesh: x and the weight
    hold this rank's slice of the contraction, and the fp32 partial products
    are summed over the tp group before the one rounding (in bf16 too: the
    meshless bf16 product also rounds its fp32 sum once)."""
    if quant_lib.is_weight_only(quant):
        y = quant_lib.weight_only_matmul(x, params[key + "_q"][layer], params[key + "_s"][layer])
        return (_summed(y, tp) if tp is not None else y).to(x.dtype)
    if tp is None:
        return x @ params[key][layer]
    return _summed(quant_lib.fp32_product(x, params[key][layer]), tp).to(x.dtype)


def _logits(x: torch.Tensor, params: dict, quant: str, tp: Optional[_Tp] = None) -> torch.Tensor:
    """fp32 logits, as the JAX engine's fp32-accumulating lm_head dot. On a
    serve mesh lm_head holds this rank's rows of its contraction: the rank
    multiplies the matching slice of x's D axis, and the all-reduced fp32
    partials are the whole logits on every rank."""
    if tp is not None:
        d = x.shape[-1] // tp.size
        x = x[..., tp.index * d:(tp.index + 1) * d]
    if quant_lib.is_weight_only(quant):
        out = quant_lib.weight_only_matmul(x, params["lm_head_q"], params["lm_head_s"])
    else:
        out = x.float() @ params["lm_head"].float()
    return _summed(out, tp) if tp is not None else out


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs, orthogonal to the model config (LlamaConfig)."""

    page_size: int = 16        # tokens per KV page
    num_pages: int = 256       # pool size, shared by all slots (per layer)
    max_batch: int = 8         # decode slots = max in-flight sequences
    max_seq: int = 0           # page-table width in tokens (0 = cfg.max_seq_len)
    # "continuous" admits into any free slot every step; "static" only admits
    # when the whole batch has drained.
    policy: str = "continuous"
    eos_id: Optional[int] = None
    max_new_default: int = 16
    # Paged attention: "auto" = CUDA kernels on a CUDA device, gather
    # references on the CPU; "plain"/"cuda" force one.
    decode_impl: str = "auto"
    # "int8" / "fp8" = weight-only quantization (quantize_serve_params):
    # projection weights stored int8 or fp8-e4m3 + per-channel scales,
    # dequantized on use.
    quant: str = "none"
    # Max prompt tokens prefilled per request per engine step (0 = whole
    # prompt in one batched prefill).
    prefill_chunk: int = 0
    # Cross-request prefix caching: full KV pages of prompt blocks are kept in
    # a refcounted registry after prefill; later requests sharing the prefix
    # skip recomputing it. Evicted LRU when the allocator runs dry.
    prefix_cache: bool = False
    # Speculative decode: k draft tokens per slot from an n-gram proposer,
    # verified in one batched chunk step (0 = one token per step).
    spec_tokens: int = 0
    # Draft head (engine built with draft_params): a request whose accept
    # rate over its last spec_fallback_window spec steps falls under
    # spec_fallback_threshold goes back to the n-gram proposer for good. The
    # window must fill first; a threshold <= 0 disables the fallback.
    spec_fallback_window: int = 16
    spec_fallback_threshold: float = 0.1
    # Sliding window (spec steps) behind the windowed accept rate on /stats
    # and X-Dstack-Spec-Accept-Rate.
    spec_window: int = 64


class TokenEvent(NamedTuple):
    req_id: str
    token: int
    index: int   # 0-based position in the generated sequence
    done: bool


@dataclasses.dataclass
class GenRequest:
    req_id: str
    prompt: List[int]          # tokens prefilled on (re)admission
    max_new_tokens: int
    eos_id: Optional[int]
    submitted_t: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated
    done: bool = False
    preemptions: int = 0
    # Generated tokens already folded into `prompt` by earlier preemptions.
    absorbed: int = 0
    # Prompt tokens whose KV is in pages for the CURRENT admission (cache
    # hits + chunks done); < len(prompt) means the slot is mid-prefill.
    pos: int = 0
    # Prompt tokens served from the prefix cache at last admission.
    cached_tokens: int = 0
    # Host-side lifecycle stamps (time.monotonic), set once each.
    trace_id: Optional[str] = None
    admitted_t: float = 0.0
    prefill_start_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    # Per-request speculative-decode accounting.
    spec_proposed: int = 0
    spec_accepted: int = 0
    # n-gram proposer state, built on the first draft: the emitted stream
    # (prompt + generated, each token once) and its continuation index;
    # _emit keeps both current.
    spec_ctx: Optional[List[int]] = None
    spec_index: Optional[dict] = None
    # Draft head: whether this request still drafts with it (False after a
    # fallback, for the request's life), and the (proposed, accepted)
    # samples of its latest spec steps (maxlen spec_fallback_window).
    draft_ok: bool = True
    spec_recent: Optional[Deque[Tuple[int, int]]] = None


def _rope_single(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding for one token per row: x [S,H,D], positions [S]."""
    cos, sin = model_lib._rope_angles(positions, x.shape[-1], theta)
    return model_lib._rotate(x, cos[:, None, :], sin[:, None, :])


def _rope_chunk(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding with per-row positions: x [S,C,H,D], positions [S,C]."""
    cos, sin = model_lib._rope_angles(positions, x.shape[-1], theta)
    return model_lib._rotate(x, cos[:, :, None, :], sin[:, :, None, :])


def _write_index(write_page, write_off, num_pages: int, device: torch.device):
    """The rows of the flattened host-side write maps that land in the pool,
    and their (page, offset). A pool-sized page id drops the write, as JAX's
    ``.at[...].set(mode="drop")`` does: padding and inactive slots rely on it.
    Computed on the host once per step, so no layer waits on the device."""
    wp = torch.as_tensor(write_page).reshape(-1)
    wo = torch.as_tensor(write_off).reshape(-1)
    rows = torch.nonzero(wp < num_pages).squeeze(1)
    return rows.to(device), wp[rows].long().to(device), wo[rows].long().to(device)


def _scatter_kv(pool: torch.Tensor, index, kv: torch.Tensor) -> None:
    """pool [N, page, Kh, D] <- kv [..., Kh, D] at the kept rows, in place."""
    rows, page, off = index
    flat = kv.reshape(-1, kv.shape[-2], kv.shape[-1])
    pool.index_put_((page, off), flat[rows].to(pool.dtype))


def _mlp(x: torch.Tensor, params: dict, layer: int, eps: float, quant: str,
         tp: Optional[_Tp] = None) -> torch.Tensor:
    h2 = model_lib._rms_norm(x, params["mlp_norm"][layer], eps)
    gate = _proj(h2, params, "w_gate", layer, quant)
    up = _proj(h2, params, "w_up", layer, quant)
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + _proj(hidden, params, "w_down", layer, quant, tp)


# The step functions update the KV pools in place (the JAX engine donates
# them to its jitted steps for the same effect) and return the greedy next
# tokens. Host inputs arrive as numpy arrays or CPU tensors. Under a serve
# ``mesh`` each runs on this rank's pieces: its n_heads/tp query and
# n_kv_heads/tp KV heads and pages, and the all-reduces of ``_proj`` (wo,
# w_down) and ``_logits``, the collectives GSPMD inserts for the JAX engine;
# the embed, the norms and the draft head are whole on every rank. Every
# rank of the tp group must call the same function on the same host inputs.


def make_prefill_fn(cfg: LlamaConfig, quant: str = "none", mesh=None, with_hidden: bool = False):
    """(params, tokens, k_pages, v_pages, write_page, write_off, lens) ->
    next_tokens [B]. tokens [B, T] right-padded prompts; write_page/write_off
    [B, T] map each position into the pool (pool-sized page = dropped
    write); lens [B] true prompt lengths. Blockwise causal attention over the
    prompt itself; the greedy token after each prompt's last position. With
    a weight-only ``quant`` the params are the ``quantize_serve_params``
    layout. ``with_hidden`` (draft-head engines) returns (next_tokens, the
    last valid position's final hidden state [B, D]): the conditioning of
    the first proposal after this prefill."""
    tp = _tp_of(mesh)
    h, kh = _heads(cfg, tp)

    def prefill(params, tokens, k_pages, v_pages, write_page, write_off, lens):
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        b, t = tokens.shape
        hd = cfg.head_dim
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][tokens]  # [B,T,D]
        positions = torch.arange(t, device=dev)
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params, "wq", layer, quant).reshape(b, t, h, hd)
            k = _proj(h_in, params, "wk", layer, quant).reshape(b, t, kh, hd)
            v = _proj(h_in, params, "wv", layer, quant).reshape(b, t, kh, hd)
            q = model_lib._rope(q, positions, cfg.rope_theta)
            k = model_lib._rope(k, positions, cfg.rope_theta)
            _scatter_kv(k_pages[layer], index, k)
            _scatter_kv(v_pages[layer], index, v)
            o = blockwise_attention(q, k, v, causal=True)
            x = x + _proj(o.to(x.dtype).reshape(b, t, h * hd), params, "wo", layer, quant, tp)
            x = _mlp(x, params, layer, cfg.norm_eps, quant, tp)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        last_idx = (torch.as_tensor(lens).to(dev).long() - 1).clamp(0, t - 1)
        last = x[torch.arange(b, device=dev), last_idx]  # [B, D]
        out = _logits(last, params, quant, tp).argmax(-1).int()
        return (out, last) if with_hidden else out

    return prefill


def make_decode_fn(cfg: LlamaConfig, quant: str = "none", decode_impl: str = "plain",
                   mesh=None):
    """(params, last_tokens, positions, k_pages, v_pages, page_tables,
    write_page, write_off) -> next_tokens [S]. One query per slot: the last
    emitted token's K/V is appended at `positions`, then it attends over the
    slot's paged prefix. Inactive slots ride along with dropped writes and
    finite outputs the engine ignores. decode_impl="cuda" runs the paged
    decode kernel, "plain" the gather reference."""
    attend = paged_decode_attention_cuda if decode_impl == "cuda" else paged_decode_attention
    tp = _tp_of(mesh)
    h, kh = _heads(cfg, tp)

    def decode(params, last_tokens, positions, k_pages, v_pages, page_tables,
               write_page, write_off):
        dev = params["embed"].device
        last_tokens = torch.as_tensor(last_tokens).to(dev).long()
        positions = torch.as_tensor(positions).to(dev).int()
        page_tables = torch.as_tensor(page_tables).to(dev).int()
        kv_lens = positions + 1
        s = last_tokens.shape[0]
        hd = cfg.head_dim
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][last_tokens]  # [S, D]
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params, "wq", layer, quant).reshape(s, h, hd)
            k = _proj(h_in, params, "wk", layer, quant).reshape(s, kh, hd)
            v = _proj(h_in, params, "wv", layer, quant).reshape(s, kh, hd)
            q = _rope_single(q, positions, cfg.rope_theta)
            k = _rope_single(k, positions, cfg.rope_theta)
            _scatter_kv(k_pages[layer], index, k)
            _scatter_kv(v_pages[layer], index, v)
            o = attend(q, k_pages[layer], v_pages[layer], page_tables, kv_lens)
            x = x + _proj(o.to(x.dtype).reshape(s, h * hd), params, "wo", layer, quant, tp)
            x = _mlp(x, params, layer, cfg.norm_eps, quant, tp)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _logits(x, params, quant, tp).argmax(-1).int()

    return decode


def make_chunk_fn(
    cfg: LlamaConfig, quant: str = "none", decode_impl: str = "plain", emit: str = "last",
    mesh=None, with_hidden: bool = False,
):
    """(params, tokens, starts, valid, k_pages, v_pages, page_tables,
    write_page, write_off) -> next tokens: the one step behind chunked
    prefill, the prefix cache's suffix prefill and speculative verify.
    tokens [S, C], the first at absolute position starts[s]; valid [S] real
    tokens per row. Each token's K/V is scattered into the slot's pages,
    then the C queries attend causally over the paged prefix including the
    chunk (decode is the C == 1 case).

    emit="last" returns [S] greedy tokens after each slot's last valid
    position (prefill); emit="all" returns [S, C] greedy tokens at every
    position (verify: position i's argmax is the model's next token after
    tokens[:, :i+1], which the host compares against the drafts).
    ``with_hidden`` (draft-head engines) also returns the final hidden
    state: [S, D] at the last valid position for emit="last", [S, C, D] for
    emit="all" (the host keeps the accepted position's)."""
    cuda = decode_impl == "cuda"
    tp = _tp_of(mesh)
    h, kh = _heads(cfg, tp)

    def chunk_step(params, tokens, starts, valid, k_pages, v_pages, page_tables,
                   write_page, write_off):
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        starts = torch.as_tensor(starts).to(dev).int()
        valid = torch.as_tensor(valid).to(dev).int()
        page_tables = torch.as_tensor(page_tables).to(dev).int()
        s, c = tokens.shape
        hd = cfg.head_dim
        positions = starts[:, None] + torch.arange(c, device=dev)[None, :]  # [S, C]
        kv_lens = starts + valid
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][tokens]  # [S, C, D]
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params, "wq", layer, quant).reshape(s, c, h, hd)
            k = _proj(h_in, params, "wk", layer, quant).reshape(s, c, kh, hd)
            v = _proj(h_in, params, "wv", layer, quant).reshape(s, c, kh, hd)
            q = _rope_chunk(q, positions, cfg.rope_theta)
            k = _rope_chunk(k, positions, cfg.rope_theta)
            _scatter_kv(k_pages[layer], index, k)
            _scatter_kv(v_pages[layer], index, v)
            if cuda:
                o = paged_chunk_attention_cuda(
                    q, k_pages[layer], v_pages[layer], page_tables, starts, kv_lens
                )
            else:
                o = paged_chunk_attention(q, k_pages[layer], v_pages[layer], page_tables, starts)
            x = x + _proj(o.to(x.dtype).reshape(s, c, h * hd), params, "wo", layer, quant, tp)
            x = _mlp(x, params, layer, cfg.norm_eps, quant, tp)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        if emit == "last":
            last_idx = (valid.long() - 1).clamp(0, c - 1)
            x = x[torch.arange(s, device=dev), last_idx]  # [S, D]
        out = _logits(x, params, quant, tp).argmax(-1).int()  # [S] or [S, C]
        return (out, x) if with_hidden else out

    return chunk_step


def make_draft_fn(cfg: LlamaConfig, k: int, quant: str = "none", mesh=None):
    """The draft head's proposer (--spec-model, in place of the n-gram
    index): (params, draft, hidden [S, D], last_tokens [S]) -> drafts [S, k]
    int32. Each of the k steps embeds the previous token through the
    target's embed table, applies the head (model.draft_apply) and takes
    the argmax of the target's quant-aware lm_head, so an int8/fp8 engine
    drafts through the quantized lm_head its verify scores with; the head's
    own output conditions the next step, the rollout the distillation
    trained. On a serve mesh the head is whole on every rank and only the
    lm_head logits are all-reduced."""
    tp = _tp_of(mesh)

    def propose(params, draft, hidden, last_tokens):
        h = hidden.to(params["embed"].dtype)
        t = torch.as_tensor(last_tokens).to(h.device).long()
        out = []
        for _ in range(k):
            h = model_lib.draft_apply(draft, h, params["embed"][t], cfg)
            t = _logits(h, params, quant, tp).argmax(-1)
            out.append(t)
        return torch.stack(out, dim=1).int()

    return propose


def _ngram_record(context: List[int], i: int, index: dict, max_n: int = 3) -> None:
    """Token context[i] just arrived: every n-gram ending at i-1 now has a
    continuation starting at i; record it (latest occurrence wins). Grams
    without a continuation are never recorded, so a lookup cannot match the
    trailing gram against itself."""
    for n in range(1, max_n + 1):
        if n > i:
            break
        index[tuple(context[i - n:i])] = i


def _ngram_index(context: List[int], max_n: int = 3) -> dict:
    """Continuation index over a whole context (built at the first draft;
    after that ``_ngram_record`` keeps it in O(max_n) per emitted token)."""
    index: dict = {}
    for i in range(1, len(context)):
        _ngram_record(context, i, index, max_n)
    return index


def propose_from_index(context: List[int], index: dict, k: int, max_n: int = 3) -> List[int]:
    """Self-drafting n-gram proposer (prompt-lookup decoding): the k tokens
    that followed the most recent earlier occurrence of the context's
    trailing n-gram (longest n first), looked up in O(max_n) in the
    context's ``_ngram_index`` instead of a backward scan per slot per step.
    A miss proposes the last token repeated: a draft is only a throughput
    bet, and the verify step keeps the output token-identical to greedy
    whatever is proposed."""
    if k <= 0 or not context:
        return []
    for n in range(min(max_n, len(context) - 1), 0, -1):
        pos = index.get(tuple(context[-n:]))
        if pos is not None:
            drafts = context[pos:pos + k]
            return drafts + [context[-1]] * (k - len(drafts))
    return [context[-1]] * k


class _CacheBlock:
    """One cached full page of KV: the block's hash-chain key, the page id it
    seals, how many live requests reference it, and an LRU stamp."""

    __slots__ = ("key", "page", "refs", "last_used")

    def __init__(self, key, page: int, refs: int, last_used: int) -> None:
        self.key = key
        self.page = page
        self.refs = refs
        self.last_used = last_used


class PrefixCache:
    """Refcounted registry of sealed full-page prompt blocks, keyed by a hash
    chain: block i's key is (parent_key, tuple(block_tokens)), an exact
    match, and a prefix match is a walk down the chain.

    Invariants:
    - a cached page is never written again (registration happens only after
      the owning prefill filled it with prompt tokens, and generation writes
      past the prompt), so sharing needs no copy-on-write: divergence ends
      the match and the request allocates private pages from there;
    - a block with refs > 0 is never evicted (``evict`` frees only LRU blocks
      with refs == 0 and no cached children; a child's users hold refs on
      every ancestor, so a parent cannot be freed under a live child);
    - match() caps at len(prompt) - 1 tokens, so prefill always has at least
      one position left to compute the first output token from.
    """

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self.blocks: Dict[tuple, _CacheBlock] = {}
        self._page_block: Dict[int, _CacheBlock] = {}
        self._children: Dict[tuple, int] = {}  # key -> cached child count
        self._clock = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.blocks)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt: List[int]) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt`` in whole blocks: (page_ids,
        matched_token_count). Takes a reference on every matched block; the
        caller releases them at slot teardown, or at once if admission
        fails."""
        p = self.page_size
        max_blocks = (len(prompt) - 1) // p
        key: Optional[tuple] = None
        matched: List[_CacheBlock] = []
        for b in range(max_blocks):
            key = (key, tuple(prompt[b * p:(b + 1) * p]))
            blk = self.blocks.get(key)
            if blk is None:
                break
            matched.append(blk)
        stamp = self._tick()
        for blk in matched:
            blk.refs += 1
            blk.last_used = stamp
        return [blk.page for blk in matched], len(matched) * p

    def register(self, prompt: List[int], slot_pages: List[int]) -> None:
        """Seal the full prompt blocks of a finished prefill. slot_pages[i]
        holds tokens [i*p, (i+1)*p). The owner keeps using each page, so a
        new block starts at refs = 1; a key already cached is skipped (a
        concurrent duplicate prefill keeps its copy private, freed at
        release like any private page)."""
        p = self.page_size
        key: Optional[tuple] = None
        stamp = self._tick()
        for b in range(len(prompt) // p):
            key = (key, tuple(prompt[b * p:(b + 1) * p]))
            if key in self.blocks:
                continue
            page = slot_pages[b]
            if page in self._page_block:
                # This position is served by a cached page (a matched block).
                continue
            self.blocks[key] = _CacheBlock(key, page, refs=1, last_used=stamp)
            self._page_block[page] = self.blocks[key]
            if key[0] is not None:
                self._children[key[0]] = self._children.get(key[0], 0) + 1

    def release(self, pages: List[int]) -> List[int]:
        """Drop one reference per cached page in ``pages``; returns the pages
        that are not cached (private: the caller frees those). Cached pages
        stay resident at refs == 0 until evicted."""
        private: List[int] = []
        stamp = self._tick()
        for page in pages:
            blk = self._page_block.get(page)
            if blk is None:
                private.append(page)
            else:
                blk.refs -= 1
                blk.last_used = stamp
        return private

    def evictable_count(self) -> int:
        return sum(1 for blk in self.blocks.values() if blk.refs == 0)

    def evict(self, n: int) -> List[int]:
        """Free up to n pages from refs == 0 blocks, LRU first, leaves before
        parents (every refs == 0 subtree has a refs == 0 leaf, so leaf-first
        eviction can always drain it)."""
        freed: List[int] = []
        while len(freed) < n:
            candidates = [
                blk for blk in self.blocks.values()
                if blk.refs == 0 and self._children.get(blk.key, 0) == 0
            ]
            if not candidates:
                break
            victim = min(candidates, key=lambda blk: blk.last_used)
            del self.blocks[victim.key]
            del self._page_block[victim.page]
            parent = victim.key[0]
            if parent is not None:
                self._children[parent] -= 1
                if not self._children[parent]:
                    del self._children[parent]
            freed.append(victim.page)
            self.evictions += 1
        return freed


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n (min lo): the JAX engine's bound on
    distinct prefill shapes, kept so both engines run the same shapes."""
    b = lo
    while b < n:
        b *= 2
    return b


def nearest_rank(sorted_samples, q: float):
    """Nearest-rank percentile over an ascending list (q in [0, 1]); None for
    an empty list."""
    if not sorted_samples:
        return None
    return sorted_samples[min(len(sorted_samples) - 1, int(q * len(sorted_samples)))]


# Histogram families the engine observes (labeled by replica; the step-stage
# family adds a `stage` label) — the JAX engine's names, which the control
# plane's exposition advertises too.
SERVE_HISTOGRAM_HELP = {
    "dstack_tpu_serve_queue_wait_seconds":
        "Engine admission-queue wait (request enqueued -> slot admitted) by replica",
    "dstack_tpu_serve_prefill_seconds":
        "Prefill span (first prefill chunk launched -> first token) by replica",
    "dstack_tpu_serve_ttft_seconds":
        "Engine-side time-to-first-token (enqueued -> first token) by replica",
    "dstack_tpu_serve_itl_seconds":
        "Inter-token latency between consecutive generated tokens by replica",
    "dstack_tpu_serve_decode_tokens_per_s":
        "Per-request decode throughput (generated tokens over the decode span) by replica",
    "dstack_tpu_serve_step_stage_seconds":
        "Engine step time split by stage (admit/prefill/decode) by replica",
}


def _replica_label() -> str:
    """This replica's metric label: the orchestrator's replica env, the host
    rank, or "0" for a bare engine."""
    return (
        os.environ.get("DSTACK_TPU_REPLICA")
        or os.environ.get("DSTACK_NODE_RANK")
        or "0"
    )


class FlightRecorder:
    """Bounded ring of completed request traces, plus a same-sized ring of
    requests slower than a threshold, so a burst of fast requests cannot
    evict the slow trace an operator is hunting (GET /debug/traces)."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        slow_threshold: Optional[float] = None,
    ) -> None:
        if capacity is None:
            capacity = int(os.environ.get("DSTACK_TPU_FLIGHT_RECORDER_SIZE", "128"))
        if slow_threshold is None:
            slow_threshold = float(os.environ.get("DSTACK_TPU_FLIGHT_SLOW_SECONDS", "2.0"))
        self.capacity = max(int(capacity), 1)
        self.slow_threshold = float(slow_threshold)
        self._recent: Deque[dict] = collections.deque(maxlen=self.capacity)
        self._slow: Deque[dict] = collections.deque(maxlen=self.capacity)
        self._seq = 0
        self._lock = threading.Lock()

    def record(self, trace: dict) -> None:
        with self._lock:
            self._seq += 1
            trace = dict(trace, seq=self._seq)
            trace["slow"] = trace.get("total_s", 0.0) >= self.slow_threshold
            self._recent.append(trace)
            if trace["slow"]:
                self._slow.append(trace)

    def snapshot(
        self,
        request_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> List[dict]:
        """Newest-first merged view (recent ring + retained slow traces,
        deduplicated), optionally filtered by request id or trace id."""
        with self._lock:
            merged = {t["seq"]: t for t in self._slow}
            merged.update({t["seq"]: t for t in self._recent})
        out = [merged[s] for s in sorted(merged, reverse=True)]
        if request_id is not None:
            out = [t for t in out if t.get("req_id") == request_id]
        if trace_id is not None:
            out = [t for t in out if t.get("trace_id") == trace_id]
        if limit is not None:
            out = out[: max(int(limit), 0)]
        return out

    def latency_summary(self) -> dict:
        """TTFT/ITL p50/p99 (ms) over the recent ring."""
        with self._lock:
            records = list(self._recent)
        ttfts = sorted(t["ttft_s"] for t in records if t.get("ttft_s") is not None)
        itls = sorted(ms / 1000.0 for t in records for ms in (t.get("itl_ms") or ()))
        out: dict = {}
        if ttfts:
            out["ttft_p50_ms"] = round(nearest_rank(ttfts, 0.50) * 1000, 2)
            out["ttft_p99_ms"] = round(nearest_rank(ttfts, 0.99) * 1000, 2)
        if itls:
            out["itl_p50_ms"] = round(nearest_rank(itls, 0.50) * 1000, 2)
            out["itl_p99_ms"] = round(nearest_rank(itls, 0.99) * 1000, 2)
        return out


class ServeEngine:
    """Host-side continuous-batching loop over the prefill/decode step
    functions.

    Not thread-safe except for ``submit``/gauge reads (``EngineRunner`` is
    the one caller of ``step``). All scheduling state — free pages, page
    tables, slot occupancy — lives on the host; the device sees fixed-shape
    decode batches and bucketed prefill shapes. ``device`` defaults to the
    CUDA card and raises where there is none; tests pass ``device="cpu"``.
    ``params`` is the ``init_params`` tree or, under a weight-only ``quant``,
    may already be the ``quantize_serve_params`` layout; ``self.params`` is
    the tree the step functions read (quantized under ``quant``: the fp tree
    is not kept). ``draft_params`` (``model.init_draft_params``' tree, or
    ``load_draft_params``') makes the draft head the proposer of
    speculative decode, which then needs ``spec_tokens > 0``.

    ``mesh`` (``sharding.make_serve_mesh``, connected) puts this engine on
    one rank of a serve mesh: ``params`` may be the
    whole tree (cut here to the rank's pieces) or already the pieces
    (``load_serve_params(mesh=...)``); without ``params`` each rank draws the
    meshless synthetic tree and keeps its pieces. Every rank of the mesh
    must build the same engine and make the same calls in the same order
    (``StepSync``).
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        engine_cfg: Optional[EngineConfig] = None,
        params: Optional[dict] = None,
        seed: int = 0,
        device: DeviceLike = None,
        mesh=None,
        draft_params: Optional[dict] = None,
    ) -> None:
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.mesh = mesh
        if mesh is not None:
            sharding.validate_serve_mesh(cfg, mesh)
        if draft_params is not None and self.ecfg.spec_tokens <= 0:
            raise ValueError(
                "draft_params given but spec_tokens == 0 - the draft head only"
                " proposes inside speculative decode (--spec-tokens k)"
            )
        if self.ecfg.policy not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling policy {self.ecfg.policy!r}")
        if self.ecfg.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = whole-prompt prefill), got"
                f" {self.ecfg.prefill_chunk}"
            )
        if self.ecfg.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0 (0 = one token per step), got"
                f" {self.ecfg.spec_tokens}"
            )
        if self.ecfg.prefix_cache and self.ecfg.num_pages < 2:
            raise ValueError(
                "prefix_cache needs a page pool of at least 2 (one cacheable"
                " block plus the active tail)"
            )
        quant = self.ecfg.quant
        quant_lib.check_quant(quant)
        self.device = resolve_device(device)
        self.decode_impl = resolve_decode_impl(self.ecfg.decode_impl, self.device)
        if self.decode_impl == "cuda":
            require_sm90(self.device)
        adt = model_lib.dtype_of(cfg.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init_params(cfg, gen, self.device, dtype=adt, mesh=mesh)
        elif mesh is not None:
            params = shard_serve_params(params, cfg, mesh)
        # Weight-only int8/fp8: quantize once here, unless the tree is already
        # in that layout (re-quantizing quantized values would be wrong).
        if quant_lib.is_weight_only(quant) and "lm_head_q" not in params:
            params = quantize_serve_params(params, mode=quant, mesh=mesh)
        missing = [k for k in _serve_layer_keys(quant) if k not in params]
        if missing:
            raise ValueError(f"params lack {missing} for quant={quant!r}")
        self.params = _place(params, self.device, adt)
        # The draft head proposes from the target's last hidden state, so
        # every step that advances a slot (prefill, chunk prefill, verify)
        # hands that state back; without a head they return tokens only.
        self._use_draft = draft_params is not None
        self.draft_params = _place(draft_params, self.device, adt) if self._use_draft else None

        hidden = self._use_draft
        self._prefill_fn = make_prefill_fn(cfg, quant, mesh, with_hidden=hidden)
        self._decode_fn = make_decode_fn(cfg, quant, self.decode_impl, mesh)
        # Tier-2 prefill (chunked and/or cache-hit suffix) replaces the
        # whole-prompt prefill path.
        self._tier2_prefill = self.ecfg.prefill_chunk > 0 or self.ecfg.prefix_cache
        if self._tier2_prefill:
            self._chunk_fn = make_chunk_fn(cfg, quant, self.decode_impl, "last", mesh, hidden)
        if self.ecfg.spec_tokens > 0:
            self._verify_fn = make_chunk_fn(cfg, quant, self.decode_impl, "all", mesh, hidden)
        if self._use_draft:
            self._draft_fn = make_draft_fn(cfg, self.ecfg.spec_tokens, quant, mesh)
        self._cache = PrefixCache(self.ecfg.page_size) if self.ecfg.prefix_cache else None

        page, pool = self.ecfg.page_size, self.ecfg.num_pages
        max_seq = self.ecfg.max_seq or cfg.max_seq_len
        self.max_seq = max_seq
        self.table_width = -(-max_seq // page)  # pages per sequence, ceil
        # The pools hold this rank's KV heads (SERVE_PAGE_SPEC).
        shape = (cfg.n_layers, pool, page, _heads(cfg, _tp_of(mesh))[1], cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=adt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=adt, device=self.device)

        self._free: List[int] = list(range(pool))
        mb = self.ecfg.max_batch
        self.page_tables = np.zeros((mb, self.table_width), np.int32)
        self.seq_lens = np.zeros(mb, np.int64)       # KV positions stored
        self.last_tokens = np.zeros(mb, np.int32)    # last emitted token
        # The target's hidden state behind each slot's last token: what the
        # draft head conditions on. Set by prefill and by every verify step;
        # a stale row is harmless, as it is rewritten before its next use.
        if self._use_draft:
            self.last_hidden = torch.zeros((mb, cfg.d_model), dtype=adt, device=self.device)
        self.slots: List[Optional[GenRequest]] = [None] * mb
        self.slot_pages: List[List[int]] = [[] for _ in range(mb)]

        self.pending: Deque[GenRequest] = collections.deque()
        self._lock = threading.Lock()
        self._req_counter = 0
        self.replica = _replica_label()
        self.flight = FlightRecorder()
        self.total_steps = 0
        self.total_tokens = 0
        self.total_finished = 0
        self.total_preemptions = 0
        self.total_prefix_lookup_tokens = 0  # prompt tokens through admission
        self.total_prefix_hit_tokens = 0     # of those, served from the cache
        self.total_spec_proposed = 0         # draft tokens sent to verify
        self.total_spec_accepted = 0         # of those, accepted
        self.total_spec_fallbacks = 0        # requests switched draft -> n-gram
        # Per-slot-per-step (proposed, accepted) samples behind
        # spec_accept_rate_windowed.
        self._spec_recent: Deque[Tuple[int, int]] = collections.deque(
            maxlen=max(self.ecfg.spec_window, 1)
        )

    # -- submission (thread-safe) -----------------------------------------

    def submit(
        self,
        prompt_tokens: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        req_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> GenRequest:
        return self.enqueue(self.make_request(prompt_tokens, max_new_tokens, eos_id, req_id,
                                              trace_id))

    def enqueue(self, req: GenRequest) -> GenRequest:
        """Queue a request made by ``make_request`` (FIFO)."""
        with self._lock:
            self.pending.append(req)
        return req

    def make_request(
        self,
        prompt_tokens: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        req_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> GenRequest:
        """A checked request, stamped now, not yet queued: ``submit`` without
        the queueing, which a serve mesh's rank 0 leaves to the next step's
        message (``EngineRunner``)."""
        if not prompt_tokens:
            raise ValueError("empty prompt")
        max_new = max_new_tokens or self.ecfg.max_new_default
        if len(prompt_tokens) + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt_tokens)}) + max_new_tokens ({max_new})"
                f" exceeds the engine's max_seq {self.max_seq}"
            )
        need = -(-(len(prompt_tokens) + max_new) // self.ecfg.page_size)
        if need > self.ecfg.num_pages:
            raise ValueError("request larger than the whole page pool")
        with self._lock:
            if req_id is None:
                self._req_counter += 1
                req_id = f"req-{self._req_counter}"
        return GenRequest(
            req_id=req_id,
            prompt=list(prompt_tokens),
            max_new_tokens=max_new,
            eos_id=eos_id if eos_id is not None else self.ecfg.eos_id,
            submitted_t=time.monotonic(),
            trace_id=trace_id or tracing.current_trace_id(),
        )

    # -- gauges ------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.pending)

    @property
    def active_count(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        return bool(self.pending) or self.active_count > 0

    @property
    def available_pages(self) -> int:
        """Pages the allocator can produce right now: the free list plus
        refs == 0 cache blocks it may evict."""
        n = len(self._free)
        if self._cache is not None:
            n += self._cache.evictable_count()
        return n

    @property
    def mesh_desc(self) -> str:
        """"ddNxtpM" for a sharded engine, "" for the meshless one."""
        return self.mesh.describe() if self.mesh is not None else ""

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix cache."""
        return self.total_prefix_hit_tokens / max(self.total_prefix_lookup_tokens, 1)

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of proposed draft tokens the verify step accepted."""
        return self.total_spec_accepted / max(self.total_spec_proposed, 1)

    @property
    def spec_accept_rate_windowed(self) -> float:
        """Accept rate over the last spec_window spec steps: what the
        proposer does now, where the lifetime rate dilutes a cold streak with
        history. 0.0 before any spec step."""
        proposed = sum(p for p, _ in self._spec_recent)
        if proposed == 0:
            return 0.0
        return sum(a for _, a in self._spec_recent) / proposed

    def stats(self) -> Dict[str, float]:
        return {
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "free_pages": self.free_pages,
            "available_pages": self.available_pages,
            "total_pages": self.ecfg.num_pages,
            "max_batch": self.ecfg.max_batch,
            "steps": self.total_steps,
            "generated_tokens": self.total_tokens,
            "finished_requests": self.total_finished,
            "preemptions": self.total_preemptions,
            "policy": self.ecfg.policy,
            "decode_impl": self.decode_impl,
            "quant": self.ecfg.quant,
            "mesh": self.mesh_desc,
            "prefill_chunk": self.ecfg.prefill_chunk,
            "prefix_cache": int(self.ecfg.prefix_cache),
            "spec_tokens": self.ecfg.spec_tokens,
            "cached_pages": len(self._cache) if self._cache else 0,
            "prefix_evictions": self._cache.evictions if self._cache else 0,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "spec_accept_rate": round(self.spec_accept_rate, 4),
            "spec_accept_rate_windowed": round(self.spec_accept_rate_windowed, 4),
            "spec_proposer": "draft" if self._use_draft else "ngram",
            "spec_fallbacks": self.total_spec_fallbacks,
        }

    # -- the step loop -----------------------------------------------------

    def step(self) -> List[TokenEvent]:
        """One engine iteration: admit -> prefill (whole-prompt, or one chunk
        per mid-prefill slot) -> one decode step (one token, or draft +
        verify with spec_tokens). Returns the tokens emitted this step, in
        emission order."""
        events: List[TokenEvent] = []
        # Step-stage attribution (host wall time; each _run_* ends by copying
        # its tokens to the host, which waits for the device).
        labels = {"replica": self.replica}
        t0 = time.monotonic()
        admitted = self._admit()
        t_admit = time.monotonic()
        if admitted:
            tracing.observe(
                "dstack_tpu_serve_step_stage_seconds", t_admit - t0,
                {**labels, "stage": "admit"},
            )
        prefilled = False
        if not self._tier2_prefill:
            if admitted:
                self._run_prefill(admitted, events)
                prefilled = True
        elif any(self._prefilling(s) for s in range(self.ecfg.max_batch)):
            self._run_chunk_prefill(events)
            prefilled = True
        t_prefill = time.monotonic()
        if prefilled:
            tracing.observe(
                "dstack_tpu_serve_step_stage_seconds", t_prefill - t_admit,
                {**labels, "stage": "prefill"},
            )
        decoding = [
            s for s, r in enumerate(self.slots)
            if r is not None and not self._prefilling(s)
        ]
        if decoding:
            if self.ecfg.spec_tokens > 0:
                self._run_spec_decode(decoding, events)
            else:
                self._run_decode(decoding, events)
            tracing.observe(
                "dstack_tpu_serve_step_stage_seconds",
                time.monotonic() - t_prefill, {**labels, "stage": "decode"},
            )
        self.total_steps += 1
        return events

    def _prefilling(self, slot: int) -> bool:
        req = self.slots[slot]
        return req is not None and req.pos < len(req.prompt)

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.ecfg.page_size)

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages from the free list, evicting LRU refs == 0 cache
        blocks to refill it if needed; None (nothing taken, nothing evicted)
        when the pool cannot produce n pages. Eviction runs only when it can
        satisfy the request: a failed allocation leaves its caller blocked
        either way, and destroying cached prefixes for it would cost every
        later sharer a re-prefill."""
        if len(self._free) < n and self._cache is not None:
            if len(self._free) + self._cache.evictable_count() >= n:
                self._free.extend(self._cache.evict(n - len(self._free)))
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _admit(self) -> List[Tuple[int, GenRequest]]:
        """Move queued requests into free slots (FIFO, head-of-line blocking
        when pages are short). Static policy: only admit into an EMPTY batch.
        With the prefix cache, the prompt's longest cached block-prefix
        arrives as shared pages and only the suffix needs fresh ones."""
        if self.ecfg.policy == "static" and self.active_count:
            return []
        admitted: List[Tuple[int, GenRequest]] = []
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        while free_slots:
            with self._lock:
                if not self.pending:
                    break
                req = self.pending[0]
                shared_pages: List[int] = []
                matched = 0
                if self._cache is not None:
                    shared_pages, matched = self._cache.match(req.prompt)
                # Reserve the prompt plus one decode page of headroom; growth
                # beyond that allocates on demand (preempting if dry).
                need = self._pages_for(len(req.prompt) + 1) - len(shared_pages)
                new_pages = self._try_alloc(need)
                if new_pages is None:
                    if shared_pages:  # roll back the match's references
                        self._free.extend(self._cache.release(shared_pages))
                    break
                self.pending.popleft()
            slot = free_slots.pop(0)
            pages = shared_pages + new_pages
            self.slot_pages[slot] = pages
            row = self.page_tables[slot]
            row[:] = 0
            row[: len(pages)] = pages
            self.seq_lens[slot] = matched
            req.pos = matched
            req.cached_tokens = matched
            if req.preemptions == 0:
                # A preemption resume re-matches its own sealed blocks:
                # counting that as a hit would inflate the hit rate exactly
                # when the pool is under pressure.
                self.total_prefix_lookup_tokens += len(req.prompt)
                self.total_prefix_hit_tokens += matched
            if req.admitted_t == 0.0:
                # First admission only: a preemption re-admission is decode
                # backpressure, not queue wait.
                req.admitted_t = time.monotonic()
                tracing.observe(
                    "dstack_tpu_serve_queue_wait_seconds",
                    req.admitted_t - req.submitted_t,
                    {"replica": self.replica},
                )
            self.slots[slot] = req
            admitted.append((slot, req))
        return admitted

    def _run_prefill(
        self, admitted: List[Tuple[int, GenRequest]], events: List[TokenEvent]
    ) -> None:
        page = self.ecfg.page_size
        pool = self.ecfg.num_pages
        now = time.monotonic()
        for _, req in admitted:
            if req.prefill_start_t == 0.0:
                req.prefill_start_t = now
        t_pad = _bucket(max(len(req.prompt) for _, req in admitted))
        b_pad = _bucket(len(admitted), lo=1)
        tokens = np.zeros((b_pad, t_pad), np.int32)
        lens = np.zeros(b_pad, np.int32)
        # pool-sized page index = dropped write: padding (and padded batch
        # rows) never lands in the cache.
        write_page = np.full((b_pad, t_pad), pool, np.int32)
        write_off = np.zeros((b_pad, t_pad), np.int32)
        for i, (slot, req) in enumerate(admitted):
            n = len(req.prompt)
            tokens[i, :n] = req.prompt
            lens[i] = n
            pos = np.arange(n)
            pages = np.asarray(self.slot_pages[slot], np.int32)
            write_page[i, :n] = pages[pos // page]
            write_off[i, :n] = pos % page

        out = self._prefill_fn(
            self.params, tokens, self.k_pages, self.v_pages, write_page, write_off, lens
        )
        if self._use_draft:
            out, hidden = out
            self._set_hidden([slot for slot, _ in admitted], hidden[: len(admitted)])
        next_tokens = out.cpu().numpy()
        for i, (slot, req) in enumerate(admitted):
            self.seq_lens[slot] = len(req.prompt)
            req.pos = len(req.prompt)
            self._emit(slot, req, int(next_tokens[i]), events)

    def _run_chunk_prefill(self, events: List[TokenEvent]) -> None:
        """Advance every mid-prefill slot by one chunk of at most
        prefill_chunk tokens (without chunking, a cache-hit suffix in one
        bucketed chunk). The final chunk's last-position argmax is the
        request's first generated token; its full prompt blocks then enter
        the prefix cache."""
        page = self.ecfg.page_size
        pool = self.ecfg.num_pages
        slots = [s for s in range(self.ecfg.max_batch) if self._prefilling(s)]
        if not slots:
            return
        remaining = {s: len(self.slots[s].prompt) - self.slots[s].pos for s in slots}
        chunk = self.ecfg.prefill_chunk or _bucket(max(remaining.values()), lo=8)
        s_pad = _bucket(len(slots), lo=1)
        tokens = np.zeros((s_pad, chunk), np.int32)
        starts = np.zeros(s_pad, np.int32)
        valid = np.zeros(s_pad, np.int32)
        write_page = np.full((s_pad, chunk), pool, np.int32)
        write_off = np.zeros((s_pad, chunk), np.int32)
        tables = np.zeros((s_pad, self.table_width), np.int32)
        now = time.monotonic()
        for i, slot in enumerate(slots):
            req = self.slots[slot]
            if req.prefill_start_t == 0.0:
                req.prefill_start_t = now  # first chunk of this request
            n = min(chunk, remaining[slot])
            tokens[i, :n] = req.prompt[req.pos:req.pos + n]
            starts[i] = req.pos
            valid[i] = n
            pos = req.pos + np.arange(n)
            pages = np.asarray(self.slot_pages[slot], np.int32)
            write_page[i, :n] = pages[pos // page]
            write_off[i, :n] = pos % page
            tables[i] = self.page_tables[slot]

        out = self._chunk_fn(
            self.params, tokens, starts, valid, self.k_pages, self.v_pages,
            tables, write_page, write_off,
        )
        hidden = None
        if self._use_draft:
            out, hidden = out
        next_tokens = out.cpu().numpy()
        for i, slot in enumerate(slots):
            req = self.slots[slot]
            req.pos += int(valid[i])
            self.seq_lens[slot] = req.pos
            if req.pos < len(req.prompt):
                continue  # more chunks to go; nothing emitted yet
            if self._cache is not None:
                self._cache.register(req.prompt, self.slot_pages[slot])
            if hidden is not None:
                # The final chunk's last valid position is the prompt's last
                # token: the state the head conditions on next.
                self._set_hidden([slot], hidden[i:i + 1])
            self._emit(slot, req, int(next_tokens[i]), events)

    def _run_decode(self, decoding: List[int], events: List[TokenEvent]) -> None:
        page = self.ecfg.page_size
        pool = self.ecfg.num_pages
        mb = self.ecfg.max_batch
        self._ensure_decode_pages(decoding)
        write_page = np.full(mb, pool, np.int32)
        write_off = np.zeros(mb, np.int32)
        active = []
        for slot in decoding:
            if self.slots[slot] is None:  # preempted by _ensure_decode_pages
                continue
            pos = int(self.seq_lens[slot])
            write_page[slot] = self.page_tables[slot, pos // page]
            write_off[slot] = pos % page
            active.append(slot)
        if not active:
            return

        next_tokens = self._decode_fn(
            self.params, self.last_tokens, self.seq_lens.astype(np.int32),
            self.k_pages, self.v_pages, self.page_tables, write_page, write_off,
        ).cpu().numpy()
        for slot in active:
            req = self.slots[slot]
            self.seq_lens[slot] += 1  # the last token's KV just landed
            self._emit(slot, req, int(next_tokens[slot]), events)

    def _run_spec_decode(self, decoding: List[int], events: List[TokenEvent]) -> None:
        """Draft + verify decode step: each slot's row is [last_token,
        d1..dk] at positions seq_len..seq_len+k; one chunk step scores all of
        them, and position i's argmax is the model's next token after the
        row's first i+1 tokens. Greedy accept runs left to right: draft
        d_{i+1} is accepted iff it equals argmax_i; the first mismatch emits
        the correction instead. Every emitted token is what one-token greedy
        decode would emit; speculation changes only how many land a step.
        Rejected positions' K/V stays in the pages but is never read: seq_len
        advances only past accepted tokens, and the next step rewrites those
        positions before attending."""
        page = self.ecfg.page_size
        pool = self.ecfg.num_pages
        mb = self.ecfg.max_batch
        c = self.ecfg.spec_tokens + 1
        # Clip each slot's row to the tokens it may still emit: emitted per
        # step <= valid, and submit() holds prompt + max_new <= max_seq, so
        # seq_len + valid never crosses the page-table width either.
        valid = np.zeros(mb, np.int32)
        for slot in decoding:
            req = self.slots[slot]
            valid[slot] = min(c, req.max_new_tokens - len(req.tokens))
        self._ensure_decode_pages(decoding, extra=valid)
        # The draft head proposes for every slot in one batched call (rows of
        # preempted or fallen-back slots are computed and ignored).
        draft_rows = None
        if self._use_draft and any(
            self.slots[s] is not None and self.slots[s].draft_ok for s in decoding
        ):
            draft_rows = self._draft_fn(
                self.params, self.draft_params, self.last_hidden, self.last_tokens
            ).cpu().numpy()  # [mb, k]
        tokens = np.zeros((mb, c), np.int32)
        starts = np.zeros(mb, np.int32)
        write_page = np.full((mb, c), pool, np.int32)
        write_off = np.zeros((mb, c), np.int32)
        active = []
        drafts: Dict[int, List[int]] = {}
        used_draft = set()
        for slot in decoding:
            req = self.slots[slot]
            if req is None:  # preempted by _ensure_decode_pages
                continue
            n = int(valid[slot])
            row = [int(self.last_tokens[slot])]
            if n > 1 and draft_rows is not None and req.draft_ok:
                row += [int(t) for t in draft_rows[slot, : n - 1]]
                used_draft.add(slot)
            elif n > 1:
                if req.spec_ctx is None:
                    # prompt + tokens[absorbed:] is the emitted stream with
                    # each token once (a preemption refold already moved
                    # tokens[:absorbed] into the prompt).
                    req.spec_ctx = list(req.prompt) + list(req.tokens[req.absorbed:])
                    req.spec_index = _ngram_index(req.spec_ctx)
                row += propose_from_index(req.spec_ctx, req.spec_index, n - 1)
            drafts[slot] = row[1:]
            tokens[slot, :n] = row
            starts[slot] = self.seq_lens[slot]
            pos = int(self.seq_lens[slot]) + np.arange(n)
            pages = np.asarray(self.slot_pages[slot], np.int32)
            write_page[slot, :n] = pages[pos // page]
            write_off[slot, :n] = pos % page
            active.append(slot)
        if not active:
            return

        out = self._verify_fn(
            self.params, tokens, starts, valid, self.k_pages, self.v_pages,
            self.page_tables, write_page, write_off,
        )
        hidden = None
        if self._use_draft:
            out, hidden = out  # hidden [mb, c, D]
        out_tokens = out.cpu().numpy()  # [mb, c]
        kept = []
        for slot in active:
            req = self.slots[slot]
            n = int(valid[slot])
            row_drafts = drafts[slot]
            accepted = 0
            while accepted < n - 1 and row_drafts[accepted] == int(out_tokens[slot, accepted]):
                accepted += 1
            emitted = row_drafts[:accepted] + [int(out_tokens[slot, accepted])]
            self.total_spec_proposed += n - 1
            self.total_spec_accepted += accepted
            req.spec_proposed += n - 1
            req.spec_accepted += accepted
            self._spec_recent.append((n - 1, accepted))
            if hidden is not None:
                kept.append((slot, accepted))
                if slot in used_draft:
                    self._track_draft_accept(req, n - 1, accepted)
            # The accepted row positions' K/V (0..accepted) just landed; the
            # emitted tail token is not yet written.
            self.seq_lens[slot] += accepted + 1
            for token in emitted:
                self._emit(slot, req, token, events)
                if req.done:
                    break
        if kept:
            # Row position `accepted` is the target's state after every
            # token it kept: the conditioning of the slot's next proposal.
            slots, rows = zip(*kept)
            self._set_hidden(list(slots), hidden[list(slots), list(rows)])

    def _set_hidden(self, slots: List[int], hidden: torch.Tensor) -> None:
        """last_hidden[slots] = hidden (rows in the same order)."""
        index = torch.tensor(slots, device=self.device)
        self.last_hidden.index_copy_(0, index, hidden.to(self.last_hidden.dtype))

    def _track_draft_accept(self, req: GenRequest, proposed: int, accepted: int) -> None:
        """Per-request windowed accept tracking behind the draft -> n-gram
        fallback: judged only once the window is full, and permanent for the
        request (flapping would churn the n-gram index for nothing). A
        threshold <= 0 disables it."""
        if self.ecfg.spec_fallback_threshold <= 0:
            return
        if req.spec_recent is None:
            req.spec_recent = collections.deque(maxlen=max(self.ecfg.spec_fallback_window, 1))
        req.spec_recent.append((proposed, accepted))
        if len(req.spec_recent) < req.spec_recent.maxlen:
            return
        total_p = sum(p for p, _ in req.spec_recent)
        total_a = sum(a for _, a in req.spec_recent)
        if total_p > 0 and total_a / total_p < self.ecfg.spec_fallback_threshold:
            req.draft_ok = False
            self.total_spec_fallbacks += 1

    def _ensure_decode_pages(
        self, decoding: List[int], extra: Optional[np.ndarray] = None
    ) -> None:
        """Every decoding slot about to write position seq_len (through
        seq_len + extra - 1 under speculation) needs those positions' pages;
        a dry pool (free list and evictable cache blocks) preempts the
        youngest request (fewest generated tokens) back to the queue, so its
        pages fund the older requests and it re-prefills later from prompt +
        generated."""
        page = self.ecfg.page_size
        for slot in decoding:
            if self.slots[slot] is None:
                continue
            last_pos = int(self.seq_lens[slot])
            if extra is not None:
                last_pos += max(int(extra[slot]) - 1, 0)
            need_idx = last_pos // page
            while need_idx >= len(self.slot_pages[slot]):
                got = self._try_alloc(1)
                if got is None:
                    victim = self._pick_victim(exclude=slot)
                    if victim is None:
                        # Nothing to steal from: this slot itself is the
                        # youngest; requeue it.
                        self._preempt(slot)
                        break
                    self._preempt(victim)
                    continue
                self.slot_pages[slot].extend(got)
                self.page_tables[slot, len(self.slot_pages[slot]) - 1] = got[0]

    def _pick_victim(self, exclude: int) -> Optional[int]:
        candidates = [
            (len(req.tokens), slot)
            for slot, req in enumerate(self.slots)
            if req is not None and slot != exclude
        ]
        if not candidates:
            return None
        return min(candidates)[1]

    def _preempt(self, slot: int) -> None:
        req = self.slots[slot]
        logger.info(
            "engine: preempting %s (%d generated) — page pool dry",
            req.req_id, len(req.tokens),
        )
        req.preemptions += 1
        self.total_preemptions += 1
        # The resume prompt carries every generated token exactly once, however
        # many times this request is preempted.
        req.prompt = req.prompt + req.tokens[req.absorbed:]
        req.absorbed = len(req.tokens)
        self._release_slot(slot)
        with self._lock:
            self.pending.appendleft(req)

    def _emit(
        self, slot: int, req: GenRequest, token: int, events: List[TokenEvent]
    ) -> None:
        req.tokens.append(token)
        now = time.monotonic()
        req.token_times.append(now)
        labels = {"replica": self.replica}
        if len(req.tokens) == 1:
            # First generated token = prefill done: TTFT and the prefill span.
            req.first_token_t = now
            tracing.observe("dstack_tpu_serve_ttft_seconds", now - req.submitted_t, labels)
            if req.prefill_start_t:
                tracing.observe(
                    "dstack_tpu_serve_prefill_seconds", now - req.prefill_start_t, labels
                )
        else:
            tracing.observe(
                "dstack_tpu_serve_itl_seconds", now - req.token_times[-2], labels
            )
        if req.spec_ctx is not None:
            req.spec_ctx.append(token)
            _ngram_record(req.spec_ctx, len(req.spec_ctx) - 1, req.spec_index)
        self.total_tokens += 1
        done = (
            len(req.tokens) >= req.max_new_tokens
            or (req.eos_id is not None and token == req.eos_id)
        )
        events.append(TokenEvent(req.req_id, token, len(req.tokens) - 1, done))
        if done:
            req.done = True
            req.finished_t = now
            self.total_finished += 1
            decode_s = now - req.first_token_t
            if len(req.tokens) > 1 and decode_s > 0:
                tracing.observe(
                    "dstack_tpu_serve_decode_tokens_per_s",
                    (len(req.tokens) - 1) / decode_s, labels,
                )
            self.flight.record(self._request_trace(req))
            self._release_slot(slot)
        else:
            self.last_tokens[slot] = token

    def _request_trace(self, req: GenRequest) -> dict:
        """The flight-recorder record for a completed request (the JAX
        engine's keys): stage spans as durations, per-token gaps and the
        request's cache and speculation counts."""
        ttft = req.first_token_t - req.submitted_t
        return {
            "req_id": req.req_id,
            "trace_id": req.trace_id,
            "replica": self.replica,
            "finished_at": time.time(),
            "queue_wait_s": round(req.admitted_t - req.submitted_t, 6),
            "prefill_s": round(
                req.first_token_t - req.prefill_start_t, 6
            ) if req.prefill_start_t else 0.0,
            "ttft_s": round(ttft, 6),
            "decode_s": round(req.finished_t - req.first_token_t, 6),
            "total_s": round(req.finished_t - req.submitted_t, 6),
            "prompt_tokens": len(req.prompt) - req.absorbed,
            "cached_tokens": req.cached_tokens,
            "tokens": len(req.tokens),
            "preemptions": req.preemptions,
            "spec_proposed": req.spec_proposed,
            "spec_accepted": req.spec_accepted,
            "itl_ms": [
                round((b - a) * 1000, 3)
                for a, b in zip(req.token_times, req.token_times[1:])
            ],
        }

    def _release_slot(self, slot: int) -> None:
        if self._cache is not None:
            # Cached pages stay resident at refs == 0 (LRU-evictable); only
            # private pages return to the free list.
            self._free.extend(self._cache.release(self.slot_pages[slot]))
        else:
            self._free.extend(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_tables[slot, :] = 0
        self.seq_lens[slot] = 0
        self.last_tokens[slot] = 0
        self.slots[slot] = None


# ---------------------------------------------------------------------------
# Reference decoding: full-context greedy decode, no cache.


def greedy_reference_decode(
    params: dict,
    cfg: LlamaConfig,
    prompt: List[int],
    max_new_tokens: int,
    eos_id: Optional[int] = None,
) -> List[int]:
    """O(T^2) greedy decode re-running the full forward per token — the
    ground truth the paged engine must match token for token."""
    toks = list(prompt)
    out: List[int] = []
    for _ in range(max_new_tokens):
        logits = model_lib.forward(params, torch.tensor([toks]), cfg)
        nxt = int(logits[0, -1].argmax())
        out.append(nxt)
        if eos_id is not None and nxt == eos_id:
            break
        toks.append(nxt)
    return out


# ---------------------------------------------------------------------------
# Byte-level "tokenizer" for the HTTP surface: the engine serves synthetic
# weights, so the contract is tokens in/tokens out; text is a convenience.


def encode_text(text: str, vocab_size: int) -> List[int]:
    return [b % vocab_size for b in text.encode("utf-8")] or [0]


def decode_token(token: int) -> str:
    return chr(token) if 0x20 <= token < 0x7F else ""


# ---------------------------------------------------------------------------
# Agreement between the ranks of a serve mesh.


class StepSync:
    """Keeps the ranks of a serve mesh in step. The JAX engine is one
    controller driving every device; the port runs one process a rank, each
    with its own ``ServeEngine`` (page allocator, prefix cache, preemption,
    proposers), and a collective of one step function hangs unless every
    rank calls it. So rank 0, which alone serves HTTP, broadcasts at the top
    of every iteration of its loop a step message: the requests submitted
    since the last one, in order, or a stop. Every rank queues them in that
    order and steps exactly when rank 0 does (``has_work`` reads the same
    state on each). Host time decides nothing in the engine (it only stamps
    requests), and the greedy tokens come from logits all-reduced to the
    same values everywhere, so the engines stay identical; ``check`` holds
    them to it after each step. Messages travel on the mesh's gloo group on
    the CPU; a mesh of one rank without a process group has nothing to
    send."""

    def __init__(self, mesh: sharding.Mesh) -> None:
        self.group = mesh.host_group()

    def exchange(self, message: Optional[dict] = None) -> dict:
        """Rank 0's ``message`` on every rank (a collective)."""
        if self.group is None:
            return message
        box = [message]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def check(self, events: List[TokenEvent]) -> None:
        """Raise on every rank unless every rank emitted the same tokens
        for the same requests this step (a collective)."""
        if self.group is None:
            return
        mine = [(ev.req_id, int(ev.token), ev.done) for ev in events]
        every = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(every, mine, group=self.group)
        if any(got != every[0] for got in every):
            raise RuntimeError(
                "the ranks of the serve mesh emitted different tokens in one step: "
                + "; ".join(f"rank {r}: {got}" for r, got in enumerate(every))
            )


def follow(engine: ServeEngine, sync: StepSync) -> None:
    """The loop of a serve mesh's ranks other than 0: take each step message,
    queue its requests in order, and step when there is work, until the
    stop. A failed step or a disagreement raises, and the process exits
    non-zero."""
    while True:
        message = sync.exchange()
        if message["stop"]:
            return
        for req_id, prompt, max_new, eos_id in message["requests"]:
            engine.submit(prompt, max_new, eos_id=eos_id, req_id=req_id)
        if engine.has_work():
            sync.check(engine.step())


# ---------------------------------------------------------------------------
# Engine thread + aiohttp app (the runnable service behind the proxy).


class EngineRunner(threading.Thread):
    """Owns the step loop on a background thread; bridges token events into
    per-request callbacks (asyncio consumers wrap them with
    ``loop.call_soon_threadsafe``). Device work blocks, so it must not run on
    the event loop: while the device decodes, the loop streams tokens out.

    With ``sync`` the runner is rank 0 of a serve mesh: a submitted request
    waits in an inbox until the top of the next iteration, whose step message
    (``StepSync.exchange``) carries it to every rank; an idle iteration
    sends an empty message each ``idle_wait``, so the other ranks never sit
    in a collective long enough to time out; and a failed step is not
    swallowed, as it is meshless: the runner records it in ``error`` and
    sends this process SIGTERM, which ends the server (and ``main`` then
    exits non-zero), so the other ranks' collectives fail too instead of
    waiting for a step that will not come."""

    def __init__(self, engine: ServeEngine, idle_wait: float = 0.05,
                 sync: Optional[StepSync] = None) -> None:
        super().__init__(name="serve-engine", daemon=True)
        self.engine = engine
        self.idle_wait = idle_wait
        self.sync = sync
        self.error: Optional[BaseException] = None
        self._inbox: List[GenRequest] = []
        self._wake = threading.Event()
        # Not `_stop`: threading.Thread.join calls a method of that name.
        self._stopping = threading.Event()
        self._subs: Dict[str, Callable[[TokenEvent], None]] = {}
        self._subs_lock = threading.Lock()
        self._sub_counter = 0
        # Workload telemetry (a no-op unless the runner agent exported
        # DSTACK_TPU_TELEMETRY_PATH): one `engine` point a second while
        # stepping, so queue depth, hit rates and TTFT/ITL reach the control
        # plane even when no request reads the proxy headers.
        self._telemetry = telemetry_lib.get_emitter()
        self._telemetry_interval = 1.0
        self._last_telemetry = 0.0
        if self._telemetry.enabled:
            self._telemetry.mark(
                "run_start", workload="serve",
                max_batch=engine.ecfg.max_batch, policy=engine.ecfg.policy,
            )
        # contextvars don't cross thread boundaries: capture the constructing
        # context (trace id included) for the step loop.
        self._step_loop_in_ctx = tracing.wrap_with_context(self._step_loop)

    def submit(
        self,
        prompt_tokens: List[int],
        max_new_tokens: Optional[int],
        on_event: Callable[[TokenEvent], None],
        trace_id: Optional[str] = None,
    ) -> GenRequest:
        """Register a per-token callback (invoked on the ENGINE thread) and
        enqueue. The callback is registered BEFORE the engine sees the
        request, or the step loop could emit the first token into the void."""
        with self._subs_lock:
            self._sub_counter += 1
            req_id = f"http-{self._sub_counter}"
            self._subs[req_id] = on_event
        try:
            if self.sync is None:
                req = self.engine.submit(
                    prompt_tokens, max_new_tokens, req_id=req_id, trace_id=trace_id
                )
            else:
                req = self.engine.make_request(
                    prompt_tokens, max_new_tokens, req_id=req_id, trace_id=trace_id
                )
                with self._subs_lock:
                    self._inbox.append(req)
        except Exception:
            with self._subs_lock:
                self._subs.pop(req_id, None)
            raise
        self._wake.set()
        return req

    def step_once(self) -> None:
        """One engine step + event dispatch (run()'s body). Meshless, a
        failed step is logged and dropped; on a mesh it raises."""
        if self.sync is not None:
            events = self.engine.step()
            self.sync.check(events)
        else:
            try:
                events = self.engine.step()
            except Exception:
                logger.exception("engine step failed")
                return
        if self._telemetry.enabled:
            now = time.monotonic()
            if now - self._last_telemetry >= self._telemetry_interval:
                self._last_telemetry = now
                s = self.engine.stats()
                self._telemetry.emit(
                    "engine",
                    queue_depth=s["queue_depth"],
                    active=s["active"],
                    free_pages=s["free_pages"],
                    generated_tokens=s["generated_tokens"],
                    finished_requests=s["finished_requests"],
                    preemptions=s["preemptions"],
                    prefix_hit_rate=s["prefix_hit_rate"],
                    spec_accept_rate=s["spec_accept_rate"],
                    # TTFT/ITL quantiles over the flight-recorder window:
                    # `dstack-tpu top`'s latency columns.
                    **self.engine.flight.latency_summary(),
                )
        for ev in events:
            with self._subs_lock:
                callback = self._subs.get(ev.req_id)
                if ev.done and callback is not None:
                    del self._subs[ev.req_id]
            if callback is not None:
                try:
                    callback(ev)
                except Exception:
                    logger.exception("token subscriber failed")

    def run(self) -> None:
        if self.sync is None:
            self._step_loop_in_ctx()
            return
        try:
            self._step_loop_in_ctx()
        except Exception as e:  # noqa: BLE001 - every rank must go down
            self.error = e
            logger.exception("engine step failed on the serve mesh; stopping this rank")
            os.kill(os.getpid(), signal.SIGTERM)

    def _step_loop(self) -> None:
        while True:
            stopping = self._stopping.is_set()
            if self.sync is not None:
                with self._subs_lock:
                    inbox, self._inbox = self._inbox, []
                self.sync.exchange({"stop": stopping, "requests": [
                    (r.req_id, r.prompt, r.max_new_tokens, r.eos_id) for r in inbox]})
                for req in ([] if stopping else inbox):
                    self.engine.enqueue(req)
            if stopping:
                return
            if not self.engine.has_work():
                self._wake.wait(self.idle_wait)
                self._wake.clear()
                continue
            self.step_once()

    def shutdown(self) -> None:
        self._stopping.set()
        self._wake.set()


def create_serve_app(runner: EngineRunner):
    """aiohttp app: POST /generate (SSE token stream or buffered JSON),
    GET /stats, /health, /debug/traces and /metrics. Every response carries
    X-Dstack-Queue-Depth, and with the prefix cache or speculative decode on
    X-Dstack-Prefix-Hit-Rate / X-Dstack-Spec-Accept-Rate (windowed), so the
    proxy records engine gauges without an extra hop."""
    import asyncio

    from aiohttp import web

    engine = runner.engine

    def qd_headers() -> dict:
        headers = {"X-Dstack-Queue-Depth": str(engine.queue_depth)}
        if engine.ecfg.prefix_cache:
            headers["X-Dstack-Prefix-Hit-Rate"] = f"{engine.prefix_hit_rate:.4f}"
        if engine.ecfg.spec_tokens > 0:
            # Windowed, not lifetime: the proxy gauge is a health signal.
            headers["X-Dstack-Spec-Accept-Rate"] = f"{engine.spec_accept_rate_windowed:.4f}"
        return headers

    async def generate(request: web.Request) -> web.StreamResponse:
        try:
            body = await request.json()
        except ValueError:
            raise web.HTTPBadRequest(text="body must be JSON")
        tokens = body.get("prompt_tokens")
        if tokens is None:
            tokens = encode_text(str(body.get("prompt", "")), engine.cfg.vocab_size)
        if not isinstance(tokens, list) or not all(
            isinstance(t, int) and 0 <= t < engine.cfg.vocab_size for t in tokens
        ):
            raise web.HTTPBadRequest(text="prompt_tokens must be valid token ids")
        max_new = body.get("max_tokens")
        if max_new is not None and (
            not isinstance(max_new, int) or isinstance(max_new, bool) or max_new < 1
        ):
            raise web.HTTPBadRequest(text="max_tokens must be a positive integer")
        stream = bool(body.get("stream", True))

        # Adopt the caller's trace (the proxy stamps X-Dstack-Trace-Id) or
        # mint one, so the flight-recorder entry joins the proxy's record.
        trace_id = request.headers.get(tracing.TRACE_HEADER)
        if trace_id:
            tracing.set_trace_id(trace_id)
        else:
            trace_id = tracing.new_trace()

        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def on_event(ev: TokenEvent) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, ev)

        try:
            req = runner.submit(tokens, max_new, on_event, trace_id=trace_id)
        except ValueError as e:
            raise web.HTTPBadRequest(text=str(e))

        if not stream:
            out: List[int] = []
            while True:
                ev = await queue.get()
                out.append(ev.token)
                if ev.done:
                    break
            return web.json_response(
                {
                    "tokens": out,
                    "text": "".join(decode_token(t) for t in out),
                    "request_id": req.req_id,
                    "trace_id": trace_id,
                },
                headers={**qd_headers(), tracing.TRACE_HEADER: trace_id},
            )

        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-store",
                tracing.TRACE_HEADER: trace_id,
                **qd_headers(),
            }
        )
        await resp.prepare(request)
        # Nothing is written until the first token lands: the first SSE chunk
        # through the proxy IS time-to-first-token.
        while True:
            ev = await queue.get()
            payload = {"token": ev.token, "index": ev.index, "text": decode_token(ev.token)}
            await resp.write(b"data: " + json.dumps(payload).encode() + b"\n\n")
            if ev.done:
                break
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def stats(request: web.Request) -> web.Response:
        return web.json_response(engine.stats(), headers=qd_headers())

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"}, headers=qd_headers())

    async def debug_traces(request: web.Request) -> web.Response:
        """Flight-recorder readout, filterable by request or trace id."""
        limit_q = request.query.get("limit")
        try:
            limit = int(limit_q) if limit_q else None
        except ValueError:
            raise web.HTTPBadRequest(text="limit must be an integer")
        traces = engine.flight.snapshot(
            request_id=request.query.get("request") or None,
            trace_id=request.query.get("trace") or None,
            limit=limit,
        )
        return web.json_response(
            {
                "replica": engine.replica,
                "capacity": engine.flight.capacity,
                "slow_threshold_s": engine.flight.slow_threshold,
                "traces": traces,
            },
            headers=qd_headers(),
        )

    async def metrics(request: web.Request) -> web.Response:
        return web.Response(
            text=tracing.render_exposition(SERVE_HISTOGRAM_HELP),
            content_type="text/plain",
            headers=qd_headers(),
        )

    app = web.Application()
    app.router.add_post("/generate", generate)
    app.router.add_get("/stats", stats)
    app.router.add_get("/health", health)
    app.router.add_get("/debug/traces", debug_traces)
    app.router.add_get("/metrics", metrics)
    return app


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m dstack_tpu_torch.workloads.serve``: the runnable serving
    entrypoint, with the JAX CLI's flags. Binds DSTACK_SERVICE_PORT (the
    control plane's contract) unless --port says otherwise. Serves synthetic
    weights from a seed, or --checkpoint-dir's; --spec-model loads a draft
    head. With --mesh every rank of torchrun's world (NCCL on a card, gloo
    with --device cpu; a process group the caller has initialized is used
    as it is) runs this entry point: each restores or draws its pieces and
    builds its engine, rank 0 binds --port and runs the ``EngineRunner``,
    the others ``follow`` it, and all return when rank 0 stops."""
    import argparse

    from aiohttp import web

    from dstack_tpu_torch.workloads.config import PRESETS

    parser = argparse.ArgumentParser(prog="dstack_tpu_torch.workloads.serve")
    parser.add_argument("--config", default="test", choices=sorted(PRESETS))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("DSTACK_SERVICE_PORT", "8000")))
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--pages", type=int, default=512,
                        help="KV page pool size (per layer)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="decode slots (max in-flight sequences)")
    parser.add_argument("--max-new", type=int, default=64,
                        help="default max_tokens when a request names none")
    parser.add_argument("--policy", default="continuous", choices=["continuous", "static"])
    parser.add_argument("--decode-impl", default="auto", dest="decode_impl",
                        choices=list(DECODE_IMPLS),
                        help="paged attention: auto = CUDA kernels on a CUDA"
                             " device, gather references on the CPU")
    parser.add_argument("--quant", default="none", choices=list(quant_lib.QUANT_MODES),
                        help="int8/fp8 = weight-only quantization (projection"
                             " weights stored int8 or fp8-e4m3 + per-channel"
                             " scales, dequantized on use)")
    parser.add_argument("--prefill-chunk", type=int, default=0, dest="prefill_chunk",
                        help="max prompt tokens prefilled per engine step"
                             " (0 = whole prompt at once)")
    parser.add_argument("--prefix-cache", action="store_true", dest="prefix_cache",
                        help="reuse KV pages across requests sharing a prompt"
                             " prefix (refcounted, LRU-evicted full blocks)")
    parser.add_argument("--spec-tokens", type=int, default=0, dest="spec_tokens",
                        help="speculative decode: n-gram draft tokens verified"
                             " per step (0 = off); output stays token-identical"
                             " to greedy")
    parser.add_argument("--spec-model", default="", dest="spec_model",
                        help="checkpoint dir holding a distilled draft head (train"
                             " --draft-head, .draft subtree); replaces the n-gram"
                             " proposer for --spec-tokens, output stays"
                             " token-identical to greedy")
    parser.add_argument("--spec-model-step", type=int, default=None, dest="spec_model_step",
                        help="draft-head checkpoint step (default: latest complete)")
    parser.add_argument("--spec-fallback-window", type=int, default=16,
                        dest="spec_fallback_window",
                        help="spec steps per request the accept-rate fallback judges"
                             " over (the window must fill first)")
    parser.add_argument("--spec-fallback-threshold", type=float, default=0.1,
                        dest="spec_fallback_threshold",
                        help="windowed accept rate below which a request falls back"
                             " from the draft head to the n-gram proposer (<= 0"
                             " disables the fallback)")
    parser.add_argument("--checkpoint-dir", default="", dest="checkpoint_dir",
                        help="restore real weights from a train checkpoint (the"
                             " .params subtree of a TrainState, in the JAX package's"
                             " format) instead of serving synthetic ones")
    parser.add_argument("--checkpoint-step", type=int, default=None, dest="checkpoint_step",
                        help="checkpoint step to restore (default: latest complete)")
    parser.add_argument("--mesh", default="",
                        help="serve mesh spec: tpN shards projections/heads"
                             " over N ranks (ddMxtpN adds an explicit replica"
                             " axis; default meshless - one card per replica);"
                             " run one process a rank under torchrun")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without one) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        set_reference_matmul_precision()
    cfg = get_config(args.config)
    mesh = None
    if args.mesh and args.mesh != "none":
        device = sharding.init_distributed(device) or device
        mesh = parse_mesh_arg(args.mesh).connect(device)
    lead = mesh is None or mesh.rank == 0
    params = None
    if args.checkpoint_dir:
        params, restored = load_serve_params(
            args.checkpoint_dir, cfg, mesh=mesh, quant=args.quant, step=args.checkpoint_step,
            device=device,
        )
        if lead:
            print(f"restored checkpoint step {restored['step']} from {args.checkpoint_dir}"
                  + (f" (saved on mesh {restored['mesh']})" if restored.get("mesh") else ""),
                  flush=True)
    draft_params = None
    if args.spec_model:
        if args.spec_tokens <= 0:
            raise SystemExit("--spec-model needs --spec-tokens > 0")
        draft_params, draft_manifest = load_draft_params(
            args.spec_model, cfg, mesh=mesh, step=args.spec_model_step, device=device,
        )
        if lead:
            print(f"draft head restored from {args.spec_model} step {draft_manifest['step']}"
                  f" (.draft subtree)", flush=True)
    engine = ServeEngine(
        cfg,
        EngineConfig(
            page_size=args.page_size,
            num_pages=args.pages,
            max_batch=args.max_batch,
            max_new_default=args.max_new,
            policy=args.policy,
            decode_impl=args.decode_impl,
            quant=args.quant,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache,
            spec_tokens=args.spec_tokens,
            spec_fallback_window=args.spec_fallback_window,
            spec_fallback_threshold=args.spec_fallback_threshold,
        ),
        params=params,
        device=device,
        mesh=mesh,
        draft_params=draft_params,
    )
    del params, draft_params
    sync = StepSync(mesh) if mesh is not None else None
    if not lead:
        follow(engine, sync)
        return
    runner = EngineRunner(engine, sync=sync)
    runner.start()
    print(
        f"serving config={args.config} on :{args.port} "
        f"(pages={args.pages}x{args.page_size}, slots={args.max_batch}, "
        f"policy={args.policy}, decode={engine.decode_impl}, "
        f"quant={args.quant}, prefill_chunk={args.prefill_chunk}, "
        f"prefix_cache={args.prefix_cache}, spec_tokens={args.spec_tokens}, "
        f"spec_proposer={'draft' if engine._use_draft else 'ngram'}, "
        f"mesh={engine.mesh_desc or 'none'}, "
        f"device={device}, weights={'checkpoint' if args.checkpoint_dir else 'synthetic'})",
        flush=True,
    )
    try:
        web.run_app(create_serve_app(runner), host="0.0.0.0", port=args.port, print=None)
    finally:
        runner.shutdown()
        if sync is not None:
            # The runner's last message stops the other ranks.
            runner.join(timeout=sharding.COLLECTIVE_TIMEOUT.total_seconds())
    if runner.error is not None:
        raise RuntimeError("the engine failed on the serve mesh") from runner.error


if __name__ == "__main__":
    main()
