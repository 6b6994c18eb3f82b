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
- **Kernels**: ``decode_impl="cuda"`` (the default on a CUDA device) runs the
  hand-written paged decode and paged chunk kernels
  (``kernels/paged.py``); ``"plain"`` runs the gather references of
  ``attention.py``, as the JAX engine's ``"xla"`` does.
- **HTTP**: the same aiohttp routes, headers and JSON keys as the JAX engine
  (``create_serve_app``), so the control plane's proxy serves either.

The step functions are plain eager functions; the host-side scheduling is
the JAX engine's, line for line. Decoding is greedy (argmax), and in fp32 the
engine is token-identical to the JAX engine on the same weights. Not yet
ported: serve meshes, weight-only quantization, the prefix cache,
speculative decode, the draft head and checkpoint restore; asking for one
raises.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dstack_tpu_torch.core import tracing
from dstack_tpu_torch.workloads import model as model_lib
from dstack_tpu_torch.workloads.attention import (
    blockwise_attention,
    paged_chunk_attention,
    paged_decode_attention,
)
from dstack_tpu_torch.workloads.config import LlamaConfig, get_config
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to dstack_tpu_torch")


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[..., K] @ w[K, N] in the activation dtype (weights are stored in
    it, so this is the JAX engine's cast-on-use dot with quant "none")."""
    return x @ w


def _logits(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """fp32 logits, as the JAX engine's fp32-accumulating lm_head dot."""
    return x.float() @ lm_head.float()


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
    # Not yet ported; anything but the default raises.
    quant: str = "none"
    # Max prompt tokens prefilled per request per engine step (0 = whole
    # prompt in one batched prefill).
    prefill_chunk: int = 0
    # Not yet ported; anything but the default raises.
    prefix_cache: bool = False
    spec_tokens: int = 0


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
    # Prompt tokens whose KV is in pages for the CURRENT admission;
    # < len(prompt) means the slot is mid-prefill and not yet decoding.
    pos: int = 0
    # Host-side lifecycle stamps (time.monotonic), set once each.
    trace_id: Optional[str] = None
    admitted_t: float = 0.0
    prefill_start_t: float = 0.0
    first_token_t: float = 0.0
    finished_t: float = 0.0
    token_times: List[float] = dataclasses.field(default_factory=list)


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


def _mlp(x: torch.Tensor, params: dict, layer: int, eps: float) -> torch.Tensor:
    h2 = model_lib._rms_norm(x, params["mlp_norm"][layer], eps)
    gate = _proj(h2, params["w_gate"][layer])
    up = _proj(h2, params["w_up"][layer])
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return x + _proj(hidden, params["w_down"][layer])


# The step functions update the KV pools in place (the JAX engine donates
# them to its jitted steps for the same effect) and return the greedy next
# tokens. Host inputs arrive as numpy arrays or CPU tensors.


def make_prefill_fn(cfg: LlamaConfig):
    """(params, tokens, k_pages, v_pages, write_page, write_off, lens) ->
    next_tokens [B]. tokens [B, T] right-padded prompts; write_page/write_off
    [B, T] map each position into the pool (pool-sized page = dropped
    write); lens [B] true prompt lengths. Blockwise causal attention over the
    prompt itself; the greedy token after each prompt's last position."""

    def prefill(params, tokens, k_pages, v_pages, write_page, write_off, lens):
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        b, t = tokens.shape
        hd, h, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][tokens]  # [B,T,D]
        positions = torch.arange(t, device=dev)
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params["wq"][layer]).reshape(b, t, h, hd)
            k = _proj(h_in, params["wk"][layer]).reshape(b, t, kh, hd)
            v = _proj(h_in, params["wv"][layer]).reshape(b, t, kh, hd)
            q = model_lib._rope(q, positions, cfg.rope_theta)
            k = model_lib._rope(k, positions, cfg.rope_theta)
            _scatter_kv(k_pages[layer], index, k)
            _scatter_kv(v_pages[layer], index, v)
            o = blockwise_attention(q, k, v, causal=True)
            x = x + _proj(o.to(x.dtype).reshape(b, t, h * hd), params["wo"][layer])
            x = _mlp(x, params, layer, cfg.norm_eps)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        last_idx = (torch.as_tensor(lens).to(dev).long() - 1).clamp(0, t - 1)
        last = x[torch.arange(b, device=dev), last_idx]  # [B, D]
        return _logits(last, params["lm_head"]).argmax(-1).int()

    return prefill


def make_decode_fn(cfg: LlamaConfig, decode_impl: str = "plain"):
    """(params, last_tokens, positions, k_pages, v_pages, page_tables,
    write_page, write_off) -> next_tokens [S]. One query per slot: the last
    emitted token's K/V is appended at `positions`, then it attends over the
    slot's paged prefix. Inactive slots ride along with dropped writes and
    finite outputs the engine ignores. decode_impl="cuda" runs the paged
    decode kernel, "plain" the gather reference."""
    attend = paged_decode_attention_cuda if decode_impl == "cuda" else paged_decode_attention

    def decode(params, last_tokens, positions, k_pages, v_pages, page_tables,
               write_page, write_off):
        dev = params["embed"].device
        last_tokens = torch.as_tensor(last_tokens).to(dev).long()
        positions = torch.as_tensor(positions).to(dev).int()
        page_tables = torch.as_tensor(page_tables).to(dev).int()
        kv_lens = positions + 1
        s = last_tokens.shape[0]
        hd, h, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][last_tokens]  # [S, D]
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params["wq"][layer]).reshape(s, h, hd)
            k = _proj(h_in, params["wk"][layer]).reshape(s, kh, hd)
            v = _proj(h_in, params["wv"][layer]).reshape(s, kh, hd)
            q = _rope_single(q, positions, cfg.rope_theta)
            k = _rope_single(k, positions, cfg.rope_theta)
            _scatter_kv(k_pages[layer], index, k)
            _scatter_kv(v_pages[layer], index, v)
            o = attend(q, k_pages[layer], v_pages[layer], page_tables, kv_lens)
            x = x + _proj(o.to(x.dtype).reshape(s, h * hd), params["wo"][layer])
            x = _mlp(x, params, layer, cfg.norm_eps)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _logits(x, params["lm_head"]).argmax(-1).int()

    return decode


def make_chunk_fn(cfg: LlamaConfig, decode_impl: str = "plain"):
    """(params, tokens, starts, valid, k_pages, v_pages, page_tables,
    write_page, write_off) -> next_tokens [S]: chunked prefill. tokens
    [S, C], the first at absolute position starts[s]; valid [S] real tokens
    per row. Each token's K/V is scattered into the slot's pages, then the C
    queries attend causally over the paged prefix including the chunk
    (decode is the C == 1 case). Returns the greedy token after each slot's
    last valid position: the JAX engine's emit="last" (its emit="all" serves
    speculative verify, not yet ported)."""
    cuda = decode_impl == "cuda"

    def chunk_step(params, tokens, starts, valid, k_pages, v_pages, page_tables,
                   write_page, write_off):
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        starts = torch.as_tensor(starts).to(dev).int()
        valid = torch.as_tensor(valid).to(dev).int()
        page_tables = torch.as_tensor(page_tables).to(dev).int()
        s, c = tokens.shape
        hd, h, kh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        positions = starts[:, None] + torch.arange(c, device=dev)[None, :]  # [S, C]
        kv_lens = starts + valid
        index = _write_index(write_page, write_off, k_pages.shape[1], dev)
        x = params["embed"][tokens]  # [S, C, D]
        for layer in range(cfg.n_layers):
            h_in = model_lib._rms_norm(x, params["attn_norm"][layer], cfg.norm_eps)
            q = _proj(h_in, params["wq"][layer]).reshape(s, c, h, hd)
            k = _proj(h_in, params["wk"][layer]).reshape(s, c, kh, hd)
            v = _proj(h_in, params["wv"][layer]).reshape(s, c, kh, hd)
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
            x = x + _proj(o.to(x.dtype).reshape(s, c, h * hd), params["wo"][layer])
            x = _mlp(x, params, layer, cfg.norm_eps)
        x = model_lib._rms_norm(x, params["final_norm"], cfg.norm_eps)
        last_idx = (valid.long() - 1).clamp(0, c - 1)
        hidden = x[torch.arange(s, device=dev), last_idx]  # [S, D]
        return _logits(hidden, params["lm_head"]).argmax(-1).int()

    return chunk_step


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
        if mesh is not None:
            raise _not_ported("a serve mesh")
        if draft_params is not None:
            raise _not_ported("the speculative-decode draft head")
        if self.ecfg.quant != "none":
            raise _not_ported(f"quant={self.ecfg.quant!r}")
        if self.ecfg.prefix_cache:
            raise _not_ported("the prefix cache")
        if self.ecfg.spec_tokens:
            raise _not_ported("speculative decode")
        if self.ecfg.policy not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling policy {self.ecfg.policy!r}")
        if self.ecfg.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = whole-prompt prefill), got"
                f" {self.ecfg.prefill_chunk}"
            )
        self.device = resolve_device(device)
        self.decode_impl = resolve_decode_impl(self.ecfg.decode_impl, self.device)
        if self.decode_impl == "cuda":
            require_sm90(self.device)
        adt = model_lib.dtype_of(cfg.dtype)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init_params(cfg, gen, self.device, dtype=adt)
        # Weights live on the device in the activation dtype, cast once here
        # (a no-op for a tree already stored so).
        self.params = {k: v.to(device=self.device, dtype=adt) for k, v in params.items()}

        self._prefill_fn = make_prefill_fn(cfg)
        self._decode_fn = make_decode_fn(cfg, self.decode_impl)
        self._tier2_prefill = self.ecfg.prefill_chunk > 0
        if self._tier2_prefill:
            self._chunk_fn = make_chunk_fn(cfg, self.decode_impl)

        page, pool = self.ecfg.page_size, self.ecfg.num_pages
        max_seq = self.ecfg.max_seq or cfg.max_seq_len
        self.max_seq = max_seq
        self.table_width = -(-max_seq // page)  # pages per sequence, ceil
        shape = (cfg.n_layers, pool, page, cfg.n_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=adt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=adt, device=self.device)

        self._free: List[int] = list(range(pool))
        mb = self.ecfg.max_batch
        self.page_tables = np.zeros((mb, self.table_width), np.int32)
        self.seq_lens = np.zeros(mb, np.int64)       # KV positions stored
        self.last_tokens = np.zeros(mb, np.int32)    # last emitted token
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

    # -- submission (thread-safe) -----------------------------------------

    def submit(
        self,
        prompt_tokens: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        req_id: Optional[str] = None,
        trace_id: Optional[str] = None,
    ) -> GenRequest:
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
            req = GenRequest(
                req_id=req_id,
                prompt=list(prompt_tokens),
                max_new_tokens=max_new,
                eos_id=eos_id if eos_id is not None else self.ecfg.eos_id,
                submitted_t=time.monotonic(),
                trace_id=trace_id or tracing.current_trace_id(),
            )
            self.pending.append(req)
        return req

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

    def stats(self) -> Dict[str, float]:
        # The JAX engine's keys; the unported features report their "off" values.
        return {
            "queue_depth": self.queue_depth,
            "active": self.active_count,
            "free_pages": self.free_pages,
            "available_pages": self.free_pages,
            "total_pages": self.ecfg.num_pages,
            "max_batch": self.ecfg.max_batch,
            "steps": self.total_steps,
            "generated_tokens": self.total_tokens,
            "finished_requests": self.total_finished,
            "preemptions": self.total_preemptions,
            "policy": self.ecfg.policy,
            "decode_impl": self.decode_impl,
            "quant": self.ecfg.quant,
            "mesh": "",
            "prefill_chunk": self.ecfg.prefill_chunk,
            "prefix_cache": 0,
            "spec_tokens": 0,
            "cached_pages": 0,
            "prefix_evictions": 0,
            "prefix_hit_rate": 0.0,
            "spec_accept_rate": 0.0,
            "spec_accept_rate_windowed": 0.0,
            "spec_proposer": "ngram",
            "spec_fallbacks": 0,
        }

    # -- the step loop -----------------------------------------------------

    def step(self) -> List[TokenEvent]:
        """One engine iteration: admit -> prefill (whole-prompt, or one chunk
        per mid-prefill slot) -> one decode step. Returns the tokens emitted
        this step, in emission order."""
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
        """Pop n pages from the free list; None (nothing taken) when the pool
        cannot produce n pages."""
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _admit(self) -> List[Tuple[int, GenRequest]]:
        """Move queued requests into free slots (FIFO, head-of-line blocking
        when pages are short). Static policy: only admit into an EMPTY batch."""
        if self.ecfg.policy == "static" and self.active_count:
            return []
        admitted: List[Tuple[int, GenRequest]] = []
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        while free_slots:
            with self._lock:
                if not self.pending:
                    break
                req = self.pending[0]
                # Reserve the prompt plus one decode page of headroom; growth
                # beyond that allocates on demand (preempting if dry).
                pages = self._try_alloc(self._pages_for(len(req.prompt) + 1))
                if pages is None:
                    break
                self.pending.popleft()
            slot = free_slots.pop(0)
            self.slot_pages[slot] = pages
            row = self.page_tables[slot]
            row[:] = 0
            row[: len(pages)] = pages
            self.seq_lens[slot] = 0
            req.pos = 0
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

        next_tokens = self._prefill_fn(
            self.params, tokens, self.k_pages, self.v_pages, write_page, write_off, lens
        ).cpu().numpy()
        for i, (slot, req) in enumerate(admitted):
            self.seq_lens[slot] = len(req.prompt)
            req.pos = len(req.prompt)
            self._emit(slot, req, int(next_tokens[i]), events)

    def _run_chunk_prefill(self, events: List[TokenEvent]) -> None:
        """Advance every mid-prefill slot by one chunk of at most
        prefill_chunk tokens. The final chunk's last-position argmax is the
        request's first generated token."""
        page = self.ecfg.page_size
        pool = self.ecfg.num_pages
        slots = [s for s in range(self.ecfg.max_batch) if self._prefilling(s)]
        if not slots:
            return
        remaining = {s: len(self.slots[s].prompt) - self.slots[s].pos for s in slots}
        chunk = self.ecfg.prefill_chunk
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

        next_tokens = self._chunk_fn(
            self.params, tokens, starts, valid, self.k_pages, self.v_pages,
            tables, write_page, write_off,
        ).cpu().numpy()
        for i, slot in enumerate(slots):
            req = self.slots[slot]
            req.pos += int(valid[i])
            self.seq_lens[slot] = req.pos
            if req.pos < len(req.prompt):
                continue  # more chunks to go; nothing emitted yet
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

    def _ensure_decode_pages(self, decoding: List[int]) -> None:
        """Every decoding slot about to write position seq_len needs that
        position's page; a dry pool preempts the youngest request (fewest
        generated tokens) back to the queue, so its pages fund the older
        requests and it re-prefills later from prompt + generated."""
        page = self.ecfg.page_size
        for slot in decoding:
            if self.slots[slot] is None:
                continue
            need_idx = int(self.seq_lens[slot]) // page
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
        engine's keys; the prefix cache and speculative decode are not
        ported, so their counts are 0)."""
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
            "cached_tokens": 0,
            "tokens": len(req.tokens),
            "preemptions": req.preemptions,
            "spec_proposed": 0,
            "spec_accepted": 0,
            "itl_ms": [
                round((b - a) * 1000, 3)
                for a, b in zip(req.token_times, req.token_times[1:])
            ],
        }

    def _release_slot(self, slot: int) -> None:
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
# Engine thread + aiohttp app (the runnable service behind the proxy).


class EngineRunner(threading.Thread):
    """Owns the step loop on a background thread; bridges token events into
    per-request callbacks (asyncio consumers wrap them with
    ``loop.call_soon_threadsafe``). Device work blocks, so it must not run on
    the event loop: while the device decodes, the loop streams tokens out."""

    def __init__(self, engine: ServeEngine, idle_wait: float = 0.05) -> None:
        super().__init__(name="serve-engine", daemon=True)
        self.engine = engine
        self.idle_wait = idle_wait
        self._wake = threading.Event()
        # Not `_stop`: threading.Thread.join calls a method of that name.
        self._stopping = threading.Event()
        self._subs: Dict[str, Callable[[TokenEvent], None]] = {}
        self._subs_lock = threading.Lock()
        self._sub_counter = 0
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
            req = self.engine.submit(
                prompt_tokens, max_new_tokens, req_id=req_id, trace_id=trace_id
            )
        except Exception:
            with self._subs_lock:
                self._subs.pop(req_id, None)
            raise
        self._wake.set()
        return req

    def step_once(self) -> None:
        """One engine step + event dispatch (run()'s body)."""
        try:
            events = self.engine.step()
        except Exception:
            logger.exception("engine step failed")
            return
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
        self._step_loop_in_ctx()

    def _step_loop(self) -> None:
        while not self._stopping.is_set():
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
    X-Dstack-Queue-Depth so the proxy records engine backlog without an
    extra hop."""
    import asyncio

    from aiohttp import web

    engine = runner.engine

    def qd_headers() -> dict:
        return {"X-Dstack-Queue-Depth": str(engine.queue_depth)}

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


def main() -> None:
    """``python -m dstack_tpu_torch.workloads.serve``: the runnable serving
    entrypoint. Binds DSTACK_SERVICE_PORT (the control plane's contract)
    unless --port says otherwise. Serves synthetic weights from a seed."""
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
    parser.add_argument("--prefill-chunk", type=int, default=0, dest="prefill_chunk",
                        help="max prompt tokens prefilled per engine step"
                             " (0 = whole prompt at once)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without one) or cpu")
    args = parser.parse_args()

    device = resolve_device(args.device)
    if device.type == "cuda":
        set_reference_matmul_precision()
    cfg = get_config(args.config)
    engine = ServeEngine(
        cfg,
        EngineConfig(
            page_size=args.page_size,
            num_pages=args.pages,
            max_batch=args.max_batch,
            max_new_default=args.max_new,
            policy=args.policy,
            decode_impl=args.decode_impl,
            prefill_chunk=args.prefill_chunk,
        ),
        device=device,
    )
    runner = EngineRunner(engine)
    runner.start()
    print(
        f"serving config={args.config} on :{args.port} "
        f"(pages={args.pages}x{args.page_size}, slots={args.max_batch}, "
        f"policy={args.policy}, decode={engine.decode_impl}, "
        f"prefill_chunk={args.prefill_chunk}, device={device}, weights=synthetic)",
        flush=True,
    )
    try:
        web.run_app(create_serve_app(runner), host="0.0.0.0", port=args.port, print=None)
    finally:
        runner.shutdown()


if __name__ == "__main__":
    main()
