"""Autotuned (block_q, block_kv) tiles for the flash and splash kernels.

The port's counterpart of ``dstack_tpu.workloads.kernels.autotune``, with
the same cache: a JSON file of winners keyed ``kernel|generation|head_dim|
seq``, so a file written by either package reads in the other and the
generation keeps their entries apart ("sm90" on an H100, "cpu" on the CPU,
the TPU generations in the JAX package's).

- ``tune()`` times forward plus backward of the real kernels for every pair
  it can run and persists the winner. On CUDA the pairs are
  ``flash.TILE_MENU`` (every one builds and runs, so a failing candidate
  raises); on the CPU they are the blocks that divide the lengths, as in the
  JAX package, and the plain versions compute the same result at each, so a
  CPU sweep checks only the contract;
- ``lookup()`` is read by ``flash_attention`` and ``splash_attention`` when
  the caller pins no blocks: the cache file, then the shipped defaults, else
  None (the caller's default). A corrupt or unwritable cache degrades to
  the defaults: tuning is advisory.

The cache directory defaults to ``~/.cache/dstack-tpu/autotune`` and is
overridable with ``DSTACK_TPU_AUTOTUNE_DIR``. Writes are atomic (tmp +
rename), so concurrent workers at worst lose a race, never corrupt the file.
"""

from __future__ import annotations

import json
import os
import statistics
import time
from typing import Dict, Optional, Tuple

import torch

from dstack_tpu_torch.workloads.kernels import platform

ENV_DIR = "DSTACK_TPU_AUTOTUNE_DIR"
CACHE_FILE = "blocks.json"

# Shipped winners per generation: none. The JAX package ships TPU entries;
# the port's entries come from a local tune() on the card.
SHIPPED_DEFAULTS: Dict[str, Tuple[int, int]] = {}

# Winners this process was handed (a mesh rank that did not tune: rank 0
# tuned, wrote the cache and broadcast its pair); they beat the file.
_session: Dict[str, Tuple[int, int]] = {}

# (path, mtime) -> parsed cache, so lookups on every call cost one stat.
_memo: Optional[Tuple[Tuple[str, float], Dict[str, Tuple[int, int]]]] = None


def cache_dir() -> str:
    return os.environ.get(ENV_DIR) or os.path.expanduser("~/.cache/dstack-tpu/autotune")


def cache_path() -> str:
    return os.path.join(cache_dir(), CACHE_FILE)


def generation_of(device: torch.device) -> str:
    return platform.chip_generation(device)


def _key(kernel: str, gen: str, head_dim: int, seq: int) -> str:
    return f"{kernel}|{gen}|{int(head_dim)}|{int(seq)}"


def _valid_blocks(v) -> Optional[Tuple[int, int]]:
    try:
        bq, bk = int(v[0]), int(v[1])
    except (TypeError, ValueError, IndexError):
        return None
    if bq <= 0 or bk <= 0 or len(v) != 2:
        return None
    return bq, bk


def _load_cache() -> Dict[str, Tuple[int, int]]:
    """The parsed cache file; {} when it is missing or corrupt. Memoised on
    (path, mtime)."""
    global _memo
    path = cache_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    if _memo is not None and _memo[0] == (path, mtime):
        return _memo[1]
    entries: Dict[str, Tuple[int, int]] = {}
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            for k, v in raw.items():
                blocks = _valid_blocks(v)
                if blocks is not None:
                    entries[str(k)] = blocks
    except (OSError, ValueError):
        entries = {}
    _memo = ((path, mtime), entries)
    return entries


def lookup(kernel: str, head_dim: int, seq: int,
           gen: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """Best-known (block_q, block_kv) for this kernel, generation and shape,
    or None. Tuned winners beat shipped defaults."""
    if gen is None:
        gen = platform.chip_generation()
    key = _key(kernel, gen, head_dim, seq)
    cached = _session.get(key) or _load_cache().get(key)
    if cached is not None:
        return cached
    return SHIPPED_DEFAULTS.get(key)


def record(kernel: str, head_dim: int, seq: int, blocks: Tuple[int, int],
           gen: Optional[str] = None) -> bool:
    """Persist a tuned winner (atomic merge-write). Returns False instead of
    raising on filesystem trouble: the cache is advisory."""
    global _memo
    if gen is None:
        gen = platform.chip_generation()
    blocks = _valid_blocks(blocks)
    if blocks is None:
        return False
    try:
        os.makedirs(cache_dir(), exist_ok=True)
        path = cache_path()
        entries = {k: list(v) for k, v in _load_cache().items()}
        entries[_key(kernel, gen, head_dim, seq)] = list(blocks)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(entries, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        _memo = None
        return True
    except OSError:
        return False


def remember(kernel: str, head_dim: int, seq: int, blocks: Tuple[int, int],
             gen: Optional[str] = None) -> None:
    """Use ``blocks`` in this process as if the cache held them, without
    writing the file."""
    if gen is None:
        gen = platform.chip_generation()
    _session[_key(kernel, gen, head_dim, seq)] = tuple(blocks)


def candidate_blocks(seq_len: int, limit: int = 3) -> Tuple[int, ...]:
    """The largest ``limit`` blocks of the JAX kernel's menu that divide
    ``seq_len``: the CPU sweep's space per side."""
    from dstack_tpu_torch.workloads.kernels.flash import _BLOCKS

    divs = tuple(b for b in _BLOCKS if seq_len >= b and seq_len % b == 0)
    return divs[:limit]


def _seconds(fn, repeats: int, cuda: bool) -> float:
    """The median seconds of ``fn`` over ``repeats`` calls after one warm-up
    call; on CUDA by events around each call, synchronised."""
    fn()
    times = []
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def tune(
    kernel: str,  # "flash" | "splash"
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, Kh, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    doc_ids: Optional[torch.Tensor] = None,
    gen: Optional[str] = None,
    include_bwd: bool = True,
    repeats: int = 3,
    persist: bool = True,
) -> Dict:
    """Time forward plus backward (``include_bwd``) of the kernels at every
    candidate pair on the given operands, persist the winner keyed (kernel,
    generation, head_dim, max(T, S)), and return the JAX package's report:
    ``{"kernel", "gen", "head_dim", "seq", "blocks": (bq, bk), "sweep":
    {"bqxbk": seconds}}``. Nothing is caught: on CUDA every menu pair must
    build and run."""
    from dstack_tpu_torch.workloads.kernels import flash as flash_lib
    from dstack_tpu_torch.workloads.kernels import splash as splash_lib

    cuda = q.device.type == "cuda"
    if gen is None:
        gen = generation_of(q.device)
    t, d = q.shape[1], q.shape[3]
    s_len = k.shape[1]
    seq = max(t, s_len)
    if cuda:
        pairs = list(flash_lib.TILE_MENU)
    else:
        pairs = [(bq, bk) for bq in candidate_blocks(t) for bk in candidate_blocks(s_len)]
    leaves = [x.detach().requires_grad_(include_bwd) for x in (q, k, v)]

    def run(bq: int, bk: int) -> None:
        if kernel == "splash":
            out = splash_lib.splash_attention(*leaves, causal=causal, window=window,
                                              doc_ids=doc_ids, block_q=bq, block_k=bk)
        else:
            out = flash_lib.flash_attention(*leaves, causal=causal, block_q=bq, block_k=bk)
        if include_bwd:
            torch.autograd.grad(out.sum(), leaves)

    sweep: Dict[str, float] = {}
    best: Optional[Tuple[int, int]] = None
    best_t = float("inf")
    for bq, bk in pairs:
        dt = _seconds(lambda: run(bq, bk), repeats, cuda)
        sweep[f"{bq}x{bk}"] = dt
        if dt < best_t:
            best_t, best = dt, (bq, bk)
    report = {"kernel": kernel, "gen": gen, "head_dim": d, "seq": seq,
              "blocks": best, "sweep": sweep}
    if best is not None and persist:
        record(kernel, d, seq, best, gen=gen)
    return report
