"""Input pipeline: batch sources and async prefetch onto one device.

The port's own copy of ``dstack_tpu/workloads/data.py``'s sources, which are
plain numpy and give identical arrays for the same arguments:

- **Batch sources** yield host-local numpy (tokens, targets) pairs:
  synthetic (seeded per batch index, so seekable) or token-file-backed (a flat
  binary of token ids, the packed-corpus format). A single process is host 0
  of 1 unless told otherwise.
- **The per-rank feed** (``rank_rows``): under a mesh each rank reads the
  rows of its (dp, fsdp) coordinate, on an MoE mesh of its (dp, fsdp, ep)
  one (the reference's ``MOE_BATCH``), microbatch by microbatch, as the
  reference's ``make_global_array`` / ``sharded_batches`` place a global
  batch; ranks that differ only in tp or sp read the same rows, and under
  sp each keeps its chunk of the sequence (``columns``).
- **Prefetcher**: a depth-bounded background thread that pulls batches ahead
  of the consumer. ``device_batches`` stages each batch into pinned host
  memory and copies it to the card with ``non_blocking=True``, so the pull
  only enqueues the transfer; the copy goes on the thread's current stream
  (the default one), ordered before any later use on it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

Batch = Tuple[np.ndarray, np.ndarray]  # (tokens, targets), each [local_B, T]


def host_shard(global_batch: int, process_index: int, process_count: int) -> Tuple[int, int]:
    """(row_offset, rows) of this host's contiguous slice of the global batch."""
    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {process_count} hosts"
        )
    rows = global_batch // process_count
    return process_index * rows, rows


def rank_rows(global_batch: int, grad_accum: int, data_index: int,
              data_shards: int) -> np.ndarray:
    """The global rows a data shard holds, in its local order: for each of
    the ``grad_accum`` microbatches (global rows [i*mb, (i+1)*mb)) its
    ``data_index``-th block of mb/data_shards rows, as the reference lays a
    batch out as [A, B/A, T] with dim 1 split over the data axes. With one
    shard: every row, in order."""
    if global_batch % grad_accum or (global_batch // grad_accum) % data_shards:
        raise ValueError(f"global batch {global_batch} does not split into {grad_accum}"
                         f" microbatches of {data_shards} data shards")
    mb = global_batch // grad_accum
    per = mb // data_shards
    micro = np.arange(grad_accum)[:, None] * mb
    return (micro + data_index * per + np.arange(per)[None, :]).ravel()


def synthetic_batches(
    vocab_size: int,
    global_batch: int,
    seq: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
    start_batch: int = 0,
    rows: Optional[np.ndarray] = None,
) -> Iterator[Batch]:
    """Endless stream of random-token batches; each host draws only its own
    rows. Batch b comes from its own (seed, process_index, b)-seeded
    generator, so ``start_batch`` seeks in O(1). With ``rows`` (global row
    indices) the global batch is the ``process_count`` hosts' draws one
    after another, and the stream yields those rows of it, drawing only the
    hosts' blocks they fall in."""
    _, per_host = host_shard(global_batch, process_index, process_count)
    b = start_batch
    while True:
        if rows is None:
            rng = np.random.default_rng((seed, process_index, b))
            tokens = rng.integers(0, vocab_size, (per_host, seq), dtype=np.int32)
        else:
            tokens = np.empty((len(rows), seq), dtype=np.int32)
            for host in np.unique(rows // per_host):
                rng = np.random.default_rng((seed, int(host), b))
                block = rng.integers(0, vocab_size, (per_host, seq), dtype=np.int32)
                mine = rows // per_host == host
                tokens[mine] = block[rows[mine] % per_host]
        yield tokens, tokens
        b += 1


def token_file_batches(
    path: str,
    global_batch: int,
    seq: int,
    dtype: str = "uint16",
    loop: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    start_batch: int = 0,
    rows: Optional[np.ndarray] = None,
) -> Iterator[Batch]:
    """Batches from a flat binary file of token ids (np.memmap: never loaded
    whole). Windows of seq+1 tokens give (tokens, next-token targets). Batch
    b maps to the windows ((b mod batches_per_pass) * global_batch + this
    host's offset), so ``start_batch`` neither replays nor skips data. With
    ``rows`` (global row indices, for a rank's feed) batch b reads windows
    (b mod batches_per_pass) * global_batch + rows instead."""
    offset, n_rows = host_shard(global_batch, process_index, process_count)
    if rows is None:
        rows = offset + np.arange(n_rows)
    data = np.memmap(path, dtype=np.dtype(dtype), mode="r")
    window = seq + 1
    n_windows = len(data) // window
    if n_windows < global_batch:
        raise ValueError(
            f"{path}: {len(data)} tokens = {n_windows} windows of {window}; "
            f"need at least {global_batch} for one global batch"
        )
    per_pass = n_windows // global_batch
    b = start_batch
    while True:
        if not loop and b >= per_pass:
            return
        idx = ((b % per_pass) * global_batch + rows) * window
        chunk = np.stack([data[i : i + window] for i in idx]).astype(np.int32)
        yield chunk[:, :-1], chunk[:, 1:]
        b += 1


def device_batches(
    source: Iterator[Batch], device: torch.device
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Map a numpy batch stream to tensors on ``device``: pinned host memory
    and non-blocking copies on a CUDA device, the arrays themselves on the
    CPU."""
    for tokens, targets in source:
        pair = (torch.from_numpy(tokens), torch.from_numpy(targets))
        if device.type == "cuda":
            pair = tuple(t.pin_memory().to(device, non_blocking=True) for t in pair)
        yield pair


class Prefetcher:
    """Depth-bounded async prefetch over any iterator.

    A daemon thread pulls items from ``it`` and parks them in a queue of size
    ``depth``; ``__next__`` pops the oldest, so while the consumer runs step N
    the thread has already staged batches N+1..N+depth. depth=0 is a
    synchronous passthrough (no thread). Exceptions in the source re-raise in
    the consumer; ``close()`` (or exhaustion) stops the thread. Order is
    preserved."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.depth = depth
        self._it = it
        self._closed = False
        if depth == 0:
            self._q = None
            self._thread = None
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                if self._closed:
                    return
                self._push(item)
                if self._closed:
                    return
            self._push(self._DONE)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._push(e)

    def _push(self, item) -> None:
        while not self._closed:
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self.depth == 0:
            return next(self._it)
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._DONE:
            self._closed = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._closed = True
            raise item
        return item

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            # Drain so a blocked put() observes _closed and exits.
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5)


def input_pipeline(
    global_batch: int,
    seq: int,
    vocab_size: int,
    data_path: Optional[str] = None,
    prefetch: int = 2,
    start_batch: int = 0,
    device: torch.device = torch.device("cuda"),
    data_index: int = 0,
    data_shards: int = 1,
    grad_accum: int = 1,
    columns: Optional[slice] = None,
) -> Prefetcher:
    """The train entrypoint's one-call feed on one device: the source (token
    file or synthetic), staged onto ``device``, behind the prefetcher.
    ``start_batch`` seeks (one global batch per optimizer step). Under a
    mesh the feed holds this rank's ``rank_rows``, and of each its
    ``columns`` (the rank's chunk of the sequence under sp); the synthetic
    global batch is then ``data_shards`` draws, as the reference's is one
    draw per host, so it depends on the data-shard count."""
    rows = rank_rows(global_batch, grad_accum, data_index, data_shards)
    if data_path:
        source: Iterator[Batch] = token_file_batches(
            data_path, global_batch, seq, start_batch=start_batch, rows=rows
        )
    else:
        source = synthetic_batches(vocab_size, global_batch, seq, start_batch=start_batch,
                                   process_count=data_shards, rows=rows)
    if columns is not None:
        source = ((tokens[:, columns], targets[:, columns]) for tokens, targets in source)
    return Prefetcher(device_batches(source, torch.device(device)), depth=prefetch)
