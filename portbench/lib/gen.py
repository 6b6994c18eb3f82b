"""The general traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and draws the inputs from ``--seed``.

A mix that this generator cannot draw names a generator of its own,
``"generator": "<name>"``, and the harness loads ``traffic/<name>.py`` in
its place (``generator()``): a module with ``train_batches`` and/or
``serve_requests`` of the signatures below.

Every seed gets the same set of sizes and gaps, in an order of its own:
sizes are the quantiles of the mix's distribution at evenly spaced points,
shuffled by the seed, so two seeds do the same work and differ in its order
and in the token ids. Kinds drawn here:

- ``train``: batches [batch, seq] of token ids with the next-token targets,
  ``tokens: "uniform"`` over the vocabulary; every row differs.
- ``serve``: requests with a prompt, a number of tokens to generate, and
  when each is sent. ``loop: "open"``: arrivals at ``rate_per_s``;
  ``arrivals: "even"`` spaces them 1/rate apart, ``"poisson"`` takes the
  gaps from the quantiles of an exponential. ``loop: "closed"``:
  ``clients`` clients, each sending its next request after its last answer
  and a pause drawn from the quantiles of an exponential of mean
  ``think_s`` (0 for none); the list holds ``cap_per_s`` x the window's
  seconds requests beyond one a client, dealt round-robin, and a window that
  completes more runs out. ``order: "stratified"`` deals the sizes out so
  that every run of ``strata`` consecutive requests holds one size from
  each of ``strata`` equal bands of the sorted sizes (which one, and in
  which place, drawn from the seed): the load stays level, and a tail does
  not hang on where the seed put the longest prompts.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
from types import ModuleType
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from portbench.lib import files


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (seeds up to 2**64)."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def generator(mix: dict, extra: Sequence = ()) -> ModuleType:
    """The module that draws ``mix``: ``traffic/<generator>.py`` where the
    mix names one, this module otherwise."""
    name = mix.get("generator")
    if name is None:
        return sys.modules[__name__]
    return files.load_module("traffic", name, extra)


def _grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n evenly spaced quantiles of ``dist`` (whole numbers for lengths)."""
    u = _grid(n)
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(p) for p in u])
        x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
        return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)
    if kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    raise ValueError(f"unknown distribution {kind!r}")


def train_batches(mix: dict, seed: int, vocab: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(tokens [B, T], targets [B, T]) int64, each batch new rows."""
    if mix.get("tokens", "uniform") != "uniform":
        raise ValueError(f"unknown token draw {mix['tokens']!r}; name a generator")
    r = rng(seed, 1)
    b, t = mix["batch"], mix["seq"]
    while True:
        rows = r.integers(0, vocab, size=(b, t + 1), dtype=np.int64)
        yield rows[:, :-1], rows[:, 1:]


def _deal(sizes: np.ndarray, strata: int, r: np.random.Generator) -> np.ndarray:
    """``sizes`` (sorted) in a seeded order; with ``strata`` > 1, each run of
    ``strata`` places takes one size from each band of the sorted sizes."""
    if strata <= 1:
        return r.permutation(sizes)
    bands = [r.permutation(b) for b in np.array_split(np.sort(sizes), strata)]
    out = []
    for i in range(max(len(b) for b in bands)):
        out.extend(r.permutation([b[i] for b in bands if i < len(b)]))
    return np.array(out, dtype=sizes.dtype)


@dataclasses.dataclass
class Request:
    index: int
    # Open loop: the arrival, seconds after the window opens. Closed loop:
    # for a client's first request the same; for its later ones the pause
    # after the client's previous answer.
    due_s: float
    prompt: List[int]
    max_new: int
    client: Optional[int] = None  # closed loop: the client that sends it, in list order


def serve_requests(mix: dict, seed: int, vocab: int, seconds: float) -> List[Request]:
    """The requests of a window of ``seconds``, in the order they are sent
    (a closed loop's in each client's order)."""
    loop = mix.get("loop")
    if loop == "open":
        rate = float(mix["rate_per_s"])
        n = max(1, int(math.floor(rate * seconds)))
        clients: List[Optional[int]] = [None] * n
    elif loop == "closed":
        n_clients = int(mix["clients"])
        n = n_clients + int(math.ceil(float(mix["cap_per_s"]) * seconds))
        clients = [i % n_clients for i in range(n)]
    else:
        raise ValueError(f"unknown loop {loop!r}; name a generator")
    r = rng(seed, 2)
    strata = int(mix.get("strata", 1)) if mix.get("order") == "stratified" else 1
    prompts = _deal(quantiles(mix["prompt"], n), strata, r)
    outputs = _deal(quantiles(mix["output"], n), strata, r)
    if loop == "closed":
        due = r.permutation(-np.log1p(-_grid(n)) * float(mix.get("think_s", 0.0)))
    elif mix.get("arrivals", "poisson") == "even":
        due = (np.arange(n) + 0.5) / rate
    else:
        gaps = r.permutation(-np.log1p(-_grid(n)) / rate)
        due = np.cumsum(gaps) - gaps[0] * 0.5
    toks = rng(seed, 3)
    return [Request(i, float(due[i]), toks.integers(0, vocab, size=int(prompts[i])).tolist(),
                    int(outputs[i]), clients[i]) for i in range(n)]
