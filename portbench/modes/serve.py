"""Serving cells: the port's ``ServeEngine`` driven in-process by seeded
requests, through its public surface only (``submit``, ``step``,
``has_work``, the requests it returns and the events of each step).

Set-up makes the weights on the card in the served type, builds the
engine (``serve.ServeEngine`` with the cell's ``engine`` knobs), and warms
up every shape the window uses by serving throwaway requests: one chunk
step at each padded row count (1, 2, 4, ... max_batch), each with a decode
step, twice. The window sends each request when it is due (the mix's
generator, ``lib/gen.py`` or the one the mix names: an open loop at a
fixed rate, or a closed loop of clients) and steps the engine whenever it
has work. Requests due in the window and not finished at its close are
driven to the end afterwards, without new arrivals, so that each has its
answer.

- ``ttft_p90_ms``: nearest-rank 90th percentile of the time from each
  request's due time to the return of the ``step()`` that emitted its
  first token, over every request due in the window; one without a first
  token counts as missing (infinite).
- ``serve_tokens_per_s``: prompt tokens prefilled (the growth of each
  request's ``pos``) plus tokens emitted, by the steps that ended inside
  the window, over the window.

The same record of each step (which prompt positions were prefilled, and
the context each decoded token attended) gives the per-layer readers
their shapes. No cell preempts (the page pool holds every slot's longest
sequence), so a request's positions are prefilled once.

``correct``: a sample of the finished requests drawn from the seed, the
longest among them, with at least ``check_tokens`` served tokens; once the
engine is freed, the plain reference runs one forward pass over each
prompt and its served tokens, and ``logit_gap`` is the widest gap by which
a served token's logit lies below the reference's best logit at its
position. Greedy tokens only; every request asks for greedy decoding.
"""

from __future__ import annotations

import collections
import heapq
import time
from typing import Dict, List

import numpy as np

UNITS = {"ttft_p90_ms": "ms", "serve_tokens_per_s": "tokens/s", "setup_s": "s"}
STAGE_HISTOGRAM = "dstack_tpu_serve_step_stage_seconds"


def _stage(name: str):
    """(sum, count) of the engine's step-stage histogram for ``name``."""
    from dstack_tpu_torch.core import tracing

    snap = tracing.histogram_snapshot(STAGE_HISTOGRAM)
    total = count = 0.0
    for labels, _, s, n in (snap[1] if snap else []):
        if labels.get("stage") == name:
            total, count = total + s, count + n
    return total, count


def run(r) -> None:
    import torch
    from torch.profiler import record_function

    from dstack_tpu_torch.workloads import serve as serve_lib
    from portbench.lib import gen, weights
    from portbench.lib.stats import nearest_rank
    from portbench.lib.trace import Tracer
    from portbench.modes.train import port_config
    from portbench.reference import dense
    from portbench.run import forbidden_modules

    if r.fault not in (None, "token"):
        raise ValueError(f"unknown fault {r.fault!r}")
    cfg = port_config(r)
    ref = dense.ref_config(r.config, cfg.n_layers)
    shapes = dense.tree_shapes(ref)
    device = r.device
    r.records.update(ref=ref, device_name=(torch.cuda.get_device_name(device)
                                           if device.type == "cuda" else ""))
    engine_kw = dict(r.cell["engine"])
    if r.control:
        engine_kw["quant"] = r.control
    ecfg = serve_lib.EngineConfig(**engine_kw)
    served_dtype = getattr(torch, cfg.dtype)
    engine = serve_lib.ServeEngine(
        cfg, ecfg, params=weights.draw(shapes, r.seed, ref.d_model, device, served_dtype),
        device=device)
    requests = gen.generator(r.mix, r.extra).serve_requests(r.mix, r.seed, ref.vocab, r.seconds)
    _warm_up(engine, ecfg)

    first: Dict[int, float] = {}
    due_at: Dict[int, float] = {}
    token_times: Dict[int, List[float]] = {}
    live: Dict[str, tuple] = {}
    unfinished: Dict[str, tuple] = {}
    seen_pos: Dict[str, int] = {}
    # (end time, tokens prefilled and emitted, chunk rows [(start, valid)],
    #  decoded tokens' contexts, tokens emitted)
    steps: List[tuple] = []
    ready: List[tuple] = []  # (due time, index) of requests due and not sent
    later: Dict[int, collections.deque] = {}  # closed loop: each client's next requests
    r.tracer = Tracer(r.trace, device)
    r.tracer.warm()
    # The traced slice is the window's last ``trace_seconds``: stopping the
    # profiler processes its events, which takes longer than the slice and
    # must come after the window has closed.
    trace_from = r.seconds - r.cell.get("trace_seconds", r.seconds)
    r.sync()
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prefill_before = _stage("prefill")
    r.setup_done()
    t0 = r.now()
    end = t0 + r.seconds

    def due(req, at: float) -> None:
        due_at[req.index] = at
        heapq.heappush(ready, (at, req.index))

    for req in requests:
        if req.client in later:
            later[req.client].append(req)
        else:  # open loop, or a client's first request: due at its offset
            if req.client is not None:
                later[req.client] = collections.deque()
            due(req, t0 + req.due_s)

    def send() -> None:
        req = requests[heapq.heappop(ready)[1]]
        g = engine.submit(req.prompt, max_new_tokens=req.max_new)
        live[g.req_id] = unfinished[g.req_id] = (req, g)
        seen_pos[g.req_id] = 0

    def step_once() -> None:
        with record_function("portbench.engine_step"):
            events = engine.step()
        t = r.now()
        rows = []
        for rid, (req, g) in unfinished.items():
            if g.pos != seen_pos[rid]:
                rows.append((seen_pos[rid], g.pos - seen_pos[rid]))
                seen_pos[rid] = g.pos
        contexts = []
        for ev in events:
            req, g = live[ev.req_id]
            token_times.setdefault(req.index, []).append(t)
            if ev.index == 0:
                first[req.index] = t
            else:
                contexts.append(len(req.prompt) + ev.index)
            if r.fault == "token":
                g.tokens[ev.index] = (g.tokens[ev.index] + 1) % ref.vocab
            if ev.done:
                del unfinished[ev.req_id]
                if req.client is not None and later[req.client] and t < end:
                    nxt = later[req.client].popleft()
                    due(nxt, t + nxt.due_s)
        steps.append((t, sum(v for _, v in rows) + len(events), rows, contexts, len(events)))

    traced = None
    while True:
        now = r.now()
        if r.trace and traced is None and now - t0 >= trace_from:
            r.tracer.start()
            traced = [len(steps)]
        if now >= end:
            break
        while ready and ready[0][0] <= now:
            send()
        if engine.has_work():
            step_once()
        elif ready:
            time.sleep(max(0.0, min(ready[0][0], end) - r.now()))
        else:
            time.sleep(0.001)  # a closed loop whose clients all think
    r.tracer.stop()
    if traced is not None:
        traced.append(len(steps))
    window_steps = len(steps)
    sent = len(live)
    r.records["waiting_at_close"] = sum(1 for i, at in due_at.items()
                                        if at < end and i not in first)
    prefill_after = _stage("prefill")
    r.records["forbidden"] = forbidden_modules()
    if device.type == "cuda":
        r.records["window_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        r.memory_peak_bytes = max(setup_peak, r.records["window_peak_bytes"])
    # Requests due in the window and not yet sent, then the drain.
    while ready and ready[0][0] < end:
        send()
    ready.clear()
    deadline = r.now() + 60.0
    while engine.has_work() and r.now() < deadline:
        step_once()

    r.log(f"window: {window_steps} steps, {sent} requests sent, "
          f"{r.records['waiting_at_close']} without a first token at the close; drained")
    counted = sorted(i for i, at in due_at.items() if at < end)
    ttft = [(first[i] - due_at[i]) * 1e3 if i in first else float("inf") for i in counted]
    finished = {q.index: g for q, g in live.values() if g.done and len(g.tokens) == q.max_new}
    r.attempted = len(counted)
    r.failed = sum(1 for i in counted if i not in finished)
    r.metrics["ttft_p90_ms"] = nearest_rank(ttft, 90)
    r.metrics["serve_tokens_per_s"] = sum(s[1] for s in steps[:window_steps]
                                          if s[0] <= end) / r.seconds
    gaps = [b - a for times in token_times.values() for a, b in zip(times, times[1:])
            if b <= end]
    pf = (prefill_after[0] - prefill_before[0], prefill_after[1] - prefill_before[1])
    calls = []
    for s in (steps[traced[0]:traced[1]] if traced else []):
        if s[2]:
            calls.append(("chunk", np.array([a for a, _ in s[2]]), np.array([v for _, v in s[2]])))
        if s[3]:
            calls.append(("decode", np.array(s[3])))
    r.records.update(
        itl_p90_ms=nearest_rank(gaps, 90) * 1e3 if gaps else None,
        prefill_ms=pf[0] / pf[1] * 1e3 if pf[1] else None,
        serve_calls=calls, page=ecfg.page_size, layers=cfg.n_layers,
        logits_traced=sum(s[4] for s in steps[traced[0]:traced[1]]) if traced else 0)

    # The reference, once the engine is freed.
    sample = _sample(r, requests, finished)
    seqs = [(requests[i].prompt, list(finished[i].tokens)) for i in sample]
    del engine, live, unfinished, finished
    r.free()
    dense.strict_fp32()
    reference_weights = weights.draw(shapes, r.seed, ref.d_model, device, served_dtype)
    per_seq = dense.served_gaps(reference_weights, seqs, ref, device)
    del reference_weights
    r.free()
    r.log(f"reference done: {len(seqs)} requests")
    r.check("logit_gap", max(max(g) for g in per_seq) if per_seq else float("inf"),
            r.cell["limits"]["logit_gap"])
    r.records["checked_tokens"] = sum(len(s) for _, s in seqs)


def _sample(r, requests, finished) -> List[int]:
    """Finished requests drawn from the seed, the longest first, until
    ``check_tokens`` served tokens are in."""
    from portbench.lib import gen

    if not finished:
        return []
    ids = sorted(finished)
    longest = max(ids, key=lambda i: len(requests[i].prompt) + len(finished[i].tokens))
    order = [longest] + [i for i in gen.rng(r.seed, 4).permutation(ids) if i != longest]
    out, served = [], 0
    for i in order:
        out.append(int(i))
        served += len(finished[i].tokens)
        if served >= r.cell["check_tokens"]:
            break
    return out


def _warm_up(engine, ecfg) -> None:
    """Every shape the window runs, through ``submit`` and ``step``:
    throwaway requests of one chunk each, max_batch of them at most at a
    time, so that one step prefills them at each padded row count (1, 2, 4,
    ... max_batch) and decodes them, twice each."""
    rows = 1
    while True:
        for _ in range(2):
            for _ in range(rows):
                engine.submit([1] * ecfg.prefill_chunk, max_new_tokens=2)
            while engine.has_work():
                engine.step()
        if rows >= ecfg.max_batch:
            break
        rows = min(rows * 2, ecfg.max_batch)
