#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device  - the card's name and power limit; build every CUDA kernel from
             the sources in this checkout (one nvcc per source, in parallel);
2. kernels - each paged attention kernel at llama3_8b attention geometry
             against its plain PyTorch version (fp32 outputs; bf16 inputs at
             atol 1e-4 / rtol 1e-3, where only the summation order differs,
             and fp32 inputs at atol 1e-5 / rtol 1e-5), and its time beside
             the plain version's, a library yardstick's and its bound;
3. serve   - the serving engine on llama3_8b (full width and depth, bf16,
             synthetic weights from a seeded torch.Generator) answers 16
             requests through EngineRunner.submit, whole-prompt and with
             prefill_chunk=512; the kernels' launch counts must match the
             decode steps and chunk steps of that run; then torch.profiler
             over a prefill step and five decode steps says where the time
             goes;
4. identity- in fp32 (llama3_8b width, 2 layers) the kernel engine is
             token-identical to the plain engine, whole-prompt and chunked,
             and to the full-forward greedy reference on two prompts;
5. http    - create_serve_app on 127.0.0.1: POST /generate streamed and
             buffered, GET /stats.

The line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}. Exits non-zero
without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import asyncio
import json
import logging
import subprocess
import sys
import threading
import time

import numpy as np

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

KERNEL_SOURCE = "dstack_tpu_torch/workloads/kernels/csrc/paged_attention.cu"
# llama3_8b attention geometry and the serving example's pool.
H, KH, D, PAGE, POOL, SLOTS, TABLE = 32, 8, 128, 16, 4096, 16, 512
CHUNK = 512
KV_LENS = [0, 1, 15, 16, 17, 1000, 4095, 8192, 0, 1, 15, 16, 17, 1003, 4095, 8192]
# Valid chunk tokens per slot; chunk slot s starts at KV_LENS[s] - VALID[s].
VALID = [0, 1, 15, 13, 17, 488, 495, 512, 0, 1, 10, 16, 5, 300, 512, 100]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- phase 2: kernels --------------------------------------------------------


def kernel_inputs(dtype, seed: int = 0):
    """Pages from a shuffled pool (non-contiguous page ids), tables zero past
    each slot's pages, and the chunk geometry's starts."""
    import torch

    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k_pages = torch.randn((POOL, PAGE, KH, D), generator=gen, device="cuda").to(dtype)
    v_pages = torch.randn((POOL, PAGE, KH, D), generator=gen, device="cuda").to(dtype)
    perm = rng.permutation(POOL)
    table = np.zeros((SLOTS, TABLE), np.int32)
    used = 0
    for s, n in enumerate(KV_LENS):
        pages = -(-n // PAGE)
        table[s, :pages] = perm[used:used + pages]
        used += pages
    kv_lens = torch.tensor(KV_LENS, dtype=torch.int32, device="cuda")
    starts = torch.tensor(
        [n - v for n, v in zip(KV_LENS, VALID)], dtype=torch.int32, device="cuda"
    )
    q1 = torch.randn((SLOTS, H, D), generator=gen, device="cuda").to(dtype)
    qc = torch.randn((SLOTS, CHUNK, H, D), generator=gen, device="cuda").to(dtype)
    return dict(
        q1=q1, qc=qc, k_pages=k_pages, v_pages=v_pages,
        table=torch.from_numpy(table).cuda(), kv_lens=kv_lens, starts=starts,
    )


def dense_kv(x):
    """Gathered dense K and V [S, H, T, D] over the longest slot, for the
    library yardstick only."""
    t = max(KV_LENS)
    idx = x["table"][:, : -(-t // PAGE)].long()
    out = []
    for pages in (x["k_pages"], x["v_pages"]):
        dense = pages[idx].reshape(SLOTS, -1, KH, D)[:, :t]
        out.append(dense.repeat_interleave(H // KH, dim=2).transpose(1, 2).contiguous())
    return out


def kernel_bounds(x):
    """(bound_ms, bound_by) of each kernel for these inputs: the K/V
    positions each needs read once, q read once, fp32 out written once; the
    score and PV operations each row needs, at the bf16 tensor-core rate."""
    item = x["k_pages"].element_size()
    kv_token = 2 * KH * D * item
    lens = np.asarray(KV_LENS, np.int64)
    starts = lens - np.asarray(VALID, np.int64)
    rows = np.arange(CHUNK)
    visible = np.clip(np.minimum(lens[:, None], starts[:, None] + rows[None, :] + 1), 0, None)
    out = {}
    for name, q_elems, tokens, attended in (
        ("paged_decode_attention", SLOTS * H * D, lens.sum(), lens.sum()),
        ("paged_chunk_attention", SLOTS * CHUNK * H * D, visible.max(1).sum(), visible.sum()),
    ):
        nbytes = q_elems * item + tokens * kv_token + q_elems * 4 + SLOTS * 4 * 2
        flops = 4.0 * attended * H * D
        peak = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (
            float(max(t_bytes, t_ops) * 1e3), "bytes" if t_bytes >= t_ops else "operations"
        )
    return out


def phase_kernels() -> dict:
    import torch

    from dstack_tpu_torch.workloads.kernels import paged

    report = {}
    for dtype, atol, rtol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 1e-3)):
        x = kernel_inputs(dtype)
        args_d = (x["q1"], x["k_pages"], x["v_pages"], x["table"], x["kv_lens"])
        args_c = (x["qc"], x["k_pages"], x["v_pages"], x["table"], x["starts"], x["kv_lens"])
        pairs = {
            "paged_decode_attention": (
                lambda: paged.paged_decode_attention_cuda(*args_d),
                lambda: paged.paged_decode_attention_plain(*args_d),
            ),
            "paged_chunk_attention": (
                lambda: paged.paged_chunk_attention_cuda(*args_c),
                lambda: paged.paged_chunk_attention_plain(*args_c),
            ),
        }
        for name, (kernel, plain) in pairs.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} ({dtype}): non-finite output")
            err = float((got - ref).abs().max())
            torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
            zero_rows = [s for s, n in enumerate(KV_LENS) if n == 0]
            if bool(got[zero_rows].abs().max() != 0):
                raise AssertionError(f"{name} ({dtype}): kv_len 0 rows are not zero")
            log(f"kernel {name} {str(dtype)[6:]}: max_abs_err {err:.3e}"
                f" (atol {atol:g}, rtol {rtol:g}) ok")
            if dtype == torch.bfloat16:
                report[name] = {"max_abs_err": err, "kernel": kernel, "plain": plain}
        if dtype == torch.bfloat16:
            bounds = kernel_bounds(x)
            k_dense, v_dense = dense_kv(x)
            t = k_dense.shape[2]
            pos = torch.arange(t, device="cuda")
            lens = x["kv_lens"].long()
            mask_d = (pos[None, :] < lens[:, None])[:, None, None, :]
            q_d = x["q1"][:, :, None, :]
            rows = torch.arange(CHUNK, device="cuda")
            limit = torch.minimum(lens[:, None], x["starts"].long()[:, None] + rows[None, :] + 1)
            mask_c = (pos[None, None, :] < limit[:, :, None])[:, None]
            q_c = x["qc"].transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library = {
                "paged_decode_attention": lambda: sdpa(q_d, k_dense, v_dense, attn_mask=mask_d),
                "paged_chunk_attention": lambda: sdpa(q_c, k_dense, v_dense, attn_mask=mask_c),
            }
            for name, entry in report.items():
                entry["ms"] = time_ms(entry.pop("kernel"))
                entry["plain_ms"] = time_ms(entry.pop("plain"))
                entry["library_ms"] = time_ms(library[name])
                entry["bound_ms"], entry["bound_by"] = bounds[name]
                log(f"kernel {name} bf16 timing: {entry['ms']:.4f} ms, plain"
                    f" {entry['plain_ms']:.4f} ms, sdpa {entry['library_ms']:.4f} ms,"
                    f" bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
            del k_dense, v_dense
        del x
        torch.cuda.empty_cache()
    return report


# -- phase 3: the serving path -----------------------------------------------


class _StepErrors(logging.Handler):
    """Collects the engine runner's logged step failures, so a failed step
    fails the drive at once instead of leaving requests unfinished."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(self.format(record))


def count_calls(engine, attr: str) -> list:
    """Wrap engine.<attr> (a step function) to count its calls."""
    calls = [0]
    inner = getattr(engine, attr)

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    setattr(engine, attr, counted)
    return calls


def drive_runner(engine, prompts, max_new: int, timeout: float = 600.0) -> dict:
    """Submit every prompt through EngineRunner.submit and wait for all."""
    from dstack_tpu_torch.workloads import serve

    errors = _StepErrors()
    serve.logger.addHandler(errors)
    runner = serve.EngineRunner(engine)
    tokens = [[] for _ in prompts]
    finished = threading.Semaphore(0)

    def on_event(i):
        def cb(ev):
            tokens[i].append(ev.token)
            if ev.done:
                finished.release()
        return cb

    t0 = time.monotonic()
    runner.start()
    try:
        for i, p in enumerate(prompts):
            runner.submit(p, max_new, on_event(i))
        for _ in prompts:
            while not finished.acquire(timeout=0.5):
                if errors.records:
                    raise RuntimeError("engine step failed:\n" + errors.records[0])
                if time.monotonic() - t0 > timeout:
                    raise TimeoutError("requests did not finish")
        wall = time.monotonic() - t0
    finally:
        runner.shutdown()
        runner.join(timeout=60)
        serve.logger.removeHandler(errors)
    if runner.is_alive():
        raise RuntimeError("engine runner did not stop")
    return {"tokens": tokens, "wall_s": wall}


def phase_serve(card: str) -> dict:
    import torch

    from dstack_tpu_torch.workloads import model, serve
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.kernels import paged

    cfg = get_config("llama3_8b")
    t0 = time.monotonic()
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"),
        dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    log(f"serve: llama3_8b bf16 weights initialised in {time.monotonic() - t0:.1f} s"
        f" ({sum(p.numel() for p in params.values()) / 1e9:.2f} B params)")
    rng = np.random.RandomState(0)
    lengths = np.linspace(16, 1500, 16).astype(int)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lengths]
    max_new = 32
    launches = {}
    for chunk in (0, 512):
        engine = serve.ServeEngine(
            cfg,
            serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16, prefill_chunk=chunk),
            params=params,
        )
        if engine.decode_impl != "cuda":
            raise AssertionError(f"engine decode_impl is {engine.decode_impl}")
        decode_calls = count_calls(engine, "_decode_fn")
        chunk_calls = count_calls(engine, "_chunk_fn") if chunk else [0]
        torch.cuda.synchronize()
        paged.reset_launches()
        out = drive_runner(engine, prompts, max_new)
        got = dict(paged.launches)
        for p, toks in zip(prompts, out["tokens"]):
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"request of {len(p)} tokens returned {toks}")
        if got["paged_decode_attention"] != cfg.n_layers * decode_calls[0]:
            raise AssertionError(
                f"decode kernel launches {got['paged_decode_attention']} !="
                f" {cfg.n_layers} layers x {decode_calls[0]} decode steps"
            )
        if got["paged_chunk_attention"] != cfg.n_layers * chunk_calls[0]:
            raise AssertionError(
                f"chunk kernel launches {got['paged_chunk_attention']} !="
                f" {cfg.n_layers} layers x {chunk_calls[0]} chunk steps"
            )
        if chunk and got["paged_chunk_attention"] == 0:
            raise AssertionError("prefill_chunk=512 never launched the chunk kernel")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        lat = engine.flight.latency_summary()
        n_tok = sum(len(t) for t in out["tokens"])
        log(f"serve prefill_chunk={chunk}: 16 requests x {max_new} tokens in"
            f" {out['wall_s']:.2f} s, {n_tok / out['wall_s']:.1f} tokens/s, TTFT p50"
            f" {lat['ttft_p50_ms']} ms, ITL p50 {lat['itl_p50_ms']} ms;"
            f" decode steps {decode_calls[0]}, chunk steps {chunk_calls[0]},"
            f" launches {got} [{card}]")
        del engine
        torch.cuda.empty_cache()
    profile_steps(cfg, params, prompts, card)
    del params
    torch.cuda.empty_cache()
    return launches


def profile_steps(cfg, params, prompts, card: str, decode_steps: int = 5) -> None:
    """Where a step's time goes: torch.profiler over the first engine step
    (admission, whole-prompt prefill, first decode) and over the decode
    steps after it; device busy share and the top operations by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg, serve.EngineConfig(max_batch=16, num_pages=4096, page_size=16), params=params
    )
    for p in prompts:
        engine.submit(p, max_new_tokens=decode_steps + 2)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, steps in (("prefill step", 1), (f"{decode_steps} decode steps", decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.monotonic()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        # Kernel rows only: an operator's row repeats its kernels' time.
        events = [
            e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
        ]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3 or float("nan")
        top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms"
            f" ({100 * busy_ms / wall_ms:.1f}%) [{card}]")
        for e in top:
            ms = e.self_device_time_total / 1e3
            log(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")
    while engine.has_work():
        engine.step()
    del engine


# -- phase 4: fp32 token identity ----------------------------------------------


def run_engine(engine, prompts, max_new: int):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
        if steps > 10_000:
            raise RuntimeError("engine never drained")
    return [r.tokens for r in reqs]


def phase_identity():
    import torch

    from dstack_tpu_torch.workloads import model, serve
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("llama3_8b", n_layers=2, dtype="float32", param_dtype="float32")
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), torch.device("cuda"),
        dtype=torch.float32,
    )
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in (37, 200, 513, 1000)]
    max_new = 24
    streams = {}
    for impl in ("cuda", "plain"):
        for chunk in (0, 256):
            engine = serve.ServeEngine(
                cfg,
                serve.EngineConfig(max_batch=4, num_pages=512, page_size=16,
                                   max_seq=2048, decode_impl=impl, prefill_chunk=chunk),
                params=params,
            )
            streams[impl, chunk] = run_engine(engine, prompts, max_new)
            del engine
    for chunk in (0, 256):
        if streams["cuda", chunk] != streams["plain", chunk]:
            raise AssertionError(f"prefill_chunk={chunk}: kernel engine != plain engine")
    if streams["cuda", 256] != streams["cuda", 0]:
        raise AssertionError("chunked prefill engine != whole-prompt engine")
    for p, toks in zip(prompts[:2], streams["cuda", 0][:2]):
        ref = serve.greedy_reference_decode(params, cfg, p, max_new)
        if ref != toks:
            raise AssertionError(f"engine {toks} != greedy reference {ref}")
    log("identity: fp32 kernel engine == plain engine (whole-prompt and chunk 256)"
        " == chunked == greedy reference on 2 prompts; 4 prompts x 24 tokens")
    return cfg, params


# -- phase 5: HTTP -------------------------------------------------------------


def phase_http(cfg, params) -> None:
    try:
        import aiohttp
        from aiohttp import web
    except ImportError:
        log("http: skipped (aiohttp absent)")
        return
    from dstack_tpu_torch.workloads import serve

    engine = serve.ServeEngine(
        cfg, serve.EngineConfig(max_batch=4, num_pages=64, page_size=16, max_seq=256),
        params=params,
    )
    runner = serve.EngineRunner(engine)
    prompt = [5, 6, 7, 8, 9, 10]

    async def exercise():
        app_runner = web.AppRunner(serve.create_serve_app(runner))
        await app_runner.setup()
        site = web.TCPSite(app_runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as session:
                body = {"prompt_tokens": prompt, "max_tokens": 8}
                async with session.post(f"{base}/generate", json=body) as resp:
                    resp.raise_for_status()
                    if "X-Dstack-Queue-Depth" not in resp.headers:
                        raise AssertionError("no X-Dstack-Queue-Depth header")
                    text = await resp.text()
                events = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
                if events[-1] != "[DONE]":
                    raise AssertionError(f"stream did not end with [DONE]: {events[-1]}")
                streamed = [json.loads(e)["token"] for e in events[:-1]]
                async with session.post(
                    f"{base}/generate", json={**body, "stream": False}
                ) as resp:
                    resp.raise_for_status()
                    buffered = (await resp.json())["tokens"]
                async with session.get(f"{base}/stats") as resp:
                    resp.raise_for_status()
                    stats = await resp.json()
        finally:
            await app_runner.cleanup()
        return streamed, buffered, stats

    runner.start()
    try:
        streamed, buffered, stats = asyncio.run(exercise())
    finally:
        runner.shutdown()
        runner.join(timeout=60)
    if streamed != buffered or len(streamed) != 8:
        raise AssertionError(f"streamed {streamed} != buffered {buffered}")
    if stats["finished_requests"] != 2 or stats["decode_impl"] != "cuda":
        raise AssertionError(f"unexpected /stats {stats}")
    log(f"http: POST /generate streamed == buffered ({streamed}); /stats ok")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.kernels import build, platform

    t_start = time.monotonic()
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, {torch.cuda.device_count()} visible, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}")
    platform.require_sm90(torch.device("cuda"))
    serve.set_reference_matmul_precision()
    t0 = time.monotonic()
    libs = build.build_all()
    log(f"build: {', '.join(p.name for p in libs)} in {time.monotonic() - t0:.1f} s")

    report = phase_kernels()
    launches = phase_serve(card)
    cfg, params = phase_identity()
    phase_http(cfg, params)

    replaces = {
        "paged_decode_attention": "dstack_tpu/workloads/kernels/paged.py:47",
        "paged_chunk_attention": "dstack_tpu/workloads/kernels/paged.py:157",
    }
    kernels = []
    for name, entry in report.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": entry["library_ms"],
        })
    log(f"total {time.monotonic() - t_start:.1f} s [{card}]")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
