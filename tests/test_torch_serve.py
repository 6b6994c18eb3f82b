"""The PyTorch port's serving engine against the JAX engine, on the CPU.

Both engines serve the same weights (JAX's init, loaded through
``convert.params_from_numpy``) in fp32, where greedy decoding is exact, so
their token streams, preemptions and ``stats()`` must be identical:
continuous batching, preemption under page pressure, chunked prefill, the
prefix cache (two waves, and under preemption), speculative decode (alone
and under preemption), weight-only int8, and the serving example's engine
flags together (fp8, prefix cache, chunked prefill, speculative decode). The
n-gram proposer and a scripted ``PrefixCache`` sequence agree with the JAX
objects. The HTTP apps must answer alike, gauge headers included; a runner
writes the JAX runner's ``engine`` telemetry point; the engine must refuse to
run without a device it was not told about; the checkpoint and draft-head
flags keep their error contracts, and so does a serve mesh (its own tests
are ``test_torch_serve_mesh*.py``); the port must import nothing of JAX or
of the JAX package.
"""

import asyncio
import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import serve as jserve
from dstack_tpu.workloads import telemetry as jtelemetry
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads import telemetry as ttelemetry
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy

TINY_KW = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=251, max_seq_len=128, dtype="float32", param_dtype="float32",
    remat=False,
)
JTINY = jget_config("test", **TINY_KW)
TTINY = tget_config("test", **TINY_KW)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16]]
BASE = dict(page_size=8, num_pages=32, max_batch=4, max_seq=128)
# 7 pages of 4 tokens for 3 requests of 5 + 20 tokens: preemption is certain.
PREEMPT = dict(page_size=4, num_pages=7, max_batch=3, max_seq=96)
PREEMPT_PROMPTS = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in (0, 10, 20)]
# 18 tokens: two full pages of 8 and a tail.
SHARED = [5, 9, 13, 2, 44, 17, 81, 3, 7, 7, 101, 55, 13, 24, 9, 16, 31, 8]
# Wave 1 registers the shared prefix; wave 2 hits it.
TWO_WAVES = [
    [SHARED + [50, 60], SHARED + [51, 61]],
    [SHARED + [52 + i, 62 + i] for i in range(3)],
]
# Repetitive prompts feed the n-gram proposer, so drafts are accepted.
REPEATS = [[3, 17, 9, 3, 17, 9, 3, 17, 40 + i] for i in range(3)]
EXAMPLE_FLAGS = dict(quant="fp8", prefix_cache=True, prefill_chunk=4, spec_tokens=4)

# name -> (engine overrides, waves of prompts, max_new_tokens); a wave is
# submitted once the one before it has drained.
CASES = {
    "continuous": ({}, [PROMPTS], 8),
    "preemption": (PREEMPT, [PREEMPT_PROMPTS], 20),
    "chunked": (dict(prefill_chunk=4), [PROMPTS], 8),
    "prefix-cache-two-waves": (dict(prefix_cache=True), TWO_WAVES, 8),
    "prefix-cache-preemption": (
        dict(PREEMPT, prefix_cache=True),
        [[SHARED[:9]], [SHARED[:8] + [30 + i] for i in range(3)]],
        16,
    ),
    "spec-decode": (dict(spec_tokens=4), [REPEATS], 16),
    "spec-decode-preemption": (dict(PREEMPT, spec_tokens=4), [PREEMPT_PROMPTS], 20),
    "int8": (dict(quant="int8"), [PROMPTS], 8),
    "example-flags": (EXAMPLE_FLAGS, TWO_WAVES, 12),
}


@pytest.fixture(scope="module")
def jax_params():
    return jmodel.init_params(JTINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(
        {k: np.asarray(v) for k, v in jax_params.items()}, torch.device("cpu"), torch.float32
    )


def drain(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(2000):
        if not engine.has_work():
            return reqs
        engine.step()
    raise AssertionError("engine did not drain")


def drain_waves(engine, waves, max_new):
    return [req for wave in waves for req in drain(engine, wave, max_new)]


@pytest.mark.parametrize("case", list(CASES))
def test_token_streams_match_the_jax_engine(case, jax_params, torch_params):
    overrides, waves, max_new = CASES[case]
    ecfg = {**BASE, **overrides}
    ref_engine = jserve.ServeEngine(JTINY, jserve.EngineConfig(**ecfg), params=jax_params)
    ref = drain_waves(ref_engine, waves, max_new)
    engine = tserve.ServeEngine(
        TTINY, tserve.EngineConfig(**ecfg), params=torch_params, device="cpu"
    )
    assert engine.decode_impl == "plain"
    got = drain_waves(engine, waves, max_new)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [r.preemptions for r in got] == [r.preemptions for r in ref]
    assert [r.cached_tokens for r in got] == [r.cached_tokens for r in ref]
    assert [(r.spec_proposed, r.spec_accepted) for r in got] == [
        (r.spec_proposed, r.spec_accepted) for r in ref
    ]
    if "preemption" in case:
        assert max(r.preemptions for r in got) >= 1, "pool was sized to force preemption"
    stats, ref_stats = engine.stats(), ref_engine.stats()
    assert set(stats) == set(ref_stats)
    for key in stats:
        if key != "decode_impl":  # "plain" here, "xla" there: the same path
            assert stats[key] == ref_stats[key], key
    if overrides.get("prefix_cache") and len(waves) > 1:
        assert stats["prefix_hit_rate"] > 0, "wave 2 was built to hit the cache"
    if overrides.get("spec_tokens"):
        assert stats["spec_accept_rate"] > 0, "the prompts were built to accept drafts"


def test_ngram_proposer_matches_the_jax_proposer():
    rng = random.Random(11)
    for _ in range(200):
        ctx = [rng.randrange(1, 5) for _ in range(rng.randint(0, 40))]
        k = rng.randint(0, 5)
        ref = jserve.propose_ngram_drafts(ctx, k)
        index = tserve._ngram_index(ctx)
        assert index == jserve._ngram_index(ctx)
        assert tserve.propose_from_index(ctx, index, k) == ref, (ctx, k)


def test_prefix_cache_matches_the_jax_cache():
    """One scripted sequence of match / register / release / evict on both
    caches: the same returns, blocks, references and evictions."""
    caches = [jserve.PrefixCache(4), tserve.PrefixCache(4)]
    a, b = list(range(1, 14)), list(range(1, 9)) + [50, 51, 52, 53, 54]
    script = [
        ("match", a), ("register", a, [10, 11, 12, 13]), ("match", b),
        ("register", b, [10, 11, 20, 21]), ("release", [10, 11, 12, 13]),
        ("evict", 1), ("match", a), ("release", [10, 11, 20, 21]),
        ("release", [10, 11, 30]), ("evict", 5), ("match", b),
    ]
    for op, *args in script:
        ref, got = (getattr(c, op)(*args) for c in caches)
        assert got == ref, (op, args)
        state = [
            ({k: (v.page, v.refs, v.last_used) for k, v in c.blocks.items()},
             c._children, c.evictions, c.evictable_count(), len(c))
            for c in caches
        ]
        assert state[1] == state[0], (op, args)
    assert caches[1].evictions > 0


def test_engine_matches_the_greedy_reference(torch_params):
    engine = tserve.ServeEngine(
        TTINY, tserve.EngineConfig(**BASE), params=torch_params, device="cpu"
    )
    reqs = drain(engine, PROMPTS, 6)
    for prompt, req in zip(PROMPTS, reqs):
        assert req.tokens == tserve.greedy_reference_decode(torch_params, TTINY, prompt, 6)


GAUGE_HEADERS = ("X-Dstack-Queue-Depth", "X-Dstack-Prefix-Hit-Rate", "X-Dstack-Spec-Accept-Rate")


async def _generate(app, prompt, stream):
    """POST /generate on an app; (tokens, the gauge headers, stats keys,
    whether /metrics has the TTFT family)."""
    async with TestClient(TestServer(app)) as client:
        body = {"prompt_tokens": prompt, "max_tokens": 6, "stream": stream}
        resp = await client.post("/generate", json=body)
        assert resp.status == 200
        depth = {h: resp.headers.get(h) for h in GAUGE_HEADERS}
        if stream:
            lines = (await resp.text()).splitlines()
            data = [ln[6:] for ln in lines if ln.startswith("data: ")]
            assert data[-1] == "[DONE]"
            tokens = [json.loads(d)["token"] for d in data[:-1]]
        else:
            tokens = (await resp.json())["tokens"]
        stats = await (await client.get("/stats")).json()
        metrics = await (await client.get("/metrics")).text()
        return tokens, depth, set(stats), "dstack_tpu_serve_ttft_seconds" in metrics


async def _answer_alike(jax_params, torch_params, overrides, prompts):
    """Both apps on one engine config answer each prompt alike, streamed and
    buffered; returns the port's responses."""
    ecfg = {**BASE, **overrides}
    runners = [
        jserve.EngineRunner(
            jserve.ServeEngine(JTINY, jserve.EngineConfig(**ecfg), params=jax_params)
        ),
        tserve.EngineRunner(
            tserve.ServeEngine(
                TTINY, tserve.EngineConfig(**ecfg), params=torch_params, device="cpu"
            )
        ),
    ]
    for r in runners:
        r.start()
    out = []
    try:
        for prompt in prompts:
            for stream in (True, False):
                ref = await _generate(jserve.create_serve_app(runners[0]), prompt, stream)
                got = await _generate(tserve.create_serve_app(runners[1]), prompt, stream)
                assert got == ref and len(got[0]) == 6 and got[3]
                out.append(got)
    finally:
        runners[0]._stop.set()
        runners[1].shutdown()
        runners[1].join(timeout=10)
    assert not runners[1].is_alive()
    return out


async def test_http_apps_answer_alike(jax_params, torch_params):
    for _, headers, _, _ in await _answer_alike(jax_params, torch_params, {}, [PROMPTS[2]]):
        assert headers["X-Dstack-Prefix-Hit-Rate"] is None
        assert headers["X-Dstack-Spec-Accept-Rate"] is None


async def test_http_gauge_headers_match_the_jax_app(jax_params, torch_params):
    """On the serving example's engine flags both apps send both gauge
    headers, with the same values, and /stats the same live keys."""
    out = await _answer_alike(
        jax_params, torch_params, EXAMPLE_FLAGS, [SHARED + [50], SHARED + [51]]
    )
    hit_rates = [float(h["X-Dstack-Prefix-Hit-Rate"]) for _, h, _, _ in out]
    assert hit_rates[0] == 0.0 and hit_rates[-1] > 0.0
    assert all(h["X-Dstack-Spec-Accept-Rate"] is not None for _, h, _, _ in out)


class _Recorder:
    """A telemetry emitter that keeps what it is given."""

    enabled = True

    def __init__(self):
        self.points = []

    def mark(self, event, **fields):
        self.points.append(("mark", {"event": event, **fields}))

    def emit(self, kind, **fields):
        self.points.append((kind, fields))


def test_runner_emits_the_jax_runners_engine_point(jax_params, torch_params):
    ecfg = dict(BASE, prefix_cache=True, spec_tokens=4)
    points = []
    for telemetry, serve, kwargs in (
        (jtelemetry, jserve, dict(params=jax_params)),
        (ttelemetry, tserve, dict(params=torch_params, device="cpu")),
    ):
        recorder = _Recorder()
        prev = telemetry.configure(recorder)
        try:
            engine = serve.ServeEngine(
                JTINY if serve is jserve else TTINY, serve.EngineConfig(**ecfg), **kwargs
            )
            runner = serve.EngineRunner(engine)
            # Emit only where the test asks, however long a step takes on a
            # loaded host: a point at the first step of each request.
            runner._telemetry_interval = float("inf")
            for prompt in (REPEATS[0], REPEATS[0]):
                runner._last_telemetry = float("-inf")  # the next step emits a point
                runner.submit(prompt, 6, lambda ev: None)
                while engine.has_work():
                    runner.step_once()
        finally:
            telemetry.configure(prev)
        points.append(recorder.points)
    ref, got = points
    assert [kind for kind, _ in got] == [kind for kind, _ in ref]
    assert got[0] == ref[0] == ("mark", {"event": "run_start", "workload": "serve",
                                         "max_batch": 4, "policy": "continuous"})
    engine_points = [(g, r) for (kind, g), (_, r) in zip(got, ref) if kind == "engine"]
    assert engine_points
    for g, r in engine_points:
        assert set(g) == set(r)
        assert {k: v for k, v in g.items() if not k.endswith("_ms")} == {
            k: v for k, v in r.items() if not k.endswith("_ms")
        }


def test_no_device_means_cuda_and_raises_without_it(torch_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ServeEngine(TTINY, tserve.EngineConfig(**BASE), params=torch_params)
    monkeypatch.setattr(sys, "argv", ["serve", "--config", "test"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main()


@pytest.mark.parametrize("what", ["mesh", "main-mesh-tp4"])
def test_unported_features_raise(what, torch_params):
    """A serve mesh, once refused naming ROADMAP item 6, holds the JAX
    package's error contracts: the engine validates its mesh against the
    model first (TINY's 2 KV heads do not split 4 ways), and the CLI's
    ``--mesh tp4`` without a process group of 4 ranks raises rather than
    falling back to meshless."""
    from dstack_tpu_torch.workloads import sharding

    if what == "main-mesh-tp4":
        with pytest.raises(ValueError, match="^1 devices not divisible by tp=4$"):
            tserve.main(["--config", "test", "--device", "cpu", "--mesh", "tp4"])
        return
    with pytest.raises(ValueError, match="serve mesh tp=4 must divide n_kv_heads=2"):
        tserve.ServeEngine(TTINY, tserve.EngineConfig(**BASE, spec_tokens=4),
                           params=torch_params, device="cpu",
                           mesh=sharding.make_serve_mesh(4, world=4))


@pytest.fixture(scope="module")
def test_preset_checkpoints(tmp_path_factory):
    """Checkpoints of the ``test`` preset written by the port's train.main:
    a TrainState (step 1) and a DraftTrainState (step 1)."""
    from dstack_tpu_torch.workloads import train as ttrain

    dirs = {name: tmp_path_factory.mktemp(name) for name in ("train", "draft")}
    common = ["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "1"]
    ttrain.main([*common, "--checkpoint-dir", str(dirs["train"]), "--checkpoint-every", "1"])
    ttrain.main([*common, "--draft-head", "--checkpoint-dir", str(dirs["draft"])])
    return {name: str(d) for name, d in dirs.items()}


def _serve_main(argv, monkeypatch):
    """serve.main on the CPU with web.run_app replaced; returns its engine."""
    from aiohttp import web

    seen = {}
    create = tserve.create_serve_app
    monkeypatch.setattr(tserve, "create_serve_app",
                        lambda runner: seen.setdefault("runner", runner) and create(runner))
    monkeypatch.setattr(web, "run_app", lambda app, **kwargs: None)
    tserve.main(["--config", "test", "--device", "cpu", "--port", "0", "--max-batch", "2",
                 "--pages", "64", *argv])
    seen["runner"].join(timeout=30)
    return seen["runner"].engine


@pytest.mark.parametrize(
    "what",
    ["draft-params", "main-checkpoint-dir", "main-checkpoint-step", "main-spec-model",
     "main-spec-model-step", "main-spec-fallback-window", "main-spec-fallback-threshold"],
)
def test_checkpoint_and_draft_flags_keep_their_contracts(what, torch_params, tmp_path,
                                                         test_preset_checkpoints, monkeypatch):
    """Checkpoint restore and the draft head, once refused naming ROADMAP
    items 4 and 8, hold their own error contracts: a head needs
    speculative decode, an empty directory or a missing step raises, a
    checkpoint without a ``.draft`` subtree is no draft head; the fallback
    knobs reach the engine."""
    from dstack_tpu_torch.workloads import model as tmodel

    ckpt = test_preset_checkpoints
    if what == "draft-params":
        draft = tmodel.init_draft_params(TTINY, torch.Generator().manual_seed(7), "cpu")
        with pytest.raises(ValueError, match="spec_tokens == 0"):
            tserve.ServeEngine(TTINY, tserve.EngineConfig(**BASE), params=torch_params,
                               device="cpu", draft_params=draft)
        return
    argv, error, match = {
        "main-checkpoint-dir": (["--checkpoint-dir", str(tmp_path)], FileNotFoundError,
                                "no complete checkpoint"),
        "main-checkpoint-step": (["--checkpoint-dir", ckpt["train"], "--checkpoint-step", "7"],
                                 FileNotFoundError, "step-00000007 has no readable manifest"),
        "main-spec-model": (["--spec-tokens", "4", "--spec-model", ckpt["train"]], ValueError,
                            "no .draft subtree"),
        "main-spec-model-step": (["--spec-tokens", "4", "--spec-model", ckpt["draft"],
                                  "--spec-model-step", "7"], FileNotFoundError,
                                 "no readable manifest"),
        "main-spec-fallback-window": (["--spec-fallback-window", "16"], None, None),
        "main-spec-fallback-threshold": (["--spec-fallback-threshold", "0.0"], None, None),
    }[what]
    if error is not None:
        with pytest.raises(error, match=match):
            _serve_main(argv, monkeypatch)
        return
    engine = _serve_main(argv, monkeypatch)
    assert engine.ecfg.spec_fallback_window == 16
    assert engine.ecfg.spec_fallback_threshold == (0.0 if "threshold" in what else 0.1)


def test_main_serves_the_example_flags_on_the_cpu(monkeypatch):
    """``main`` with the serving example's engine flags on the CPU starts,
    answers /generate and sends both gauge headers."""
    from aiohttp import web

    seen = {}

    def run_app(app, **kwargs):
        seen["port"] = kwargs.get("port")
        seen["answer"] = asyncio.run(_generate(app, [5, 6, 7, 8, 9] * 4, stream=False))

    monkeypatch.setattr(web, "run_app", run_app)
    tserve.main(["--config", "test", "--device", "cpu", "--port", "0", "--quant", "fp8",
                 "--prefix-cache", "--prefill-chunk", "512", "--spec-tokens", "4",
                 "--max-batch", "2", "--pages", "64"])
    tokens, headers, stats_keys, has_ttft = seen["answer"]
    assert len(tokens) == 6 and has_ttft and "spec_accept_rate_windowed" in stats_keys
    assert headers["X-Dstack-Prefix-Hit-Rate"] == "0.0000"
    assert headers["X-Dstack-Spec-Accept-Rate"] is not None


def test_the_port_imports_nothing_of_jax():
    code = (
        "import sys, chip_smoke, dstack_tpu_torch.workloads.serve\n"
        "import dstack_tpu_torch.workloads.kernels.build, dstack_tpu_torch.workloads.convert\n"
        "import dstack_tpu_torch.workloads.train, dstack_tpu_torch.workloads.kernels.flash\n"
        "import dstack_tpu_torch.workloads.kernels.splash, dstack_tpu_torch.workloads.quantize\n"
        "import dstack_tpu_torch.workloads.checkpoint, dstack_tpu_torch.workloads.model\n"
        "import dstack_tpu_torch.workloads.sharding, dstack_tpu_torch.workloads.kernels.collective\n"
        "import dstack_tpu_torch.workloads.moe, dstack_tpu_torch.workloads.pipeline\n"
        "import dstack_tpu_torch.dryrun, dstack_tpu_torch.workloads.kernels.autotune\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dstack_tpu' or m.startswith('dstack_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        check=True, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.stdout.strip() == "[]", out.stdout
