"""The PyTorch port's serving engine against the JAX engine, on the CPU.

Both engines serve the same weights (JAX's init, loaded through
``convert.params_from_numpy``) in fp32, where greedy decoding is exact, so
their token streams must be identical: continuous batching, preemption under
page pressure, and chunked prefill. The HTTP apps must answer alike, the
engine must refuse to run without a device it was not told about, and the
port must import nothing of JAX or of the JAX package.
"""

import json
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
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import serve as tserve
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

# name -> (engine overrides, prompts, max_new_tokens)
CASES = {
    "continuous": ({}, PROMPTS, 8),
    # 7 pages of 4 tokens for 3 requests of 5 + 20 tokens: preemption is certain.
    "preemption": (
        dict(page_size=4, num_pages=7, max_batch=3, max_seq=96),
        [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in (0, 10, 20)],
        20,
    ),
    "chunked": (dict(prefill_chunk=4), PROMPTS, 8),
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


@pytest.mark.parametrize("case", list(CASES))
def test_token_streams_match_the_jax_engine(case, jax_params, torch_params):
    overrides, prompts, max_new = CASES[case]
    ecfg = {**BASE, **overrides}
    ref_engine = jserve.ServeEngine(JTINY, jserve.EngineConfig(**ecfg), params=jax_params)
    ref = drain(ref_engine, prompts, max_new)
    engine = tserve.ServeEngine(
        TTINY, tserve.EngineConfig(**ecfg), params=torch_params, device="cpu"
    )
    assert engine.decode_impl == "plain"
    got = drain(engine, prompts, max_new)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [r.preemptions for r in got] == [r.preemptions for r in ref]
    if case == "preemption":
        assert max(r.preemptions for r in got) >= 1, "pool was sized to force preemption"
    stats, ref_stats = engine.stats(), ref_engine.stats()
    assert set(stats) == set(ref_stats)
    for key in ("steps", "generated_tokens", "finished_requests", "preemptions", "free_pages"):
        assert stats[key] == ref_stats[key], key


def test_engine_matches_the_greedy_reference(torch_params):
    engine = tserve.ServeEngine(
        TTINY, tserve.EngineConfig(**BASE), params=torch_params, device="cpu"
    )
    reqs = drain(engine, PROMPTS, 6)
    for prompt, req in zip(PROMPTS, reqs):
        assert req.tokens == tserve.greedy_reference_decode(torch_params, TTINY, prompt, 6)


async def _generate(app, prompt, stream):
    """POST /generate on an app; (tokens, queue-depth header, stats keys)."""
    async with TestClient(TestServer(app)) as client:
        body = {"prompt_tokens": prompt, "max_tokens": 6, "stream": stream}
        resp = await client.post("/generate", json=body)
        assert resp.status == 200
        depth = resp.headers["X-Dstack-Queue-Depth"]
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


async def test_http_apps_answer_alike(jax_params, torch_params):
    runners = [
        jserve.EngineRunner(
            jserve.ServeEngine(JTINY, jserve.EngineConfig(**BASE), params=jax_params)
        ),
        tserve.EngineRunner(
            tserve.ServeEngine(
                TTINY, tserve.EngineConfig(**BASE), params=torch_params, device="cpu"
            )
        ),
    ]
    for r in runners:
        r.start()
    try:
        for stream in (True, False):
            ref = await _generate(jserve.create_serve_app(runners[0]), PROMPTS[2], stream)
            got = await _generate(tserve.create_serve_app(runners[1]), PROMPTS[2], stream)
            assert got == ref and len(got[0]) == 6 and got[3]
    finally:
        runners[0]._stop.set()
        runners[1].shutdown()
        runners[1].join(timeout=10)
    assert not runners[1].is_alive()


def test_no_device_means_cuda_and_raises_without_it(torch_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ServeEngine(TTINY, tserve.EngineConfig(**BASE), params=torch_params)
    monkeypatch.setattr(sys, "argv", ["serve", "--config", "test"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main()


@pytest.mark.parametrize(
    "kwargs",
    [dict(quant="int8"), dict(prefix_cache=True), dict(spec_tokens=2)],
    ids=["quant", "prefix-cache", "spec-decode"],
)
def test_unported_features_raise(kwargs, torch_params):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.ServeEngine(
            TTINY, tserve.EngineConfig(**BASE, **kwargs), params=torch_params, device="cpu"
        )


def test_the_port_imports_nothing_of_jax():
    code = (
        "import sys, chip_smoke, dstack_tpu_torch.workloads.serve\n"
        "import dstack_tpu_torch.workloads.kernels.build, dstack_tpu_torch.workloads.convert\n"
        "import dstack_tpu_torch.workloads.train, dstack_tpu_torch.workloads.kernels.flash\n"
        "import dstack_tpu_torch.workloads.kernels.splash\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dstack_tpu' or m.startswith('dstack_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        check=True, cwd=Path(__file__).resolve().parents[1],
    )
    assert out.stdout.strip() == "[]", out.stdout
