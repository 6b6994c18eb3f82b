"""The port's draft head against the JAX package's, on the CPU.

The same head (JAX's ``init_draft_params``, carried across with
``convert.params_from_numpy``) and target in fp32: ``draft_apply`` and the
distillation loss and its gradients within 1e-5, the engine's proposer
(``serve.make_draft_fn``) token for token against JAX's ``draft_propose``,
three distillation steps against JAX's ``make_draft_distill_step`` within
1e-5. The draft-head engine is token-identical to JAX's draft-head
engine and to greedy decoding (continuous batching, preemption, chunked
prefill with the prefix cache, int8), with the same speculation counts,
and falls back to the n-gram proposer exactly as JAX's does on a head that
misses. ``load_serve_params`` and ``load_draft_params`` read a
DraftTrainState that JAX wrote, and ``serve.main --checkpoint-dir D
--spec-model D`` serves a checkpoint the port's ``train.main --draft-head``
wrote.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import serve as jserve
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy

TOL = 1e-5
TINY_KW = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=251, max_seq_len=128, dtype="float32", param_dtype="float32",
    remat=False,
)
JTINY = jget_config("test", **TINY_KW)
TTINY = tget_config("test", **TINY_KW)
CPU = torch.device("cpu")
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16]]
BASE = dict(page_size=8, num_pages=32, max_batch=4, max_seq=128, spec_tokens=3,
            spec_fallback_threshold=0.0)
# 7 pages of 4 tokens for 3 requests of 5 + 20 tokens: preemption is certain.
PREEMPT = dict(page_size=4, num_pages=7, max_batch=3, max_seq=96)
PREEMPT_PROMPTS = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in (0, 10, 20)]
SHARED = [5, 9, 13, 2, 44, 17, 81, 3, 7, 7, 101, 55, 13, 24, 9, 16, 31, 8]
# name -> (engine overrides, waves of prompts, max_new_tokens)
CASES = {
    "continuous": ({}, [PROMPTS], 16),
    "preemption": (PREEMPT, [PREEMPT_PROMPTS], 20),
    "chunked-prefix-cache": (dict(prefix_cache=True, prefill_chunk=4),
                             [[SHARED + [50]], [SHARED + [60], SHARED + [61]]], 6),
    "int8": (dict(quant="int8"), [PROMPTS], 6),
}


def as_torch(tree):
    return params_from_numpy({k: np.asarray(v) for k, v in tree.items()}, CPU, torch.float32)


@pytest.fixture(scope="module")
def trees():
    """(JAX target, JAX head, the port's copies) on the tiny fp32 config."""
    params = jax.jit(jmodel.init_params, static_argnums=0)(JTINY, jax.random.PRNGKey(0))
    draft = jax.jit(jmodel.init_draft_params, static_argnums=0)(JTINY, jax.random.PRNGKey(7))
    return params, draft, as_torch(params), as_torch(draft)


def tokens_of(seed, shape):
    return np.random.RandomState(seed).randint(0, TINY_KW["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("fn", ["apply", "propose", "distill-loss"])
def test_draft_functions_match_jax(fn, trees):
    jparams, jdraft, tparams, tdraft = trees
    rng = np.random.RandomState(3)
    if fn == "apply":
        hidden, emb = (rng.randn(3, 5, 64).astype(np.float32) for _ in range(2))
        ref = jmodel.draft_apply(jdraft, jnp.asarray(hidden), jnp.asarray(emb), JTINY)
        got = tmodel.draft_apply(tdraft, torch.from_numpy(hidden), torch.from_numpy(emb), TTINY)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    elif fn == "propose":
        hidden = rng.randn(4, 64).astype(np.float32)
        last = tokens_of(4, (4,))
        ref = jmodel.draft_propose(jparams, jdraft, jnp.asarray(hidden), jnp.asarray(last),
                                   4, JTINY)
        got = tserve.make_draft_fn(TTINY, 4)(tparams, tdraft, torch.from_numpy(hidden),
                                             torch.from_numpy(last))
        assert got.dtype == torch.int32 and got.shape == (4, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        tokens = tokens_of(5, (2, 16))
        ref, ref_grads = jax.jit(jax.value_and_grad(jmodel.draft_distill_loss),
                                 static_argnums=(3, 4))(
            jdraft, jparams, jnp.asarray(tokens), JTINY, 2)
        draft = {k: v.clone().requires_grad_(True) for k, v in tdraft.items()}
        loss, grads = ttrain.value_and_grad(
            lambda d: tmodel.draft_distill_loss(d, tparams, torch.from_numpy(tokens), TTINY,
                                                rollout=2), draft)
        np.testing.assert_allclose(loss.item(), float(ref), rtol=TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]), atol=TOL, err_msg=k)
        assert not any(p.requires_grad for p in tparams.values()), "the target stays frozen"


def test_three_distill_steps_match_jax(trees):
    jparams, jdraft, tparams, tdraft = trees
    joptimizer = jtrain.make_optimizer(learning_rate=1e-3)
    jstate = jtrain.DraftTrainState(jparams, jax.tree.map(jnp.array, jdraft),
                                    joptimizer.init(jdraft), jnp.zeros((), jnp.int32))
    jstep = jtrain.make_draft_distill_step(JTINY, joptimizer, rollout=2)
    optimizer = ttrain.make_optimizer(learning_rate=1e-3)
    draft = {k: v.clone().requires_grad_(True) for k, v in tdraft.items()}
    state = ttrain.DraftTrainState(tparams, draft, optimizer.build(draft))
    step = ttrain.make_draft_distill_step(TTINY, optimizer, rollout=2)
    for i in range(3):
        tokens = tokens_of(20 + i, (2, 16))
        jstate, jloss = jstep(jstate, jnp.asarray(tokens))
        state, loss = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    assert state.step == int(jstate.step) == 3
    assert state.params is tparams, "the frozen target is shared, never copied"
    for k, p in state.draft.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.draft[k]), atol=1e-4,
                                   err_msg=k)


def drain(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(2000):
        if not engine.has_work():
            return reqs
        engine.step()
    raise AssertionError("engine did not drain")


def run_waves(engine, waves, max_new):
    return [req for wave in waves for req in drain(engine, wave, max_new)]


@pytest.mark.parametrize("case", list(CASES))
def test_draft_engine_matches_the_jax_draft_engine_and_greedy(case, trees):
    jparams, jdraft, tparams, tdraft = trees
    overrides, waves, max_new = CASES[case]
    ecfg = {**BASE, **overrides}
    ref_engine = jserve.ServeEngine(JTINY, jserve.EngineConfig(**ecfg), params=jparams,
                                    draft_params=jdraft)
    ref = run_waves(ref_engine, waves, max_new)
    engine = tserve.ServeEngine(TTINY, tserve.EngineConfig(**ecfg), params=tparams,
                                device="cpu", draft_params=tdraft)
    got = run_waves(engine, waves, max_new)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [(r.preemptions, r.spec_proposed, r.spec_accepted) for r in got] == [
        (r.preemptions, r.spec_proposed, r.spec_accepted) for r in ref]
    stats, ref_stats = engine.stats(), ref_engine.stats()
    for key in stats:
        if key != "decode_impl":
            assert stats[key] == ref_stats[key], key
    assert stats["spec_proposer"] == "draft" and engine.total_spec_proposed > 0
    if case == "preemption":
        assert max(r.preemptions for r in got) >= 1
    if case != "int8":  # int8 changes the numbers: no fp greedy reference
        greedy = [tserve.greedy_reference_decode(tparams, TTINY, r.prompt[:len(p)], max_new)
                  for r, p in zip(got, [p for wave in waves for p in wave])]
        assert [r.tokens for r in got] == greedy


def test_fallbacks_match_jax_on_a_head_that_misses(trees):
    jparams, jdraft, tparams, tdraft = trees
    ecfg = {**BASE, "spec_fallback_window": 4, "spec_fallback_threshold": 0.9}
    runs = []
    for lib, params, draft, kw in ((jserve, jparams, jdraft, {}),
                                   (tserve, tparams, tdraft, {"device": "cpu"})):
        cfg = JTINY if lib is jserve else TTINY
        engine = lib.ServeEngine(cfg, lib.EngineConfig(**ecfg), params=params,
                                 draft_params=draft, **kw)
        req = drain(engine, [PROMPTS[0]], 20)[0]
        runs.append((req.tokens, req.draft_ok, engine.total_spec_fallbacks,
                     engine.stats()["spec_fallbacks"]))
    assert runs[1] == runs[0]
    assert runs[1][1:] == (False, 1, 1)


@pytest.fixture(scope="module")
def jax_draft_checkpoint(tmp_path_factory, trees):
    """A DraftTrainState that JAX wrote (the tiny target and head)."""
    jparams, jdraft, _, _ = trees
    optimizer = jtrain.make_optimizer(learning_rate=1e-3)
    state = jtrain.DraftTrainState(jparams, jdraft, optimizer.init(jdraft),
                                   jnp.asarray(9, jnp.int32))
    directory = str(tmp_path_factory.mktemp("jax-draft"))
    JaxManager(directory, process_index=0, process_count=1).save(9, state, block=True)
    return directory


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_loaders_read_a_jax_draft_train_state(quant, jax_draft_checkpoint, trees):
    jparams, jdraft, _, _ = trees
    params, manifest = tserve.load_serve_params(jax_draft_checkpoint, TTINY, quant=quant,
                                                device="cpu")
    assert manifest["step"] == 9
    ref = ({k: np.asarray(v) for k, v in jparams.items()} if quant == "none" else
           {k: np.asarray(v) for k, v in jserve.quantize_serve_params(jparams, mode=quant).items()})
    assert sorted(params) == sorted(ref)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    draft, manifest = tserve.load_draft_params(jax_draft_checkpoint, TTINY, device="cpu")
    assert sorted(draft) == sorted(jdraft) and manifest["step"] == 9
    for k, v in draft.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdraft[k]), err_msg=k)
    with pytest.raises(ValueError, match="trained for d_model 64"):
        tserve.load_draft_params(jax_draft_checkpoint, tget_config("test"), device="cpu")


def test_main_serves_a_checkpoint_and_its_draft_head(tmp_path, monkeypatch, capsys):
    """train.main --draft-head writes a DraftTrainState; serve.main with
    --checkpoint-dir and --spec-model on that directory restores both and
    answers /generate with the head proposing."""
    from aiohttp import web

    ttrain.main(["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "2",
                 "--draft-head", "--checkpoint-dir", str(tmp_path)])
    seen = {}

    async def generate(app):
        async with TestClient(TestServer(app)) as client:
            resp = await client.post("/generate", json={
                "prompt_tokens": [5, 6, 7, 8, 9] * 4, "max_tokens": 6, "stream": False})
            assert resp.status == 200
            return (await resp.json())["tokens"], await (await client.get("/stats")).json()

    monkeypatch.setattr(web, "run_app", lambda app, **kw: seen.update(
        zip(("tokens", "stats"), asyncio.run(generate(app)))))
    tserve.main(["--config", "test", "--device", "cpu", "--port", "0", "--max-batch", "2",
                 "--pages", "64", "--spec-tokens", "4", "--checkpoint-dir", str(tmp_path),
                 "--spec-model", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"restored checkpoint step 2 from {tmp_path}" in out
    assert f"draft head restored from {tmp_path} step 2 (.draft subtree)" in out
    assert "spec_proposer=draft" in out and "weights=checkpoint" in out
    assert len(seen["tokens"]) == 6
    assert seen["stats"]["spec_proposer"] == "draft" and seen["stats"]["spec_fallbacks"] == 0
