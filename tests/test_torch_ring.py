"""Sequence parallelism and MoE under tp: the port against the JAX package,
on the CPU.

The port runs in one gloo world of 4 processes, spawned once for the file
(``tests/torch_mesh_worker.py``); JAX runs on the same meshes over 4 of its
8 CPU devices, in fp32, on the same numpy-seeded inputs:

- ``ring_attention`` at sp 2 (x fsdp 2, and in key blocks of 4), sp 4 and
  sp 2 x tp 2 (GQA), causal and not: each rank's output and the gradients
  of its q, k and v against JAX's ``ring_attention`` and
  ``blockwise_attention``, within 1e-5;
- 3 AdamW steps of the dense train step at fsdp 2 x sp 2 and sp 2 x tp 2
  (ring attention, RoPE at the chunk's positions, the loss and the
  gradients summed over sp) against JAX's ``make_train_step`` on the same
  mesh: losses and grad norms within 1e-5, the parameters within
  ``test_torch_train.py``'s allowance;
- 3 MoE steps at ep 2 x tp 2 (the experts' hidden split over tp) against
  JAX's ``make_moe_train_step`` at ``make_moe_mesh(dp=1, ep=2, tp=2)``,
  the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from dstack_tpu.workloads import attention as jattn
from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu.workloads.sharding import PARAM_SPECS as JSPECS
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import train as ttrain
from tests.test_torch_moe import KW as MOE_KW
from tests.torch_mesh_worker import start_world

TOL = 1e-5
STEPS = 3
B, T, H, KH, D = 2, 32, 4, 2, 16
# (mesh axes, causal, key block)
RINGS = {
    "sp2-fsdp2-causal": (dict(dp=1, fsdp=2, tp=1, sp=2), True, 512),
    "sp2-fsdp2-causal-blocks4": (dict(dp=1, fsdp=2, tp=1, sp=2), True, 4),
    "sp4-causal": (dict(dp=1, fsdp=1, tp=1, sp=4), True, 512),
    "sp4-full": (dict(dp=1, fsdp=1, tp=1, sp=4), False, 512),
    "sp2-tp2-gqa-causal": (dict(dp=1, fsdp=1, tp=2, sp=2), True, 512),
    "sp2-tp2-gqa-full": (dict(dp=1, fsdp=1, tp=2, sp=2), False, 512),
}
DENSE = dict(dtype="float32")
# (mesh axes, global batch)
STEP_CASES = {
    "fsdp2-sp2": (dict(dp=1, fsdp=2, tp=1, sp=2), 4),
    "sp2-tp2": (dict(dp=1, fsdp=1, tp=2, sp=2), 2),
}
# tp 2 splits the vocab: test_torch_moe.py's geometry at an even vocab.
MOE = {**MOE_KW, "vocab_size": 256}
MOE_MESH = dict(dp=1, fsdp=1, ep=2, tp=2, sp=1)
MOE_BATCH, MOE_T = 4, 16


def ring_inputs():
    rng = np.random.RandomState(5)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, T, KH, D).astype(np.float32)
    v = rng.randn(B, T, KH, D).astype(np.float32)
    r = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, r


def dense_params(seed=0):
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jget_config("test", **DENSE), k),
                            jax.random.PRNGKey(0))
    return {k: (np.ones(s.shape, np.float32) if k.endswith("norm") else
                (rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32))
            for k, s in shapes.items()}


def moe_params():
    rng = np.random.RandomState(1)
    shapes = jax.eval_shape(lambda k: jmoe.init_moe_params(jmoe.MoeConfig(**MOE), k),
                            jax.random.PRNGKey(0))
    return {k: (np.ones(s.shape, np.float32) if k.endswith("norm") else
                (rng.randn(*s.shape) / np.sqrt(MOE["d_model"] if k == "embed"
                                               else s.shape[-2])).astype(np.float32))
            for k, s in shapes.items()}


def step_batches(b, t, vocab, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        tokens = rng.randint(0, vocab, (b, t)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        targets[:, -2:] = -1
        out.append((tokens, targets))
    return out


def jdevices():
    return jax.devices()[:4]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world of 4, once, over every case; JAX's runs of every
    case, computed while the world runs."""
    q, k, v, r = ring_inputs()
    dense, moe = dense_params(), moe_params()
    jobs = [("ring_attention", dict(shape=axes, q=q, k=k, v=v, r=r, causal=causal,
                                    block_size=block))
            for axes, causal, block in RINGS.values()]
    jobs += [("train_steps", dict(shape=axes, cfg_kw=DENSE, params=dense,
                                  batches=step_batches(b, T, 4096, 7)))
             for axes, b in STEP_CASES.values()]
    jobs.append(("moe_steps", dict(shape=MOE_MESH, cfg_kw=MOE, params=moe,
                                   batches=step_batches(MOE_BATCH, MOE_T, MOE["vocab_size"], 9))))
    port = start_world(jobs, 4, tmp_path_factory.mktemp("ring") / "world")

    out = {"rings": {}, "steps": {}}
    args = tuple(jnp.asarray(a) for a in (q, k, v))

    def value_and_grads(core):
        """(out, dq, dk, dv) of ``core`` and of sum(out * r), jitted."""
        loss = jax.jit(jax.grad(lambda *a: jnp.sum(core(*a) * r), (0, 1, 2)))
        return tuple(np.asarray(a) for a in (jax.jit(core)(*args), *loss(*args)))

    cache = {}
    for name, (axes, causal, _) in RINGS.items():
        mesh = jmake_mesh(**axes, devices=jdevices())
        key = (tuple(axes.values()), causal)
        if key not in cache:
            cache[key] = value_and_grads(
                lambda *a, mesh=mesh, causal=causal: jattn.ring_attention(
                    *a, mesh, causal=causal))
        if causal not in cache:
            cache[causal] = value_and_grads(
                lambda *a, causal=causal: jattn.blockwise_attention(*a, causal=causal))
        out["rings"][name] = {"ring": cache[key], "blockwise": cache[causal]}
    for name, (axes, b) in STEP_CASES.items():
        mesh = jmake_mesh(**axes, devices=jdevices())
        optimizer = jtrain.make_optimizer()
        placed = {k_: jax.device_put(a, NamedSharding(mesh, JSPECS[k_]))
                  for k_, a in dense.items()}
        state = jtrain.TrainState(placed, optimizer.init(placed), jnp.zeros((), jnp.int32))
        step = jtrain.make_train_step(jget_config("test", **DENSE), optimizer, mesh)
        losses, norms = [], []
        for tokens, targets in step_batches(b, T, 4096, 7):
            state, m = step(state, tokens, targets)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["steps"][name] = dict(losses=losses, norms=norms,
                                  params={k_: np.asarray(a) for k_, a in state.params.items()})
    mesh = jmoe.make_moe_mesh(**MOE_MESH, devices=jdevices())
    optimizer = jtrain.make_optimizer()
    with mesh:
        jparams = jmoe.shard_moe_params({k_: jnp.asarray(a) for k_, a in moe.items()}, mesh)
        jopt = optimizer.init(jparams)
        step = jmoe.make_moe_train_step(jmoe.MoeConfig(**MOE), optimizer, mesh)
        losses = []
        for tokens, targets in step_batches(MOE_BATCH, MOE_T, MOE["vocab_size"], 9):
            jparams, jopt, loss = step(jparams, jopt, tokens, targets)
            losses.append(float(loss))
    out["moe"] = dict(losses=losses, params={k_: np.asarray(a) for k_, a in jparams.items()})
    return dict(jax=out, port=port(), dense=dense, moe=moe)


def _assemble(results, key, index_key, shape):
    out = np.zeros(shape, np.float32)
    for got in results:
        out[tuple(got[index_key])] = got[key]
    return out


@pytest.mark.parametrize("ref", ["ring", "blockwise"])
@pytest.mark.parametrize("name", list(RINGS))
def test_ring_attention_and_its_gradients_match_jax(name, ref, runs):
    results = [rank[list(RINGS).index(name)] for rank in runs["port"]]
    want = runs["jax"]["rings"][name][ref]
    q, k, _, _ = ring_inputs()
    got = (_assemble(results, "out", "q_index", q.shape),
           _assemble(results, "dq", "q_index", q.shape),
           _assemble(results, "dk", "k_index", k.shape),
           _assemble(results, "dv", "k_index", k.shape))
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        # The global dk/dv sum the gradients of every rank holding a piece:
        # each (row, position, KV head) piece sits on exactly one rank.
        np.testing.assert_allclose(g, w, atol=TOL, err_msg=f"{name} {what}")


def _global(trees, key, shape, mesh, specs):
    out = np.zeros(shape, np.float32)
    spec = sharding.spec_of_key(key, specs)
    for rank, tree in enumerate(trees):
        out[sharding.local_slices(spec, shape, mesh, rank)] = tree[key]
    return out


def _check_steps(results, ref, params, mesh, specs, prefix, norms=True):
    for rank, got in enumerate(results):
        assert got["losses"] == results[0]["losses"] and got["norms"] == results[0]["norms"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL, err_msg=f"rank {rank}")
        if norms:
            np.testing.assert_allclose(got["norms"], ref["norms"], rtol=TOL,
                                       err_msg=f"rank {rank}")
    trees = [got["tree"] for got in results]
    diffs = np.concatenate([
        np.abs(_global(trees, f"{prefix}[{k!r}]", v.shape, mesh, specs)
               - ref["params"][k]).ravel()
        for k, v in params.items()])
    # test_torch_train.py's allowance: AdamW's sign-like step moves a
    # parameter whose gradient is rounding noise by up to lr a step.
    assert (diffs > TOL).mean() <= 1e-4, (diffs > TOL).sum()
    assert diffs.max() <= STEPS * ttrain.make_optimizer().learning_rate


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dense_steps_on_an_sp_mesh_match_jax(name, runs):
    results = [rank[len(RINGS) + list(STEP_CASES).index(name)] for rank in runs["port"]]
    mesh = sharding.make_mesh(**STEP_CASES[name][0], world=4)
    for rank, got in enumerate(results):
        assert got["coords"] == mesh.coords(rank)
    _check_steps(results, runs["jax"]["steps"][name], runs["dense"], mesh,
                 sharding.PARAM_SPECS, ".params")


def test_moe_steps_under_tp_match_jax(runs):
    results = [rank[len(RINGS) + len(STEP_CASES)] for rank in runs["port"]]
    mesh = sharding.make_moe_mesh(**MOE_MESH, world=4)
    # A rank holds E/ep experts, their hidden split over tp.
    assert results[0]["tree"]["['params']['w_down']"].shape == (
        MOE["n_layers"], MOE["n_experts"] // 2, MOE["d_ff"] // 2, MOE["d_model"])
    _check_steps(results, runs["jax"]["moe"], runs["moe"], mesh, sharding.MOE_PARAM_SPECS,
                 "['params']", norms=False)
