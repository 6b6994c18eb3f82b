"""The port's GPipe (``pipeline.py``) against the JAX package, on the CPU.

The port runs in one gloo world of 4 processes, spawned once for the file
(``tests/torch_mesh_worker.py``); JAX runs on 4 of its 8 CPU devices. The
``test`` preset in fp32 (4 layers), parameters from JAX's ``init_params``
carried across as numpy, the same token batches:

- ``pipelined_forward`` at dp 2 x pp 2 (n_micro 2) and at pp 4 (n_micro 3)
  against JAX's meshless ``model.forward`` and JAX's ``pipelined_forward``
  on the same mesh, within 1e-5;
- ``pipelined_loss_fn``'s loss and the gradient of every leaf, with remat
  on, with and without the chunked cross-entropy, at dp 2 x pp 2 and pp 4,
  against JAX's dense ``value_and_grad(loss_fn)``, within 1e-5 of each
  leaf's largest |value| (the layer leaves on each rank are its stage's
  layers; the embed, the final norm and the lm_head come out whole and
  equal on every rank);
- the mesh's and the schedule's ValueErrors in JAX's words.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import pipeline as jpp
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import pipeline as tpp
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.config import get_config as tget_config
from tests.torch_mesh_worker import start_world

TOL = 1e-5
T = 16
BASE = dict(dtype="float32", remat=False)
MESHES = {"dp2-pp2": dict(dp=2, pp=2), "pp4": dict(dp=1, pp=4)}
# (mesh, config overrides, global batch, n_micro)
FORWARDS = {
    "dp2-pp2": ("dp2-pp2", dict(), 4, 2),
    "pp4": ("pp4", dict(), 6, 3),
}
GRADS = {
    "dp2-pp2-remat": ("dp2-pp2", dict(remat=True), 4, 2),
    "dp2-pp2-remat-chunked": ("dp2-pp2", dict(remat=True, loss_chunk=8), 4, 2),
    "pp4-remat-chunked": ("pp4", dict(remat=True, loss_chunk=4), 6, 3),
}


def batch(b, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 4096, (b, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -3:] = -1
    return tokens, targets


def jax_mesh(name):
    return jpp.make_pp_mesh(**MESHES[name], devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world of 4, once, over every case; JAX's forwards and
    dense gradients, computed while the world runs."""
    params = {k: np.asarray(v) for k, v in
              jmodel.init_params(jget_config("test", **BASE), jax.random.PRNGKey(0)).items()}
    cases = [(name, False, case) for name, case in FORWARDS.items()]
    cases += [(name, True, case) for name, case in GRADS.items()]
    jobs = []
    for name, grads, (mesh, kw, b, n_micro) in cases:
        tokens, targets = batch(b, seed=len(jobs))
        jobs.append(("pipeline", dict(shape=MESHES[mesh], cfg_kw={**BASE, **kw}, params=params,
                                      tokens=tokens, targets=targets, n_micro=n_micro,
                                      grads=grads)))
    port = start_world(jobs, 4, tmp_path_factory.mktemp("pipeline") / "world")

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    out = {}
    for i, (name, grads, (mesh_name, kw, b, n_micro)) in enumerate(cases):
        cfg = jget_config("test", **{**BASE, **kw})
        tokens, targets = batch(b, seed=i)
        if grads:
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, tk, tg, cfg=cfg: jmodel.loss_fn(p, tk, tg, cfg)))(
                    jparams, tokens, targets)
            out[name] = dict(loss=float(loss), grads={k: np.asarray(v) for k, v in g.items()})
            continue
        mesh = jax_mesh(mesh_name)
        with mesh:
            piped = jax.jit(lambda p, tk, cfg=cfg, mesh=mesh, n=n_micro: jpp.pipelined_forward(
                p, tk, cfg, mesh, n))(jpp.shard_params_pp(jparams, mesh), tokens)
        out[name] = dict(dense=np.asarray(jmodel.forward(jparams, tokens, cfg)),
                         piped=np.asarray(piped))
    return dict(jax=out, port=port(), cases=cases)


def _results(runs, name):
    index = next(i for i, case in enumerate(runs["cases"]) if case[0] == name)
    return [rank[index] for rank in runs["port"]]


@pytest.mark.parametrize("ref", ["dense", "piped"])
@pytest.mark.parametrize("name", list(FORWARDS))
def test_pipelined_forward_matches_jax(name, ref, runs):
    want = runs["jax"][name][ref]
    for rank, got in enumerate(_results(runs, name)):
        # Every pp rank returns its dp row's logits, rows in rank_rows order.
        np.testing.assert_allclose(got["logits"], want[got["rows"]], atol=TOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", list(GRADS))
def test_pipelined_loss_and_grads_match_jax_dense(name, runs):
    mesh_name = GRADS[name][0]
    mesh = sharding.make_pp_mesh(**MESHES[mesh_name], world=4)
    want = runs["jax"][name]
    specs = tpp.stage_params_spec()
    for rank, got in enumerate(_results(runs, name)):
        assert got["coords"] == mesh.coords(rank)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, err_msg=f"rank {rank}")
        for key, g in got["grads"].items():
            ref = want["grads"][key]
            piece = ref[sharding.local_slices(specs[key], ref.shape, mesh, rank)]
            assert g.shape == piece.shape, key
            np.testing.assert_allclose(g, piece, atol=TOL * np.abs(ref).max(),
                                       err_msg=f"rank {rank} {key}")


def test_the_mesh_errors_are_jaxs():
    for kw in (dict(dp=3), dict(dp=2, pp=3)):
        with pytest.raises(ValueError) as jerr:
            jpp.make_pp_mesh(**kw, devices=jax.devices()[:4])
        with pytest.raises(ValueError) as terr:
            tpp.make_pp_mesh(**kw, world=4)
        assert str(terr.value) == str(jerr.value)
    assert tpp.PP_MESH_AXES == jpp.PP_MESH_AXES and tpp.LAYER_KEYS == jpp.LAYER_KEYS


@pytest.mark.parametrize("case", ["layers", "batch"])
def test_the_schedule_errors_are_jaxs(case):
    """n_layers not divisible by pp, and a batch not divisible by n_micro,
    raise before any hop: an unconnected mesh is enough."""
    layers, b = (3, 4) if case == "layers" else (4, 5)
    tokens = np.zeros((b, T), np.int32)
    jcfg = jget_config("test", **BASE, n_layers=layers)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as jerr:
        jpp.pipelined_forward(jparams, jnp.asarray(tokens), jcfg,
                              jpp.make_pp_mesh(dp=1, pp=2, devices=jax.devices()[:2]), 2)
    tcfg = dataclasses.replace(tget_config("test", **BASE), n_layers=layers)
    with pytest.raises(ValueError) as terr:
        tpp.pipelined_forward({}, tokens, tcfg, tpp.make_pp_mesh(dp=1, pp=2, world=2), 2)
    assert str(terr.value) == str(jerr.value)
