"""The port's sharded train step against the JAX package's, on the CPU.

The port runs in one gloo world of 4 processes, spawned once for the file
(``tests/torch_mesh_worker.py``); JAX runs ``make_train_step`` on the same
meshes over 4 of its 8 CPU devices. The ``test`` preset in fp32, the same
parameters (numpy, seeded) and the same global batches: each rank takes its
rows (``data.rank_rows``) and its pieces of the parameters
(``sharding.shard_params``). Over 2 steps the losses and the grad norms
match JAX's to 1e-5, and the parameters after them do within
``test_torch_train.py``'s allowance for AdamW's sign-like step, at
fsdp2 x tp2 with both rings, at dp2 x fsdp2 with grad_accum 2, with splash
under tp 2 (and the bf16 first moment, and the vocab-parallel cross-entropy
in sequence chunks), with fp8 projections through both
rings (to QUANT_RTOL), and at dp2 x tp2 with both rings in a multislice rank
order (two slices given out of order, so the process groups' rank order is
not the mesh's). Then the checkpoints: the port's fsdp2 x tp2 checkpoint
restores meshless in the port and through JAX's
``CheckpointManager.restore``, and a JAX dp2/fsdp4 checkpoint restores onto
the port's world of 4, all bit for bit; and ``train.main`` with the
training example's mesh flags runs 2 steps on the world of 4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu.workloads.sharding import PARAM_SPECS as JSPECS
from dstack_tpu.workloads.sharding import make_mesh as jmake_mesh
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import get_config as tget_config
from tests.torch_mesh_worker import start_world

TOL = 1e-5
# Under fp8 a value within ~1e-7 of an e4m3 rounding boundary (the two
# sides' fp32 roundings differ that much) lands on the next grid value on
# one side only, 2^-3 of itself away; on this preset the MESHLESS port's fp8
# step agrees with JAX's meshless one only to 1.5e-3 (grad norm, step 2).
# The rings quantize each chunk with its own scales on both sides
# (tests/test_torch_collective.py holds those partials to 1e-5).
QUANT_RTOL = 3e-3
T = 32
STEPS = 2
BASE = dict(dtype="float32")
MESHES = {
    "fsdp2-tp2": dict(dp=1, fsdp=2, tp=2, sp=1),
    "dp2-fsdp2": dict(dp=2, fsdp=2, tp=1, sp=1),
    "dp2-fsdp4": dict(dp=2, fsdp=4, tp=1, sp=1),
    # sharding.make_multislice_mesh(2, [1, 0, 1, 0], tp=2)'s rank order.
    "multislice-dp2-tp2": dict(dp=2, fsdp=1, tp=2, sp=1, ranks=[1, 3, 0, 2]),
}
# (mesh, config overrides, global batch, grad_accum, first-moment dtype)
CASES = {
    "fsdp2-tp2-rings": ("fsdp2-tp2", dict(tp_overlap=True, fsdp_overlap=True), 4, 1, None),
    "dp2-fsdp2-accum2": ("dp2-fsdp2", dict(), 8, 2, None),
    "fsdp2-tp2-splash-chunked-ce": ("fsdp2-tp2", dict(attn_impl="splash", attn_window=16,
                                                      loss_chunk=8), 4, 1, "bfloat16"),
    "fsdp2-tp2-rings-fp8": ("fsdp2-tp2", dict(tp_overlap=True, fsdp_overlap=True, quant="fp8"),
                            4, 1, None),
    "multislice-dp2-tp2-rings": ("multislice-dp2-tp2", dict(tp_overlap=True, fsdp_overlap=True),
                                 4, 1, None),
}
CKPT_CASE = "fsdp2-tp2-rings"
MAIN_ARGV = ["--device", "cpu", "--config", "test", "--seq", str(T), "--steps", "2",
             "--tp", "2", "--tp-overlap", "--fsdp-overlap", "--grad-accum", "2",
             "--mu-dtype", "bfloat16", "--remat-policy", "full", "--prefetch", "2",
             "--attn-impl", "splash", "--attn-window", "16", "--quant", "fp8"]


def np_params():
    """The JAX ``init_params`` layout, drawn with numpy."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(jget_config("test", **BASE), k),
                            jax.random.PRNGKey(0))
    tree = {}
    for k, s in shapes.items():
        if k.endswith("norm"):
            tree[k] = np.ones(s.shape, np.float32)
        else:
            tree[k] = (rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
    return tree


def batches(b, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        tokens = rng.randint(0, 4096, (b, T)).astype(np.int32)
        out.append((tokens, np.roll(tokens, -1, axis=1)))
    return out


def jax_mesh(name):
    axes = dict(MESHES[name])
    order = axes.pop("ranks", None) or range(int(np.prod(list(axes.values()))))
    return jmake_mesh(**axes, devices=[jax.devices()[i] for i in order])


def jax_state(params, mesh, mu_dtype):
    optimizer = jtrain.make_optimizer(mu_dtype=mu_dtype)
    placed = {k: jax.device_put(v, NamedSharding(mesh, JSPECS[k])) for k, v in params.items()}
    return optimizer, jtrain.TrainState(placed, optimizer.init(placed), jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX dp2/fsdp4 checkpoint; the port's world of 4, once, over every
    case, the checkpoints and main; and JAX's runs of every case, computed
    while the world runs."""
    params = np_params()
    # A JAX TrainState with a bf16 first moment after one step on dp2/fsdp4.
    tmp = tmp_path_factory.mktemp("train-mesh")
    mesh = jax_mesh("dp2-fsdp4")
    optimizer, state = jax_state(params, mesh, "bfloat16")
    step = jtrain.make_train_step(jget_config("test", **BASE), optimizer, mesh)
    state, _ = step(state, *batches(8, seed=2)[0])
    JaxManager(str(tmp / "jax-ckpt"), process_index=0, process_count=1).save(
        1, state, data_offset=1, mesh_shape=dict(mesh.shape), block=True)
    jax_tree = {k: np.asarray(v) for k, v in _jax_entries(state)}

    jobs = [("train_steps", dict(shape=MESHES[m], cfg_kw={**BASE, **kw}, params=params,
                                 batches=batches(b, seed=1), grad_accum=accum, mu_dtype=mu,
                                 ckpt_dir=str(tmp / "port-ckpt") if name == CKPT_CASE else None))
            for name, (m, kw, b, accum, mu) in CASES.items()]
    jobs.append(("restore", dict(shape=MESHES["fsdp2-tp2"], cfg_kw=BASE, params=params,
                                 ckpt_dir=str(tmp / "jax-ckpt"), mu_dtype="bfloat16")))
    jobs.append(("main", dict(argv=MAIN_ARGV + ["--checkpoint-dir", str(tmp / "main-ckpt"),
                                                "--checkpoint-every", "1"])))
    port = start_world(jobs, 4, tmp / "world")

    jax_out = {}
    for name, (mesh_name, kw, b, accum, mu) in CASES.items():
        mesh = jax_mesh(mesh_name)
        optimizer, state = jax_state(params, mesh, mu)
        step = jtrain.make_train_step(jget_config("test", **BASE, **kw), optimizer, mesh,
                                      grad_accum=accum)
        losses, norms = [], []
        for tokens, targets in batches(b, seed=1):
            state, m = step(state, tokens, targets)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        jax_out[name] = dict(losses=losses, norms=norms,
                             params={k: np.asarray(v) for k, v in state.params.items()})
    return dict(jax=jax_out, port=port(), params=params, tmp=tmp, jax_tree=jax_tree)


def _jax_entries(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat]


def _mesh(name):
    return sharding.make_mesh(**MESHES[name]) if "ranks" in MESHES[name] else sharding.make_mesh(
        **MESHES[name], world=4)


def _spec(key):
    return sharding.spec_of_key(key)


def _global(leaf_key, pieces, shape, mesh):
    """The global array assembled from each rank's piece of ``leaf_key``."""
    out = np.zeros(shape, pieces[0][leaf_key].dtype)
    for rank, tree in enumerate(pieces):
        out[sharding.local_slices(_spec(leaf_key), shape, mesh, rank)] = tree[leaf_key]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_match_jax(name, runs):
    mesh_name, kw, _, _, _ = CASES[name]
    ref = runs["jax"][name]
    index = list(CASES).index(name)
    results = [rank[index] for rank in runs["port"]]
    rtol = QUANT_RTOL if kw.get("quant") else TOL
    for rank, got in enumerate(results):
        assert got["losses"] == results[0]["losses"] and got["norms"] == results[0]["norms"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["norms"], ref["norms"], rtol=rtol, err_msg=f"rank {rank}")
    if kw.get("quant"):
        return  # the parameters carry the flips of both steps
    mesh = _mesh(mesh_name)
    trees = [got["tree"] for got in results]
    diffs = np.concatenate([
        np.abs(_global(f".params[{k!r}]", trees, v.shape, mesh) - ref["params"][k]).ravel()
        for k, v in runs["params"].items()
    ])
    # test_torch_train.py's allowance: AdamW's sign-like step moves a
    # parameter whose gradient is rounding noise by up to lr a step.
    assert (diffs > TOL).mean() <= 1e-4, (diffs > TOL).sum()
    assert diffs.max() <= STEPS * ttrain.make_optimizer().learning_rate


def test_the_port_checkpoint_restores_meshless_and_in_jax_bit_exactly(runs):
    """The fsdp2 x tp2 world's checkpoint (4 shard files, the first holder
    of each piece writing it): meshless in the port, and through JAX's
    manager, every leaf equals the ranks' pieces, bit for bit."""
    index = list(CASES).index(CKPT_CASE)
    trees = [rank[index]["tree"] for rank in runs["port"]]
    mesh = _mesh("fsdp2-tp2")
    directory = str(runs["tmp"] / "port-ckpt")
    manifest = tckpt.CheckpointManager(directory).read_manifest()
    assert manifest["process_count"] == 4 and manifest["mesh"] == MESHES["fsdp2-tp2"]
    optimizer = ttrain.make_optimizer()
    state = ttrain.init_train_state(tget_config("test", **BASE), optimizer, torch.device("cpu"))
    tree, _ = tckpt.CheckpointManager(directory).restore(ttrain.state_tree(state))
    ttrain.load_state_tree(state, tree)
    restored = dict(tckpt.leaf_entries(ttrain.state_tree(state)))
    jmesh = jax_mesh("fsdp2-tp2")
    _, jstate = jax_state(runs["params"], jmesh, None)
    jrestored, _ = JaxManager(directory, process_index=0, process_count=1).restore(jstate)
    jleaves = dict(_jax_entries(jrestored))
    for key, leaf in restored.items():
        want = _global(key, trees, tuple(leaf.shape), mesh)
        np.testing.assert_array_equal(leaf.detach().numpy(), want, err_msg=key)
        np.testing.assert_array_equal(np.asarray(jleaves[key]), want, err_msg=key)


def test_a_jax_checkpoint_restores_onto_the_port_world_bit_exactly(runs):
    """A JAX dp2/fsdp4 TrainState (bf16 first moment) restores onto the
    port's fsdp2 x tp2 world: each rank's pieces are the JAX arrays' slices,
    bf16 bits included."""
    results = [rank[len(CASES)] for rank in runs["port"]]
    mesh = _mesh("fsdp2-tp2")
    for rank, got in enumerate(results):
        assert got["mesh"] == MESHES["dp2-fsdp4"]
        for key, want in runs["jax_tree"].items():
            if want.dtype.name == "bfloat16":
                want = want.view(np.uint16)
            piece = want[sharding.local_slices(_spec(key), want.shape, mesh, rank)]
            np.testing.assert_array_equal(got["tree"][key], piece, err_msg=f"rank {rank} {key}")


def test_main_runs_the_training_examples_mesh_flags_on_four_ranks(runs):
    """train.main with --tp 2 --tp-overlap --fsdp-overlap and the example's
    other flags: 2 steps on every rank, a 4-process checkpoint JAX reads."""
    for got in (rank[-1] for rank in runs["port"]):
        assert got["stats"]["compile_s"] > 0 and got["stats"]["tokens_per_sec"] > 0
    directory = runs["tmp"] / "main-ckpt"
    manifest = json.loads((directory / "step-00000002" / "manifest.json").read_text())
    assert manifest["process_count"] == 4
    assert manifest["mesh"] == dict(dp=1, fsdp=2, tp=2, sp=1)
    assert sorted(p.name for p in (directory / "step-00000002").glob("_COMMIT-*")) == [
        f"_COMMIT-{r:05d}" for r in range(4)]
    assert JaxManager(str(directory), process_index=0, process_count=1).latest_step() == 2
