"""The port's MoE train step on the ep mesh against the JAX package's
meshless step, on the CPU.

The port runs in one gloo world of 4 processes, spawned once for the file
(``tests/torch_mesh_worker.py``), on ``test_torch_moe.py``'s geometry (4
experts, top-2, groups of 8 tokens, capacity factor 0.75, fp32): each rank
takes its rows over dp x fsdp x ep (``data.rank_rows``) and its pieces of
the parameters (``moe.shard_moe_params``), E/ep experts among them; JAX runs
``make_moe_train_step`` meshless on the same global batches. Over 2 steps
at ep 4 and at dp 2 x ep 2 (grad_accum 2, remat, the chunked loss) the
losses agree within 1e-5 and every rank reports the same losses and grad
norms; the parameters after them agree within ``test_torch_train.py``'s
allowance. The dp 2 x ep 2 world's checkpoint restores meshless in the port
and in JAX bit for bit. ``train.main`` runs the MoE preset under ``--ep 2``
on the world and exits with the reference's messages where the reference
does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import moe as tmoe
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads import train as ttrain
from tests.test_torch_moe import KW, TOL, batch, cfgs
from tests.torch_mesh_worker import start_world

STEPS = 2
MESHES = {"ep4": dict(dp=1, fsdp=1, ep=4, tp=1, sp=1),
          "dp2-ep2": dict(dp=2, fsdp=1, ep=2, tp=1, sp=1)}
# (mesh, config overrides, global batch, grad_accum)
CASES = {
    "ep4": ("ep4", dict(), 4, 1),
    "dp2-ep2-accum2-remat-chunked": ("dp2-ep2", dict(remat=True, loss_chunk=8), 8, 2),
}
CKPT_CASE = "dp2-ep2-accum2-remat-chunked"
MAIN_ARGV = ["--device", "cpu", "--config", "moe_test", "--seq", "32", "--steps", "2",
             "--ep", "2"]


def np_params():
    rng = np.random.RandomState(1)
    tree = {}
    for k, shape in tmoe.moe_param_shapes(cfgs()[1]).items():
        if k.endswith("norm"):
            tree[k] = np.ones(shape, np.float32)
        else:
            fan_in = KW["d_model"] if k == "embed" else shape[-2]
            tree[k] = (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
    return tree


def batches(b):
    return [batch(40 + i, ignore=False, b=b) for i in range(STEPS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's world of 4, once, over every case, the checkpoint, main
    and its exits; JAX's meshless runs of every case, computed while the
    world runs."""
    params = np_params()
    tmp = tmp_path_factory.mktemp("moe-mesh")
    jobs = [("moe_steps", dict(shape=MESHES[m], cfg_kw={**KW, **kw}, params=params,
                               batches=batches(b), grad_accum=accum,
                               ckpt_dir=str(tmp / "port-ckpt") if name == CKPT_CASE else None))
            for name, (m, kw, b, accum) in CASES.items()]
    jobs.append(("main", dict(argv=MAIN_ARGV + ["--checkpoint-dir", str(tmp / "main-ckpt"),
                                                "--checkpoint-every", "1"])))
    jobs.append(("main_exit", dict(argv=MAIN_ARGV + ["--ep", "3"])))
    port = start_world(jobs, 4, tmp / "world")

    jax_out = {}
    for name, (_, kw, b, accum) in CASES.items():
        optimizer = jtrain.make_optimizer()
        jparams = {k: jnp.array(v) for k, v in params.items()}
        jopt = optimizer.init(jparams)
        step = jmoe.make_moe_train_step(cfgs(**kw)[0], optimizer, grad_accum=accum)
        losses = []
        for tokens, targets in batches(b):
            jparams, jopt, loss = step(jparams, jopt, tokens, targets)
            losses.append(float(loss))
        jax_out[name] = dict(losses=losses,
                             params={k: np.asarray(v) for k, v in jparams.items()},
                             opt=jopt)
    return dict(jax=jax_out, port=port(), params=params, tmp=tmp)


def _mesh(name):
    return sharding.make_moe_mesh(**MESHES[name], world=4)


def _global(key, pieces, shape, mesh):
    """The global array assembled from each rank's piece of ``key``."""
    out = np.zeros(shape, pieces[0][key].dtype)
    spec = sharding.spec_of_key(key, sharding.MOE_PARAM_SPECS)
    for rank, tree in enumerate(pieces):
        out[sharding.local_slices(spec, shape, mesh, rank)] = tree[key]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_moe_steps_on_the_ep_mesh_match_jax(name, runs):
    mesh_name = CASES[name][0]
    ref = runs["jax"][name]
    results = [rank[list(CASES).index(name)] for rank in runs["port"]]
    mesh = _mesh(mesh_name)
    e, ep = KW["n_experts"], MESHES[mesh_name]["ep"]
    data = MESHES[mesh_name]["dp"] * MESHES[mesh_name]["fsdp"]
    for rank, got in enumerate(results):
        assert got["losses"] == results[0]["losses"] and got["norms"] == results[0]["norms"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL, err_msg=f"rank {rank}")
        # A rank holds E/ep experts, their d_model split over the data axes.
        assert got["tree"]["['params']['w_gate']"].shape == (
            KW["n_layers"], e // ep, KW["d_model"] // data, KW["d_ff"])
        assert got["coords"] == mesh.coords(rank)
    trees = [got["tree"] for got in results]
    diffs = np.concatenate([
        np.abs(_global(f"['params'][{k!r}]", trees, v.shape, mesh) - ref["params"][k]).ravel()
        for k, v in runs["params"].items()
    ])
    assert (diffs > TOL).mean() <= 1e-4, (diffs > TOL).sum()
    assert diffs.max() <= STEPS * ttrain.make_optimizer().learning_rate


def test_the_ep_mesh_checkpoint_restores_meshless_bit_exactly(runs):
    """The dp2 x ep2 world's checkpoint (4 shard files, each piece written by
    its first holder) restores meshless in the port and through JAX's
    manager: every leaf equals the ranks' pieces, bit for bit."""
    trees = [rank[list(CASES).index(CKPT_CASE)]["tree"] for rank in runs["port"]]
    mesh = _mesh("dp2-ep2")
    directory = str(runs["tmp"] / "port-ckpt")
    manifest = tckpt.CheckpointManager(directory).read_manifest()
    assert manifest["process_count"] == 4 and manifest["mesh"] == MESHES["dp2-ep2"]
    optimizer = ttrain.make_optimizer()
    state = tmoe.init_moe_train_state(cfgs()[1], optimizer, torch.device("cpu"))
    tree, _ = tckpt.CheckpointManager(directory).restore(ttrain.state_tree(state))
    ttrain.load_state_tree(state, tree)
    assert state.step == STEPS
    restored = dict(tckpt.leaf_entries(ttrain.state_tree(state)))
    template = {"params": {k: jnp.asarray(v) for k, v in runs["params"].items()},
                "opt": runs["jax"][CKPT_CASE]["opt"]}
    jrestored, _ = JaxManager(directory, process_index=0, process_count=1).restore(template)
    flat, _ = jax.tree_util.tree_flatten_with_path(jrestored)
    jleaves = {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}
    assert list(jleaves) == list(restored)
    for key, leaf in restored.items():
        want = _global(key, trees, tuple(leaf.shape), mesh)
        np.testing.assert_array_equal(leaf.detach().numpy(), want, err_msg=key)
        np.testing.assert_array_equal(jleaves[key], want, err_msg=key)


def test_main_trains_the_moe_preset_under_ep_on_four_ranks(runs):
    """train.main --config moe_test --ep 2 on the world of 4: dp 2 x ep 2,
    2 steps on every rank, a 4-process checkpoint JAX reads."""
    for got in (rank[len(CASES)] for rank in runs["port"]):
        assert got["stats"]["compile_s"] > 0 and got["stats"]["tokens_per_sec"] > 0
        assert "mfu" not in got["stats"], "the MoE branch reports no MFU"
    directory = runs["tmp"] / "main-ckpt"
    manifest = json.loads((directory / "step-00000002" / "manifest.json").read_text())
    assert manifest["process_count"] == 4
    assert manifest["mesh"] == MESHES["dp2-ep2"]
    assert JaxManager(str(directory), process_index=0, process_count=1).latest_step() == 2


@pytest.mark.parametrize("argv,message", [
    (["--multislice"], "--multislice is not supported for MoE configs yet"),
    (["--tp", "2"], "--tp/--tp-overlap are not supported for MoE configs"),
    (["--ep", "3"], "1 devices not divisible by ep=3"),
    (["--draft-head"], "--draft-head supports dense configs only"),
    ("world", "4 devices not divisible by ep=3"),
], ids=["multislice", "tp", "ep-one-process", "draft-head", "ep-world"])
def test_main_exits_with_the_reference_messages(argv, message, runs):
    if argv == "world":
        got = [rank[len(CASES) + 1] for rank in runs["port"]]
        assert all(message in m for m in got), got
        return
    with pytest.raises(SystemExit, match=message.replace("*", r"\*")):
        ttrain.main(["--device", "cpu", "--config", "moe_test", "--steps", "1", *argv])
