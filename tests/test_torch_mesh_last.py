"""The draft head on a training mesh, MoE under sp and MoE with the
all-gather ring: the port against its meshless runs and the JAX package,
on the CPU.

The port runs in one gloo world of 4 processes, spawned once for the file
(``tests/torch_mesh_worker.py``); the meshless port runs and JAX (on 4 of
its 8 CPU devices) run in this process meanwhile, in fp32, on the same
numpy-seeded inputs:

- ``train.main --draft-head`` on fsdp 2 x tp 2 (``--tp 2``) and on fsdp 4,
  3 steps on a token file, against the meshless run of the same command
  and against JAX's ``_draft_main`` steps on fsdp 2 x tp 2 from the same
  target, head and batches: losses within 1e-5, the trained draft head
  within 1e-5 but for the few entries that AdamW's sign-like step moves on
  rounding noise (``DRAFT_NOISE``, the measured counts). The mesh run's
  checkpoint restores meshless, in the port and through the JAX package's
  manager, the ``.draft`` subtree bit for bit and ``.params`` equal to the
  meshless run's target; ``--resume`` continues it in place;
- 3 MoE steps at ``make_moe_mesh(ep=2, sp=2)`` against JAX's
  ``make_moe_train_step`` on the same mesh, losses and parameters within
  1e-5 (``test_torch_ring.py``'s allowance), once with routing groups that
  divide a rank's chunk and once with groups that straddle ranks; the aux
  loss of the forward against JAX's;
- MoE with ``fsdp_overlap`` at fsdp 2 x ep 2 (the ring over dp, fsdp and
  ep) against JAX's step on the same mesh, and ``train.main --config
  moe_test --ep 2 --fsdp-overlap`` against the same command without the
  ring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dstack_tpu.workloads import config as jconfig
from dstack_tpu.workloads import data as jdata
from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import sharding as jsharding
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import config as tconfig
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import sharding
from tests.test_torch_ring import MOE, STEPS, TOL, _check_steps, moe_params, step_batches
from tests.torch_mesh_worker import main_losses, start_world

FP32 = {"test": dict(dtype="float32")}
MOE_FP32 = {"moe_test": dict(dtype="float32")}
DRAFT_STEPS = 3
SEQ = 32
# (extra argv, checkpoint directory name)
DRAFT_MESHES = {"fsdp2-tp2": ["--tp", "2"], "fsdp4": []}
SP_MESH = dict(dp=1, fsdp=1, ep=2, tp=1, sp=2)
RING_MESH = dict(dp=1, fsdp=2, ep=2, tp=1, sp=1)
SP_T, SP_BATCH = 32, 4
# The draft head's entries over 1e-5 at most, and the largest difference,
# after the mesh runs' steps: measured on these seeds 28 of 918,272 entries
# at fsdp 2 x tp 2 and 14 at fsdp 4 (also after the resumed 4th step)
# against the meshless run, largest 7.65e-5; 29 at each mesh against JAX's
# steps on fsdp 2 x tp 2, largest 2.95e-4. The limits leave a tenth over
# the counts.
DRAFT_NOISE = {"fsdp2-tp2": (31, 1e-4), "fsdp4": (16, 1e-4), "jax": (32, 5e-4)}
# router_group 8 divides a rank's chunk of 16; 32 straddles the two chunks.
ROUTING = {"groups-in-a-chunk": 8, "groups-straddle-ranks": 32}


def token_file(path):
    rng = np.random.RandomState(11)
    rng.randint(0, 4096, 8 * (SEQ + 1) * 8).astype(np.uint16).tofile(path)
    return str(path)


def draft_argv(data, ckpt, steps=DRAFT_STEPS):
    return ["--device", "cpu", "--config", "test", "--draft-head", "--seq", str(SEQ),
            "--steps", str(steps), "--batch", "8", "--prefetch", "0", "--data", data,
            "--checkpoint-dir", str(ckpt)]


def moe_main_argv(data, ckpt):
    return ["--device", "cpu", "--config", "moe_test", "--ep", "2", "--seq", str(SEQ),
            "--steps", str(DRAFT_STEPS), "--batch", "8", "--prefetch", "0", "--data", data,
            "--checkpoint-dir", str(ckpt), "--checkpoint-every", str(DRAFT_STEPS)]


def jax_draft_steps(data, target):
    """JAX's ``_draft_main`` steps on ``make_mesh(tp=2)`` over 4 CPU devices
    (fsdp 2 x tp 2): ``target`` sharded by ``param_sharding``, the port's
    initial draft head (``train.distill``'s draw) replicated, AdamW at the
    CLI's draft lr, rollout 2, fed by JAX's ``input_pipeline`` from the
    token file. Returns the losses and the trained head."""
    tcfg = tconfig.get_config("test", **FP32["test"])
    draft = tmodel.init_draft_params(tcfg, torch.Generator().manual_seed(1),
                                     torch.device("cpu"), n_layers=2, d_ff=0)
    cfg = jconfig.get_config("test", **FP32["test"])
    mesh = jsharding.make_mesh(tp=2, devices=jax.devices()[:4])
    optimizer = jtrain.make_optimizer(learning_rate=1e-3)
    with mesh:
        shardings = jsharding.param_sharding(mesh)
        jtarget = {k: jax.device_put(jnp.asarray(v), shardings[k]) for k, v in target.items()}
        jdraft = jax.device_put({k: jnp.asarray(v.numpy()) for k, v in draft.items()},
                                NamedSharding(mesh, P()))
        state = jtrain.DraftTrainState(jtarget, jdraft, optimizer.init(jdraft),
                                       jnp.zeros((), jnp.int32))
        step = jtrain.make_draft_distill_step(cfg, optimizer, mesh, rollout=2)
        feed = jdata.input_pipeline(mesh, jsharding.BATCH_SPEC, 8, SEQ, cfg.vocab_size,
                                    data_path=data, prefetch=0)
        losses = []
        try:
            for _ in range(DRAFT_STEPS):
                tokens, _ = next(feed)
                state, loss = step(state, tokens)
                losses.append(float(loss))
        finally:
            feed.close()
    return dict(losses=losses, draft={k: np.asarray(v) for k, v in state.draft.items()})


def sp_cfg(router_group):
    return {**MOE, "router_group": router_group}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-last")
    data = token_file(tmp / "tokens.bin")
    moe = moe_params()
    sp_batches = step_batches(SP_BATCH, SP_T, MOE["vocab_size"], 12)
    jobs = [("main_losses", dict(argv=draft_argv(data, tmp / name) + extra, presets=FP32))
            for name, extra in DRAFT_MESHES.items()]
    jobs.append(("main_losses", dict(argv=draft_argv(data, tmp / "fsdp4", steps=4)
                                     + ["--resume"], presets=FP32)))
    jobs += [("moe_steps", dict(shape=SP_MESH, cfg_kw=sp_cfg(g), params=moe,
                                batches=sp_batches)) for g in ROUTING.values()]
    jobs += [("moe_aux", dict(shape=SP_MESH, cfg_kw=sp_cfg(g), params=moe,
                              tokens=sp_batches[0][0])) for g in ROUTING.values()]
    ring_kw = {**MOE, "fsdp_overlap": True}
    jobs.append(("moe_steps", dict(shape=RING_MESH, cfg_kw=ring_kw, params=moe,
                                   batches=step_batches(8, 16, MOE["vocab_size"], 13))))
    jobs += [("main_losses", dict(argv=moe_main_argv(data, tmp / f"moe{flag}") + flag,
                                  presets=MOE_FP32))
             for flag in (["--fsdp-overlap"], [])]
    port = start_world(jobs, 4, tmp / "world", timeout=300.0)

    meshless = {steps: main_losses(draft_argv(data, tmp / f"meshless{steps}", steps=steps),
                                   presets=FP32) for steps in (DRAFT_STEPS, 4)}
    devices = jax.devices()[:4]
    optimizer = jtrain.make_optimizer()
    jax_out = {}

    def jax_steps(cfg, shape, batches):
        mesh = jmoe.make_moe_mesh(**shape, devices=devices)
        with mesh:
            jparams = jmoe.shard_moe_params({k: jnp.asarray(a) for k, a in moe.items()}, mesh)
            jopt = optimizer.init(jparams)
            step = jmoe.make_moe_train_step(cfg, optimizer, mesh)
            losses = []
            for tokens, targets in batches:
                jparams, jopt, loss = step(jparams, jopt, tokens, targets)
                losses.append(float(loss))
        return dict(losses=losses, params={k: np.asarray(a) for k, a in jparams.items()})

    for name, g in ROUTING.items():
        cfg = jmoe.MoeConfig(**sp_cfg(g))
        jax_out[name] = jax_steps(cfg, SP_MESH, sp_batches)
        _, aux = jmoe.forward({k: jnp.asarray(a) for k, a in moe.items()},
                              jnp.asarray(sp_batches[0][0]), cfg)
        jax_out[name]["aux"] = float(aux)
    jax_out["ring"] = jax_steps(jmoe.MoeConfig(**ring_kw), RING_MESH,
                                step_batches(8, 16, MOE["vocab_size"], 13))
    target = _tree(tmp / f"meshless{DRAFT_STEPS}", DRAFT_STEPS, ".params")
    jax_out["draft"] = jax_draft_steps(data, target)
    return dict(port=port(), meshless=meshless, jax=jax_out, moe=moe, tmp=tmp)


def _close_drafts(got, want, limits):
    """The trained heads alike within 1e-5 but for ``limits`` = (entries,
    largest difference): AdamW's sign-like step moves a parameter whose
    gradient is rounding noise by up to the draft's lr (1e-3) a step, and a
    few dozen of the head's 918,272 entries have such gradients (DRAFT_NOISE
    states the counts)."""
    assert set(got) == set(want)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    most, largest = limits
    assert (diffs > TOL).sum() <= most, (diffs > TOL).sum()
    assert diffs.max() <= largest, diffs.max()


def _job(runs, i):
    return [rank[i] for rank in runs["port"]]


def _tree(ckpt_dir, step, prefix):
    """The ``prefix`` (".draft" or ".params") subtree of checkpoint
    ``step``, restored meshless."""
    manager = tckpt.CheckpointManager(str(ckpt_dir))
    template = {leaf["key"][len(prefix) + 2:-2]: tckpt.LeafSpec(tuple(leaf["shape"]),
                                                                 torch.float32)
                for leaf in manager.read_manifest(step)["leaves"]
                if leaf["key"].startswith(prefix)}
    tree, _ = manager.restore_subtree(template, step=step, prefix=prefix)
    return {k: v.numpy() for k, v in tree.items()}


def _draft(ckpt_dir, step):
    """The ``.draft`` subtree of checkpoint ``step``, restored meshless."""
    return _tree(ckpt_dir, step, ".draft")


@pytest.mark.parametrize("name", list(DRAFT_MESHES))
def test_the_draft_head_on_a_training_mesh_matches_meshless(name, runs):
    results = _job(runs, list(DRAFT_MESHES).index(name))
    ref = runs["meshless"][DRAFT_STEPS]
    for rank, got in enumerate(results):
        assert got["losses"] == results[0]["losses"], rank
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL, err_msg=name)
    _close_drafts(_draft(runs["tmp"] / name, DRAFT_STEPS),
                  _draft(runs["tmp"] / f"meshless{DRAFT_STEPS}", DRAFT_STEPS), DRAFT_NOISE[name])


@pytest.mark.parametrize("name", list(DRAFT_MESHES))
def test_the_draft_head_on_a_training_mesh_matches_jax(name, runs):
    """Each mesh run against JAX's ``_draft_main`` steps on fsdp 2 x tp 2 from
    the same target, head and batches: losses within 1e-5, and the trained
    head within 1e-5 but for DRAFT_NOISE["jax"]."""
    results = _job(runs, list(DRAFT_MESHES).index(name))
    ref = runs["jax"]["draft"]
    for got in results:
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=TOL, err_msg=name)
    _close_drafts(_draft(runs["tmp"] / name, DRAFT_STEPS), ref["draft"], DRAFT_NOISE["jax"])


def test_a_mesh_draft_checkpoint_restores_meshless(runs):
    """The fsdp 2 x tp 2 run's checkpoint, read by a meshless manager in the
    port and by the JAX package's: .draft bit for bit alike, .params the
    meshless run's target bit for bit."""
    path = runs["tmp"] / "fsdp2-tp2"
    manager = tckpt.CheckpointManager(str(path))
    manifest = manager.read_manifest(DRAFT_STEPS)
    assert manifest["mesh"] == {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1}
    port = _draft(path, DRAFT_STEPS)
    jtemplate = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32) for k, v in port.items()}
    jdraft, _ = JaxManager(str(path)).restore_subtree(jtemplate, step=DRAFT_STEPS,
                                                      prefix=".draft")
    for k, v in port.items():
        np.testing.assert_array_equal(v, np.asarray(jdraft[k]), err_msg=k)
    shapes = {leaf["key"][len(".params['"):-2]: tuple(leaf["shape"])
              for leaf in manifest["leaves"] if leaf["key"].startswith(".params")}
    template = {k: tckpt.LeafSpec(s, torch.float32) for k, s in shapes.items()}
    mesh_params, _ = manager.restore_subtree(template, step=DRAFT_STEPS, prefix=".params")
    ref_params, _ = tckpt.CheckpointManager(str(runs["tmp"] / f"meshless{DRAFT_STEPS}")
                                            ).restore_subtree(template, step=DRAFT_STEPS,
                                                              prefix=".params")
    for k in shapes:
        np.testing.assert_array_equal(mesh_params[k].numpy(), ref_params[k].numpy(), err_msg=k)


def test_resume_continues_a_mesh_draft_run_in_place(runs):
    results = _job(runs, len(DRAFT_MESHES))
    ref = runs["meshless"][4]
    for got in results:
        assert len(got["losses"]) == 1  # step 4 only: steps 1-3 were restored
        np.testing.assert_allclose(got["losses"], ref["losses"][-1:], rtol=TOL)
    _close_drafts(_draft(runs["tmp"] / "fsdp4", 4), _draft(runs["tmp"] / "meshless4", 4),
                  DRAFT_NOISE["fsdp4"])


@pytest.mark.parametrize("name", list(ROUTING))
def test_moe_steps_under_sp_match_jax(name, runs):
    results = _job(runs, len(DRAFT_MESHES) + 1 + list(ROUTING).index(name))
    mesh = sharding.make_moe_mesh(**SP_MESH, world=4)
    for rank, got in enumerate(results):
        assert got["coords"] == mesh.coords(rank)
    _check_steps(results, runs["jax"][name], runs["moe"], mesh, sharding.MOE_PARAM_SPECS,
                 "['params']", norms=False)


@pytest.mark.parametrize("name", list(ROUTING))
def test_the_moe_aux_loss_under_sp_matches_jax(name, runs):
    results = _job(runs, len(DRAFT_MESHES) + 1 + len(ROUTING) + list(ROUTING).index(name))
    for got in results:
        np.testing.assert_allclose(got["aux"], runs["jax"][name]["aux"], rtol=TOL)


def test_moe_steps_with_the_all_gather_ring_match_jax(runs):
    results = _job(runs, len(DRAFT_MESHES) + 1 + 2 * len(ROUTING))
    mesh = sharding.make_moe_mesh(**RING_MESH, world=4)
    _check_steps(results, runs["jax"]["ring"], runs["moe"], mesh, sharding.MOE_PARAM_SPECS,
                 "['params']", norms=False)


def test_moe_main_with_fsdp_overlap_matches_the_plain_gather(runs):
    first = len(DRAFT_MESHES) + 2 + 2 * len(ROUTING)
    ring, plain = _job(runs, first), _job(runs, first + 1)
    assert len(ring[0]["losses"]) == STEPS
    for got, want in zip(ring, plain):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
