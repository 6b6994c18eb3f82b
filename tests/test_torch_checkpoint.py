"""The port's checkpoints against the JAX package's, on the CPU.

One format, both ways, on the ``test`` preset (fp32 activations): a
TrainState that JAX writes after one step (meshless, and placed on the
8-device dp2/fsdp4 mesh, so several shards per leaf) restores into the port's state
bit for bit, the bf16 first moment through its uint16 view; a state the
port writes restores through JAX's ``CheckpointManager.restore`` bit for
bit; and one port step from the restored state equals one JAX step (loss
and grad norm within 1e-5, parameters as ``test_torch_train`` bounds them).
Then the manager's own contract, case for case after
``tests/test_checkpoint.py``: the commit protocol, prune, save errors,
structure and shape mismatches, ``restore_subtree``'s matching, the train
hooks, and a crash-and-resume through ``train.main`` that equals an
uninterrupted run.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu.workloads.checkpoint import leaf_entries as jax_leaf_entries
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu.workloads.sharding import make_mesh, param_sharding
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import get_config as tget_config

PRESET = dict(dtype="float32", remat=False)
JCFG, TCFG = jget_config("test", **PRESET), tget_config("test", **PRESET)
B, T = 2, 16
TOL = 1e-5
CPU = torch.device("cpu")


class CaptureEmitter:
    def __init__(self):
        self.points = []

    def emit(self, kind, **fields):
        self.points.append({"kind": kind, **fields})

    def mark(self, event, **fields):
        self.emit("mark", event=event, **fields)

    def marks(self, event):
        return [p for p in self.points if p.get("event") == event]


def batch(seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, JCFG.vocab_size, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def host(leaf) -> np.ndarray:
    """A leaf's bits: bf16 through its uint16 view, everything else as is."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def port_state(mu_dtype="bfloat16"):
    optimizer = ttrain.make_optimizer(mu_dtype=mu_dtype)
    return optimizer, ttrain.init_train_state(TCFG, optimizer, CPU)


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """A JAX TrainState with a bf16 first moment after one jitted step,
    saved meshless and again placed on the dp2/fsdp4 mesh (params and
    moments sharded per sharding.PARAM_SPECS, several pieces a leaf). Also
    the step function, for the next step."""
    optimizer = jtrain.make_optimizer(mu_dtype="bfloat16")
    init = jax.jit(jtrain.init_train_state, static_argnums=(0, 2))
    state = init(JCFG, jax.random.PRNGKey(0), optimizer)
    step_fn = jtrain.make_train_step(JCFG, optimizer)
    state, _ = step_fn(state, *batch(1))
    mesh = make_mesh(dp=2, fsdp=4, devices=jax.devices()[:8])
    shardings = param_sharding(mesh)
    meshed = jax.tree_util.tree_map_with_path(
        lambda path, x: jax.device_put(x, shardings[path[-1].key])
        if getattr(path[-1], "key", None) in shardings else x,
        state,
    )
    dirs = {}
    for layout, tree, mesh_shape in (("meshless", state, None),
                                     ("dp2-fsdp4", meshed, dict(mesh.shape))):
        dirs[layout] = str(tmp_path_factory.mktemp(layout))
        JaxManager(dirs[layout], process_index=0, process_count=1).save(
            1, tree, data_offset=1, mesh_shape=mesh_shape, block=True)
    return {"dirs": dirs, "states": {"meshless": state, "dp2-fsdp4": meshed},
            "step_fn": step_fn}


def test_port_flattens_to_jax_key_paths(jax_checkpoints):
    jkeys = [k for k, _ in jax_leaf_entries(jax_checkpoints["states"]["meshless"])]
    keys = [k for k, _ in tckpt.leaf_entries(ttrain.state_tree(port_state()[1]))]
    assert keys == jkeys
    assert keys[12] == ".opt_state[1][0].count" and keys[-1] == ".step"


@pytest.mark.parametrize("layout", ["meshless", "dp2-fsdp4"])
def test_port_restores_a_jax_checkpoint_bit_exactly(layout, jax_checkpoints):
    directory = jax_checkpoints["dirs"][layout]
    if layout == "dp2-fsdp4":
        names = np.load(os.path.join(directory, "step-00000001", "shard-00000.npz")).files
        assert len(names) > len(jax_leaf_entries(jax_checkpoints["states"][layout])), \
            "the mesh was meant to split leaves into several shards"
    _, state = port_state()
    manager = tckpt.CheckpointManager(directory)
    tree, manifest = manager.restore(ttrain.state_tree(state))
    ttrain.load_state_tree(state, tree)
    restored = tckpt.leaf_entries(ttrain.state_tree(state))
    reference = jax_leaf_entries(jax_checkpoints["states"][layout])
    assert [k for k, _ in restored] == [k for k, _ in reference]
    for (key, got), (_, ref) in zip(restored, reference):
        np.testing.assert_array_equal(host(got), host(ref), err_msg=key)
    assert state.opt.state[state.params["wq"]]["mu"].dtype == torch.bfloat16
    assert state.step == manifest["step"] == int(jax_checkpoints["states"][layout].step)


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_jax_restores_a_port_checkpoint_bit_exactly(mu_dtype, tmp_path):
    optimizer, state = port_state(None if mu_dtype == "float32" else mu_dtype)
    step = ttrain.make_train_step(TCFG, optimizer)
    for seed in (1, 2):
        state, _ = step(state, *(torch.from_numpy(a) for a in batch(seed)))
    emitter = CaptureEmitter()
    manager = tckpt.CheckpointManager(str(tmp_path), telemetry=emitter)
    manager.save(2, ttrain.state_tree(state), data_offset=2, block=True)
    assert manager.save_errors == 0, manager.last_error
    assert emitter.marks("checkpoint_end")[0]["blocked_s"] >= 0
    assert emitter.marks("checkpoint_saved")[0]["write_s"] >= 0
    jopt = jtrain.make_optimizer(mu_dtype=None if mu_dtype == "float32" else mu_dtype)
    template = jax.eval_shape(lambda: jtrain.init_train_state(JCFG, jax.random.PRNGKey(3), jopt))
    restored, manifest = JaxManager(str(tmp_path), process_index=0, process_count=1).restore(
        template)
    assert manifest["data_offset"] == 2
    ours = tckpt.leaf_entries(ttrain.state_tree(state))
    theirs = jax_leaf_entries(restored)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (key, got), (_, ref) in zip(ours, theirs):
        np.testing.assert_array_equal(host(got), host(ref), err_msg=key)


def test_one_port_step_from_a_restored_state_equals_one_jax_step(jax_checkpoints):
    _, state = port_state()
    tree, _ = tckpt.CheckpointManager(jax_checkpoints["dirs"]["meshless"]).restore(
        ttrain.state_tree(state))
    ttrain.load_state_tree(state, tree)
    tokens, targets = batch(2)
    jstate, jm = jax_checkpoints["step_fn"](jax_checkpoints["states"]["meshless"], tokens,
                                            targets)
    step = ttrain.make_train_step(TCFG, ttrain.make_optimizer(mu_dtype="bfloat16"))
    state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=TOL)
    assert m["step"] == int(jm["step"]) == 2
    # AdamW's sign-like step (test_torch_train.test_train_steps_match_jax).
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(jstate.params[k])).ravel()
        for k, p in state.params.items()
    ])
    assert (diffs > TOL).mean() <= 1e-4 and diffs.max() <= 3e-4


# -- the manager's contract, after tests/test_checkpoint.py ----------------------

CASES = ["incomplete-ignored", "prune-keeps-latest", "multiprocess-merge", "save-error",
         "snapshot-failure", "structure-mismatch", "shape-mismatch", "subtree-prefix",
         "subtree-suffix", "subtree-ambiguous"]


@pytest.mark.parametrize("case", CASES)
def test_manager_contract(case, tmp_path):
    emitter = CaptureEmitter()
    mgr = tckpt.CheckpointManager(str(tmp_path), telemetry=emitter)
    x = {"x": torch.arange(8.0)}
    if case == "incomplete-ignored":
        mgr.save(5, x, block=True)
        torn = tmp_path / "step-00000009"
        torn.mkdir()
        (torn / "manifest.json").write_text(json.dumps(
            {"step": 9, "process_count": 1, "leaves": []}))
        (torn / "shard-00000.npz").write_bytes(b"garbage")
        assert mgr.latest_step() == 5
        restored, manifest = mgr.restore({"x": torch.zeros(8)})
        assert manifest["step"] == 5 and torch.equal(restored["x"], x["x"])
    elif case == "prune-keeps-latest":
        for step in (1, 2, 3, 4):
            mgr.save(step, x, block=True)
        assert mgr.complete_steps() == [3, 4]
    elif case == "multiprocess-merge":
        # Two processes' shard files, each holding half the rows of one
        # leaf, rebuild it; without one of them the restore fails loudly.
        full = np.arange(64.0, dtype=np.float32).reshape(8, 8)
        step_dir = tmp_path / "step-00000001"
        step_dir.mkdir()
        for p, rows in ((0, "0:4"), (1, "4:8")):
            lo, hi = map(int, rows.split(":"))
            np.savez(step_dir / f"shard-{p:05d}.npz", **{f"0@{rows},0:8": full[lo:hi]})
            (step_dir / f"_COMMIT-{p:05d}").write_text("1")
        (step_dir / "manifest.json").write_text(json.dumps({
            "step": 1, "process_count": 2, "mesh": {"dp": 2}, "data_offset": 1,
            "leaves": [{"key": "['w']", "shape": [8, 8], "dtype": "float32"}], "extra": {}}))
        restored, _ = mgr.restore({"w": torch.zeros(8, 8)})
        np.testing.assert_array_equal(restored["w"].numpy(), full)
        (step_dir / "shard-00001.npz").unlink()
        with pytest.raises(ValueError, match="cover"):
            mgr.restore({"w": torch.zeros(8, 8)})
    elif case == "save-error":
        (tmp_path / "step-00000001").write_text("a file where the step dir must go")
        mgr.save(1, x, block=True)
        assert mgr.save_errors == 1 and emitter.marks("checkpoint_error")
        assert len(emitter.marks("checkpoint_end")) == len(emitter.marks("checkpoint_start"))
        assert mgr.latest_step() is None
        mgr.save(2, x, block=True)
        assert mgr.latest_step() == 2
    elif case == "snapshot-failure":
        mgr.save(1, {"bad": object()}, block=True)
        assert mgr.save_errors == 1 and emitter.marks("checkpoint_error")
        ends = emitter.marks("checkpoint_end")
        assert len(ends) == 1 and ends[0].get("failed") is True
    elif case in ("structure-mismatch", "shape-mismatch"):
        _, state = port_state()
        mgr.save(1, ttrain.state_tree(state), block=True)
        if case == "structure-mismatch":
            with pytest.raises(ValueError, match="structure mismatch"):
                mgr.restore({"just": torch.zeros(2)})
        else:
            other = ttrain.init_train_state(
                tget_config("test", d_ff=256, **PRESET), ttrain.make_optimizer(mu_dtype="bfloat16"),
                CPU)
            with pytest.raises(ValueError, match="shape"):
                mgr.restore(ttrain.state_tree(other))
    else:
        _, state = port_state()
        template = {k: tckpt.LeafSpec(tuple(v.shape), torch.float32)
                    for k, v in state.params.items()}
        if case == "subtree-suffix":
            # A params-only checkpoint: ".params['wq']" misses, the unique
            # suffix "['wq']" matches.
            mgr.save(3, {k: p.detach() for k, p in state.params.items()}, block=True)
        else:
            mgr.save(3, ttrain.state_tree(state), block=True)
        if case == "subtree-ambiguous":
            # .params['wq'] and the moments' ['wq'] all end in "['wq']".
            with pytest.raises(ValueError, match="ambiguous"):
                mgr.restore_subtree({"wq": template["wq"]})
            return
        restored, manifest = mgr.restore_subtree(template, prefix=".params")
        assert manifest["step"] == 3
        for k, p in state.params.items():
            assert torch.equal(restored[k], p.detach()), k


def test_hooks_save_on_cadence_crash_once_and_number_a_resumed_loop(tmp_path, monkeypatch,
                                                                    capsys):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=8)
    hook = ttrain.make_checkpoint_hook(mgr, every=2, total_steps=10,
                                       get_state=lambda: {"x": torch.arange(2.0)})
    for step in range(1, 7):
        hook(step, None)
    mgr.close()
    assert mgr.complete_steps() == [2, 4, 6] and mgr.read_manifest(4)["data_offset"] == 4
    monkeypatch.setenv("DSTACK_TPU_TRAIN_CRASH_AT_STEP", "3")
    crash = ttrain.make_checkpoint_hook(None, 0, 10, lambda: None, resumed=False)
    crash(2, None)
    with pytest.raises(SystemExit):
        crash(3, None)
    ttrain.make_checkpoint_hook(None, 0, 10, lambda: None, resumed=True)(3, None)
    seen = []
    ttrain._timed_loop(6, 2, 4, lambda: torch.tensor(0.5), start_step=4,
                       on_step=lambda s, _loss: seen.append(s))
    assert "step 5/6" in capsys.readouterr().out and seen == [5, 6]


def test_crash_and_resume_through_main_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """train.main with the training example's checkpoint flags: the first
    run exits at step 3 after the step-2 save, the same command resumes at
    step 2, and its losses at steps 3 and 4 are those of a run without
    checkpoints, bit for bit."""
    losses = {}
    inner = ttrain.train

    def recording(*args, **kwargs):
        return inner(*args, on_step=lambda step, loss: losses.__setitem__(step, loss), **kwargs)

    monkeypatch.setattr(ttrain, "train", recording)
    argv = ["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "4",
            "--mu-dtype", "bfloat16", "--quant", "fp8"]
    ckpt = ["--checkpoint-every", "2", "--checkpoint-dir", str(tmp_path), "--resume"]
    monkeypatch.setenv("DSTACK_TPU_TRAIN_CRASH_AT_STEP", "3")
    with pytest.raises(SystemExit):
        ttrain.main(argv + ckpt)
    assert sorted(losses) == [1, 2, 3]
    assert tckpt.CheckpointManager(str(tmp_path)).complete_steps() == [2]
    losses.clear()
    ttrain.main(argv + ckpt)
    resumed = dict(losses)
    assert sorted(resumed) == [3, 4]
    assert tckpt.CheckpointManager(str(tmp_path)).complete_steps() == [2, 4]
    monkeypatch.delenv("DSTACK_TPU_TRAIN_CRASH_AT_STEP")
    losses.clear()
    ttrain.main(argv)
    assert resumed == {3: losses[3], 4: losses[4]}
