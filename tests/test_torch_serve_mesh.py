"""The port's tp-sharded serving engine against the JAX package's, on the CPU.

The serve mesh's layout first, in one process: ``serve_param_specs`` (fp,
int8, fp8), ``SERVE_PAGE_SPEC`` and the axes equal JAX's entry by entry;
``local_slices`` cuts every serve leaf at every rank of dd2 x tp2 and tp4
as ``NamedSharding.devices_indices_map`` does at the same device;
``describe`` is the JAX engine's ``mesh_desc``; ``parse_mesh_arg``,
``make_serve_mesh`` and ``validate_serve_mesh`` raise JAX's errors; each
rank's piece of the synthetic init is the meshless tree's; and at each rank
of a described tp4 mesh, ``load_serve_params(mesh=...)`` of a JAX dp2 x
fsdp4 TrainState checkpoint is bit-equal to the matching slice of JAX's tp4
restore.

Then one gloo world of 4 processes (``tests/torch_mesh_worker.py``, spawned
once for the file) runs the engines, while this process computes JAX's in
fp32 on its 8 virtual CPU devices: on dd2 x tp2 (TINY, as
``tests/test_serve_sharded.py``) the streams of the tier-1 / prefix /
spec / prefix+spec matrix, of the preemption geometry and of int8 equal
JAX's meshless and tp2 engines' and the port's meshless engine's, and the
ranks hold 1/tp of wq and of the KV pools; on tp4, the restore of the JAX
checkpoint (none and int8: the row-parallel scales are the whole weight's,
taken as the max over the tp group) is bit-equal to JAX's tp4 restore and
serves JAX's tokens; and the draft-head engine on dd2 x tp2 gives the
port's meshless draft engine's streams. ``StepSync`` carries rank 0's step
message to every rank, and a token that differs on one rank raises on all.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import serve as jserve
from dstack_tpu.workloads import sharding as jsharding
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy
from tests.torch_mesh_worker import start_world

CPU = torch.device("cpu")
TINY_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=251,
               max_seq_len=128, dtype="float32", param_dtype="float32", remat=False)
# tp4 needs n_kv_heads divisible by 4 (tests/test_serve_sharded.py's RESTORE_CFG).
RESTORE_KW = dict(TINY_KW, n_kv_heads=4, max_seq_len=32)
JTINY, TTINY = jget_config("test", **TINY_KW), tget_config("test", **TINY_KW)
JRESTORE, TRESTORE = jget_config("test", **RESTORE_KW), tget_config("test", **RESTORE_KW)

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16]]
SHARED_PREFIX = [5, 9, 13, 2, 44, 17, 81, 3, 7, 7, 101, 55, 13, 24, 9, 16, 31, 8]
MATRIX_PROMPTS = PROMPTS + [SHARED_PREFIX + [40 + i] for i in range(3)]
PREEMPT_POOL = dict(page_size=4, num_pages=7, max_batch=3, max_seq=96)
PREEMPT_PROMPTS = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in (0, 10, 20)]
BASE = dict(page_size=8, num_pages=32, max_batch=4, max_seq=128)
# tests/test_serve_sharded.py's cases: name -> (engine overrides, waves, max_new).
CASES = {
    "tier1": (dict(prefill_chunk=4), [MATRIX_PROMPTS], 8),
    "prefix": (dict(prefill_chunk=4, prefix_cache=True), [MATRIX_PROMPTS], 8),
    "spec": (dict(prefill_chunk=4, spec_tokens=2), [MATRIX_PROMPTS], 8),
    "prefix+spec": (dict(prefill_chunk=4, prefix_cache=True, spec_tokens=2),
                    [MATRIX_PROMPTS], 8),
    "preemption": (dict(prefill_chunk=4, prefix_cache=True, **PREEMPT_POOL),
                   [PREEMPT_PROMPTS], 20),
    "int8": (dict(quant="int8"), [PROMPTS], 6),
}
# tests/test_torch_draft.py's draft-head cases.
DRAFT_BASE = dict(BASE, spec_tokens=3, spec_fallback_threshold=0.0)
DRAFT_CASES = {
    "continuous": ({}, [PROMPTS], 16),
    "preemption": (PREEMPT_POOL, [PREEMPT_PROMPTS], 20),
    "chunked-prefix-cache": (dict(prefix_cache=True, prefill_chunk=4),
                             [[SHARED_PREFIX + [50]], [SHARED_PREFIX + [60], SHARED_PREFIX + [61]]],
                             6),
    "int8": (dict(quant="int8"), [PROMPTS], 6),
}
RESTORE_BASE = dict(page_size=8, num_pages=16, max_batch=2, max_seq=32)
STEP_MESSAGE = {"stop": False, "requests": [("http-1", [1, 2, 3], 4, None)]}
WORLD = 4


def np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def jax_streams(cfg, params, ecfg, waves, max_new, mesh=None):
    engine = jserve.ServeEngine(cfg, jserve.EngineConfig(**ecfg), params=params, mesh=mesh)
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, max_new_tokens=max_new) for p in wave]
        while engine.has_work():
            engine.step()
    return [r.tokens for r in reqs]


def port_streams(cfg, params, ecfg, waves, max_new, draft=None):
    engine = tserve.ServeEngine(cfg, tserve.EngineConfig(**ecfg),
                                params=params_from_numpy(params, CPU, torch.float32),
                                device=CPU,
                                draft_params=params_from_numpy(draft, CPU, torch.float32)
                                if draft else None)
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, max_new_tokens=max_new) for p in wave]
        while engine.has_work():
            engine.step()
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX TrainState saved on dp2 x fsdp4 (test_serve_sharded.py's), and
    JAX's tp4 restore of it, fp and int8 (whole arrays)."""
    ckpt_dir = tmp_path_factory.mktemp("serve-mesh-ckpt")
    mesh = jsharding.make_mesh(dp=2, fsdp=4, devices=jax.devices()[:8])
    state = jtrain.init_train_state(JRESTORE, jax.random.PRNGKey(0), jtrain.make_optimizer(), mesh)
    JaxManager(str(ckpt_dir), process_index=0, process_count=1).save(
        3, state, mesh_shape=dict(mesh.shape), block=True)
    serve_mesh = jsharding.make_serve_mesh(4, devices=jax.devices()[:4])
    restored = {}
    for quant in ("none", "int8"):
        params, _ = jserve.load_serve_params(str(ckpt_dir), JRESTORE, mesh=serve_mesh, quant=quant)
        restored[quant] = np_tree(params)
    return dict(dir=str(ckpt_dir), restored=restored, serve_mesh=serve_mesh,
                train_mesh=dict(mesh.shape))


@pytest.fixture(scope="module")
def runs(checkpoint):
    """The port's world of 4 over every case, and JAX's and the port's
    meshless references, computed while the world runs."""
    jparams = jmodel.init_params(JTINY, jax.random.PRNGKey(0))
    params = np_tree(jparams)
    draft = np_tree(jax.jit(jmodel.init_draft_params, static_argnums=0)(
        JTINY, jax.random.PRNGKey(7)))
    jobs = [
        ("serve_streams", dict(mesh=dict(tp=2), cfg_kw=TINY_KW, params=params, base=BASE,
                               cases=CASES)),
        ("serve_restore", dict(cfg_kw=RESTORE_KW, ckpt_dir=checkpoint["dir"],
                               quants=["none", "int8"], base=RESTORE_BASE,
                               prompts=PROMPTS[:2], max_new=4)),
        ("serve_streams", dict(mesh=dict(tp=2), cfg_kw=TINY_KW, params=params, base=DRAFT_BASE,
                               cases=DRAFT_CASES, draft=draft)),
        ("step_sync", dict(message=STEP_MESSAGE)),
    ]
    import tempfile
    from pathlib import Path

    port = start_world(jobs, WORLD, Path(tempfile.mkdtemp(prefix="serve-mesh-world-")))
    tp2 = jsharding.make_serve_mesh(2, devices=jax.devices()[:2])
    ref = {}
    for name, (over, waves, max_new) in CASES.items():
        ecfg = {**BASE, **over}
        ref[name] = dict(
            jax=jax_streams(JTINY, jparams, ecfg, waves, max_new),
            jax_tp2=jax_streams(JTINY, jparams, ecfg, waves, max_new, mesh=tp2),
            port=port_streams(TTINY, params, ecfg, waves, max_new))
    restored = checkpoint["restored"]["none"]
    ref["restore"] = jax_streams(JRESTORE, {k: jax.numpy.asarray(v) for k, v in restored.items()},
                                 RESTORE_BASE, [PROMPTS[:2]], 4, mesh=checkpoint["serve_mesh"])
    ref["draft"] = {name: port_streams(TTINY, params, {**DRAFT_BASE, **over}, waves, max_new,
                                       draft=draft)
                    for name, (over, waves, max_new) in DRAFT_CASES.items()}
    return dict(ref=ref, port=port())


# -- the layout, in this process ------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_serve_param_specs_match_jax(quant):
    got, want = sharding.serve_param_specs(quant), jsharding.serve_param_specs(quant)
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert got[key] == tuple(spec), key


def test_page_spec_and_axes_match_jax():
    assert sharding.SERVE_PAGE_SPEC == tuple(jsharding.SERVE_PAGE_SPEC)
    assert sharding.SERVE_MESH_AXES == jsharding.SERVE_MESH_AXES
    assert sharding.SERVE_PARAM_SPECS == {k: tuple(v) for k, v in
                                          jsharding.SERVE_PARAM_SPECS.items()}


@pytest.mark.parametrize("spec", ["tp2", "tp4", "dd4xtp1"])
def test_local_slices_cut_serve_leaves_as_jax(spec):
    """Every leaf of the fp and the quantized layout (and the KV pool) at
    every rank: the port's piece is JAX's shard at the same device."""
    mesh = tserve.parse_mesh_arg(spec, world=WORLD)
    devices = jax.devices()[:WORLD]
    jmesh = jsharding.make_serve_mesh(mesh.shape["tp"], devices=devices)
    assert dict(jmesh.shape) == mesh.shape
    shapes = tmodel.param_shapes(TRESTORE)
    leaves = {k: (shapes[k], sharding.SERVE_PARAM_SPECS[k], jsharding.SERVE_PARAM_SPECS[k])
              for k in shapes}
    qspecs, jqspecs = sharding.serve_param_specs("int8"), jsharding.serve_param_specs("int8")
    for k in qspecs:
        if k.endswith(("_q", "_s")):
            shape = list(shapes[k[:-2]])
            if k.endswith("_s"):
                shape[-2] = 1
            leaves[k] = (tuple(shape), qspecs[k], jqspecs[k])
    leaves["pages"] = ((2, 16, 8, 4, 16), sharding.SERVE_PAGE_SPEC, jsharding.SERVE_PAGE_SPEC)
    for key, (shape, tspec, jspec) in leaves.items():
        index_map = NamedSharding(jmesh, jspec).devices_indices_map(shape)
        for rank, device in enumerate(devices):
            want = tuple(slice(sl.start or 0, sl.stop if sl.stop is not None else n)
                         for sl, n in zip(index_map[device], shape))
            assert sharding.local_slices(tspec, shape, mesh, rank) == want, (key, rank)


@pytest.mark.parametrize("spec,world", [("tp1", 1), ("tp2", 4), ("dd2xtp2", 4), ("tp4", 4)])
def test_mesh_desc_is_the_jax_engines(spec, world):
    mesh = tserve.parse_mesh_arg(spec, world=world)
    jmesh = jsharding.make_serve_mesh(mesh.shape["tp"], mesh.shape["dd"],
                                      devices=jax.devices()[:world])
    assert mesh.describe() == jserve.ServeEngine.mesh_desc.fget(types.SimpleNamespace(mesh=jmesh))
    assert tserve.parse_mesh_arg("") is None and tserve.parse_mesh_arg("none") is None


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["bad-spec", "tp3-of-8", "dd3xtp2-of-8", "tp4-kv-heads",
                                  "training-mesh"])
def test_mesh_errors_are_jaxs(case):
    devices = jax.devices()[:4]
    port, jax_ = {
        "bad-spec": (lambda: tserve.parse_mesh_arg("tp2x", world=8),
                     lambda: jserve.parse_mesh_arg("tp2x")),
        "tp3-of-8": (lambda: tserve.parse_mesh_arg("tp3", world=8),
                     lambda: jserve.parse_mesh_arg("tp3")),
        "dd3xtp2-of-8": (lambda: tserve.parse_mesh_arg("dd3xtp2", world=8),
                         lambda: jserve.parse_mesh_arg("dd3xtp2")),
        "tp4-kv-heads": (lambda: sharding.validate_serve_mesh(
                             TTINY, sharding.make_serve_mesh(4, world=4)),
                         lambda: jsharding.validate_serve_mesh(
                             JTINY, jsharding.make_serve_mesh(4, devices=devices))),
        "training-mesh": (lambda: sharding.validate_serve_mesh(
                              TTINY, sharding.make_mesh(tp=2, world=4)),
                          lambda: jsharding.validate_serve_mesh(
                              JTINY, jsharding.make_mesh(tp=2, devices=devices))),
    }[case]
    assert _error(port) == _error(jax_)


@pytest.mark.parametrize("spec", ["tp4", "dd2xtp2"])
def test_sharded_synthetic_init_reassembles_the_meshless_tree(spec):
    """Each rank draws the meshless numbers leaf by leaf and keeps its piece
    of the serve layout: the pieces are the meshless tree's, bit for bit."""
    whole = tmodel.init_params(TRESTORE, torch.Generator().manual_seed(0), CPU)
    mesh = tserve.parse_mesh_arg(spec, world=WORLD)
    for rank in range(WORLD):
        mesh.rank = rank
        local = tmodel.init_params(TRESTORE, torch.Generator().manual_seed(0), CPU, mesh=mesh)
        for key, piece in local.items():
            where = sharding.local_slices(sharding.SERVE_PARAM_SPECS[key], whole[key].shape,
                                          mesh, rank)
            assert torch.equal(piece, whole[key][where]), (key, rank)


@pytest.mark.parametrize("rank", range(WORLD))
def test_restore_onto_a_described_tp4_mesh_is_jaxs_tp4_restore(rank, checkpoint):
    """A rank's ``load_serve_params(mesh=...)`` of the dp2 x fsdp4 TrainState
    reads its pieces only, each the slice of JAX's tp4 restore at its
    coordinate (wq's last axis a quarter). The int8 layout, whose
    row-parallel scales take a max over the tp group, is checked in the
    world below."""
    mesh = sharding.make_serve_mesh(4, world=WORLD)
    mesh.rank = rank
    params, manifest = tserve.load_serve_params(checkpoint["dir"], TRESTORE, mesh=mesh,
                                                device="cpu")
    assert manifest["mesh"] == checkpoint["train_mesh"]
    want = checkpoint["restored"]["none"]
    assert sorted(params) == sorted(want)
    assert params["wq"].shape[-1] == want["wq"].shape[-1] // 4
    for key, piece in params.items():
        where = sharding.local_slices(sharding.SERVE_PARAM_SPECS[key], want[key].shape, mesh)
        np.testing.assert_array_equal(piece.numpy(), want[key][where], err_msg=key)


# -- the engines, in the world ---------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_dd2_tp2_streams_match_jax_meshless_and_tp2(name, runs):
    ref = runs["ref"][name]
    assert ref["jax"] == ref["jax_tp2"] == ref["port"]
    for rank, got in enumerate(runs["port"]):
        assert got[0][name]["streams"] == ref["jax"], f"rank {rank}"
        assert got[0][name]["stats"]["mesh"] == "dd2xtp2"
    if name == "preemption":
        assert runs["port"][0][0][name]["stats"]["preemptions"] >= 1, "the pool forced none"


def test_weights_and_pages_actually_sharded(runs):
    """Each rank holds 1/tp of wq and of the KV pools' heads, and the whole
    embed; the int8 layout splits wq_q the same way and keeps the
    row-parallel scales whole."""
    coords = set()
    for got in runs["port"]:
        run = got[0]
        coords.add(tuple(run["coords"].values()))
        shapes = run["tier1"]["shapes"]
        assert shapes["wq"] == (2, 64, 64 // 2)
        assert shapes["wo"] == (2, 64 // 2, 64)
        assert shapes["lm_head"] == (64 // 2, 251)
        assert shapes["embed"] == (251, 64)
        assert run["tier1"]["pool"] == (2, 32, 8, 1, 16)
        q = run["int8"]["shapes"]
        assert q["wq_q"] == (2, 64, 32) and q["wo_s"] == (2, 1, 64) and q["wq_s"] == (2, 1, 32)
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp4_restore_is_jaxs_tp4_restore(quant, runs, checkpoint):
    """Each rank's restored (and int8-quantized) pieces are bit-equal to the
    slices of JAX's tp4 restore; under int8 that holds the row-parallel
    scales (wo_s, w_down_s, lm_head_s) to the whole weight's, the same on
    every rank."""
    want = checkpoint["restored"][quant]
    mesh = sharding.make_serve_mesh(4, world=WORLD)
    specs = sharding.serve_param_specs(quant)
    for rank, got in enumerate(runs["port"]):
        pieces = got[1][quant]
        assert got[1]["mesh"] == checkpoint["train_mesh"]
        assert sorted(pieces) == sorted(want)
        for key, piece in pieces.items():
            where = sharding.local_slices(specs[key], want[key].shape, mesh, rank)
            whole = want[key] if want[key].dtype.isbuiltin == 1 else want[key].view(np.uint8)
            np.testing.assert_array_equal(piece.view(whole.dtype) if piece.dtype != whole.dtype
                                          else piece, whole[where], err_msg=f"rank {rank} {key}")
        if quant == "int8":
            for key in ("wo_s", "w_down_s", "lm_head_s"):
                np.testing.assert_array_equal(pieces[key], want[key], err_msg=key)


def test_tp4_restored_engine_serves_jaxs_tokens(runs):
    for rank, got in enumerate(runs["port"]):
        assert got[1]["streams"] == runs["ref"]["restore"], f"rank {rank}"


@pytest.mark.parametrize("name", list(DRAFT_CASES))
def test_draft_head_engine_on_tp2_matches_the_meshless_draft_engine(name, runs):
    want = runs["ref"]["draft"][name]
    for rank, got in enumerate(runs["port"]):
        run = got[2][name]
        assert run["streams"] == want, f"rank {rank}"
        assert run["stats"]["spec_proposer"] == "draft" and run["stats"]["mesh"] == "dd2xtp2"


def test_step_messages_reach_every_rank_and_a_disagreement_raises_on_all(runs):
    """Rank 0's step message arrives whole on every rank; tokens that agree
    pass ``StepSync.check``, and a token that differs on one rank raises on
    every rank, so no rank waits in a collective the others left."""
    for rank, got in enumerate(runs["port"]):
        assert got[3]["message"] == STEP_MESSAGE, f"rank {rank}"
        assert got[3]["raised"] == [False, True], f"rank {rank}"
