"""The port's training mesh layout against the JAX package's, on the CPU.

No processes: a ``sharding.Mesh`` is a description until it connects. Each
rank's piece of every parameter (``local_slices``) equals what JAX's
``NamedSharding.devices_indices_map`` gives the device at the same mesh
coordinate, on meshes (1,2,2,1), (2,2,1,1), (1,4,1,1) over 4 of JAX's CPU
devices and in the multislice order (ranks slice-major, as JAX sorts
devices by ``slice_index``). Also: a rank's rows of a batch under
grad_accum (``data.rank_rows``) against JAX's [A, B/A, T] layout, the
sharded init against the meshless one, the mesh checks of
``validate_config`` against JAX's, and the layout helpers the grad norm and
the checkpoints use.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import sharding as jsharding
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu.workloads.config import validate_config as jvalidate
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads import data as tdata
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import sharding
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.config import validate_config as tvalidate

MESHES = [dict(dp=1, fsdp=2, tp=2, sp=1), dict(dp=2, fsdp=2, tp=1, sp=1),
          dict(dp=1, fsdp=4, tp=1, sp=1)]
IDS = ["fsdp2-tp2", "dp2-fsdp2", "fsdp4"]


def shapes():
    cfg = jget_config("test")
    return {k: v.shape for k, v in jax.eval_shape(lambda key: jmodel.init_params(cfg, key),
                                                   jax.random.PRNGKey(0)).items()}


def jax_index(spec, shape, jmesh, device):
    """JAX's index of ``device``'s piece, with whole dims as 0:n slices."""
    index = NamedSharding(jmesh, spec).devices_indices_map(shape)[device]
    return tuple(slice(sl.start or 0, n if sl.stop is None else sl.stop)
                 for sl, n in zip(index, shape))


def assert_same_pieces(mesh, jmesh, devices):
    """Every rank r's piece of every leaf is the piece of ``devices[r]``."""
    for key, shape in shapes().items():
        for rank, device in enumerate(devices):
            got = sharding.local_slices(sharding.PARAM_SPECS[key], shape, mesh, rank)
            assert got == jax_index(jsharding.PARAM_SPECS[key], shape, jmesh, device), (key, rank)


@pytest.mark.parametrize("axes", MESHES, ids=IDS)
def test_local_pieces_are_jaxs(axes):
    devices = jax.devices()[:4]
    assert_same_pieces(sharding.make_mesh(**axes, world=4),
                       jsharding.make_mesh(**axes, devices=devices), devices)


def test_the_multislice_order_is_jaxs(monkeypatch):
    """Four ranks on two slices, given out of slice order: the port's mesh
    and JAX's (its devices carrying those slice indices) order them alike,
    and each rank's pieces are its device's."""

    class FakeDevice:
        def __init__(self, i, slice_index):
            self.id, self.slice_index = i, slice_index

    slice_ids = [1, 0, 1, 0]
    seen = {}
    monkeypatch.setattr(jsharding, "make_mesh", lambda **kw: seen.update(kw))
    jsharding.make_multislice_mesh(2, tp=2, devices=[FakeDevice(i, s)
                                                     for i, s in enumerate(slice_ids)])
    monkeypatch.undo()
    order = [d.id for d in seen["devices"]]
    mesh = sharding.make_multislice_mesh(2, slice_ids, tp=2)
    assert mesh.shape == dict(dp=2, fsdp=1, tp=2, sp=1) and seen["dp"] == 2
    assert mesh.ranks.ravel().tolist() == order == [1, 3, 0, 2]
    devices = jax.devices()[:4]
    jmesh = jsharding.make_mesh(dp=2, tp=2, devices=[devices[i] for i in order])
    assert_same_pieces(mesh, jmesh, devices)


@pytest.mark.parametrize("axes", MESHES, ids=IDS)
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_rank_rows_are_jaxs_microbatch_layout(axes, grad_accum):
    """[A, B/A, T] with dim 1 over the data axes (JAX's accumulate_grads):
    the rows of each rank's microbatches, in its local order."""
    b = 8
    mb = b // grad_accum
    devices = jax.devices()[:4]
    jmesh = jsharding.make_mesh(**axes, devices=devices)
    mesh = sharding.make_mesh(**axes, world=4)
    index_map = NamedSharding(jmesh, P(None, ("dp", "fsdp"))).devices_indices_map((grad_accum, mb))
    data = mesh.axis_size(sharding.DATA_AXES)
    for rank, device in enumerate(devices):
        _, cols = index_map[device]
        want = (np.arange(grad_accum)[:, None] * mb + np.arange(mb)[None, cols]).ravel()
        got = tdata.rank_rows(b, grad_accum, mesh.index(sharding.DATA_AXES, rank), data)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axes", MESHES[:1], ids=IDS[:1])
def test_the_sharded_init_is_the_meshless_init_cut(axes):
    """Each rank's pieces of the sharded init, put together, are the
    meshless init of the same generator, bit for bit."""
    cfg = tget_config("test", n_layers=2)
    cpu = torch.device("cpu")
    whole = tmodel.init_params(cfg, torch.Generator().manual_seed(0), cpu)
    mesh = sharding.make_mesh(**axes, world=4)
    for rank in range(4):
        mesh.rank = rank
        local = tmodel.init_params(cfg, torch.Generator().manual_seed(0), cpu, mesh=mesh)
        for key, piece in local.items():
            want = whole[key][sharding.local_slices(sharding.PARAM_SPECS[key], whole[key].shape,
                                                    mesh, rank)]
            assert torch.equal(piece, want), (key, rank)


def test_layout_helpers():
    mesh = sharding.make_mesh(fsdp=2, tp=2, world=4)
    spec = sharding.PARAM_SPECS["wo"]
    assert sharding.global_shape(spec, (4, 128, 128), mesh) == (4, 256, 256)
    assert sharding.spec_of_key(".opt_state[1][0].mu['w_down']") == sharding.PARAM_SPECS["w_down"]
    assert sharding.spec_of_key(".step") == ()
    assert sharding.spec_of_key(".opt_state[1][0].count") == ()
    # A norm is whole on every rank and counted on rank 0 only; a wq piece
    # is every rank's own.
    assert [sharding.holds_first_copy(sharding.PARAM_SPECS["attn_norm"], mesh, r)
            for r in range(4)] == [True, False, False, False]
    assert all(sharding.holds_first_copy(sharding.PARAM_SPECS["wq"], mesh, r) for r in range(4))
    assert sharding.pad_to_multiple(1000, 128) == jsharding.pad_to_multiple(1000, 128) == 1024
    with pytest.raises(ValueError, match="equal shards"):
        sharding.local_slices(("tp",), (5,), mesh, 0)


CHECKS = [
    ("flash_tpu under a mesh", dict(attn_impl="flash_tpu"), dict(fsdp=4), 64, 8),
    ("flash with sp > 1", dict(attn_impl="flash"), dict(fsdp=2, sp=2), 64, 8),
    ("n_kv_heads % tp", dict(attn_impl="splash", n_kv_heads=2, n_heads=8), dict(tp=4), 64, 8),
    ("fsdp_overlap, d_model indivisible", dict(fsdp_overlap=True, d_model=258), dict(fsdp=4),
     64, 8),
    ("fsdp_overlap on one data rank", dict(fsdp_overlap=True), dict(fsdp=1, tp=4), 64, 8),
    ("tp_overlap, rows indivisible", dict(tp_overlap=True), dict(fsdp=2, tp=2), 3, 1),
]


@pytest.mark.parametrize("case", CHECKS, ids=[c[0] for c in CHECKS])
def test_validate_config_refuses_what_jax_refuses(case):
    _, kw, axes, seq, batch = case
    with pytest.raises(ValueError) as jerr:
        jvalidate(jget_config("test", **kw),
                  jsharding.make_mesh(**axes, devices=jax.devices()[:4]), batch=batch, seq=seq)
    with pytest.raises(ValueError) as terr:
        tvalidate(tget_config("test", **kw), seq=seq, mesh=sharding.make_mesh(**axes, world=4),
                  batch=batch)
    assert str(terr.value) == str(jerr.value)


def test_validate_config_takes_the_examples_mesh_and_refuses_uneven_shards():
    cfg = tget_config("test", attn_impl="splash", attn_window=16, tp_overlap=True,
                      fsdp_overlap=True, quant="fp8")
    tvalidate(cfg, seq=64, device="cpu", mesh=sharding.make_mesh(fsdp=2, tp=2, world=4), batch=4)
    with pytest.raises(ValueError, match="whole heads"):
        tvalidate(tget_config("test", d_ff=690), seq=64, mesh=sharding.make_mesh(tp=4, world=4))
    # A blockwise sp mesh, once refused naming ROADMAP item 6, validates;
    # its sequence must split into whole chunks.
    tvalidate(tget_config("test"), seq=64, mesh=sharding.make_mesh(fsdp=2, sp=2, world=4))
    with pytest.raises(ValueError, match="seq=63 does not split into sp=2"):
        tvalidate(tget_config("test"), seq=63, mesh=sharding.make_mesh(fsdp=2, sp=2, world=4))


def test_moe_under_sp_still_raises_naming_item_14():
    """MoE under sp validates (the name is the one this test had while the
    port refused it, naming ROADMAP item 14); its sequence must split into
    whole chunks, and the mesh into the reference's sizes."""
    from dstack_tpu_torch.workloads.moe import MOE_PRESETS

    tvalidate(MOE_PRESETS["moe_test"], seq=64, mesh=sharding.make_moe_mesh(ep=2, sp=2, world=4))
    with pytest.raises(ValueError, match="seq=63 does not split into sp=2"):
        tvalidate(MOE_PRESETS["moe_test"], seq=63,
                  mesh=sharding.make_moe_mesh(ep=2, sp=2, world=4))
    with pytest.raises(ValueError, match="not divisible by dp\\*fsdp\\*tp\\*sp=3"):
        sharding.make_moe_mesh(sp=3, world=4)
    # MoE under tp validates (its dims split over tp).
    tvalidate(MOE_PRESETS["moe_test"], seq=64, mesh=sharding.make_moe_mesh(ep=2, tp=2, world=4))


def test_attention_under_a_sequence_parallel_mesh_is_not_ported(monkeypatch):
    """Ported since (the name is the one this test had while sp was
    refused): under a mesh with sp > 1, attention_core runs ring attention
    on the rank's chunk, whatever attn_impl says, as the reference's
    dispatch does (tests/test_torch_ring.py holds it against JAX)."""
    calls = []
    monkeypatch.setattr(tattn, "ring_attention",
                        lambda q, k, v, mesh, causal: calls.append((mesh.shape, causal)) or q)
    q = torch.zeros((1, 16, 2, 8))
    for impl in ("blockwise", "flash", "splash"):
        assert tattn.attention_core(q, q, q, impl, sharding.make_mesh(sp=2, world=2)) is q
    assert calls == [(dict(dp=1, fsdp=1, tp=1, sp=2), True)] * 3


@pytest.mark.parametrize("argv,error", [
    (["--tp-overlap"], "--tp-overlap needs a tensor-parallel mesh axis"),
    (["--fsdp-overlap"], "fsdp_overlap rotates weight shards"),
    (["--tp", "2"], "1 ranks not divisible by dp\\*tp\\*sp=2"),
], ids=["tp-overlap", "fsdp-overlap", "tp2"])
def test_a_lone_process_is_jaxs_one_device_mesh(argv, error, monkeypatch):
    """Without torchrun's environment, train.main checks the one-rank mesh
    as JAX checks its one-device mesh, and refuses what cannot run there."""
    from dstack_tpu_torch.workloads import train as ttrain

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=error):
        ttrain.main(["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "1", *argv])


def test_multislice_without_slices_runs_meshless(monkeypatch):
    """--multislice with one slice (MEGASCALE_NUM_SLICES unset) is the plain
    mesh, as JAX's; on one process it trains."""
    from dstack_tpu_torch.workloads import train as ttrain

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    stats = ttrain.main(["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "2",
                         "--multislice"])
    assert stats["tokens_per_sec"] > 0
