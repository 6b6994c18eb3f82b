"""The port's autotune cache and tile menu against the JAX package's, on the
CPU.

``dstack_tpu_torch.workloads.kernels.autotune`` keeps the JAX module's cache
contract (tests/test_kernels.py ``TestAutotune``) with the port's
generations ("sm90" for an H100, "cpu"): the directory override, the
record/lookup round trip, the generation in the key, a corrupt file healed
by ``record``, malformed entries dropped, a stale entry that does not
divide ignored by ``flash_attention`` and ``splash_attention``, a tuned
entry picked up, and ``tune`` sweeping, persisting and reporting. A cache
file written by either package reads in the other. Explicit blocks on the
CPU hold the port to JAX's kernels in interpret mode at the same blocks
within 1e-5 (forward and gradients), and raise JAX's ValueError where they
do not divide. On CUDA the blocks must be a pair of ``flash.TILE_MENU``,
whose tiles every tensor-core body is built at (pure Python and the sources'
text here; ``chip_smoke.py`` phase 17 runs every pair on the card).
"""

import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads.kernels import autotune as jautotune
from dstack_tpu.workloads.kernels import flash as jflash
from dstack_tpu.workloads.kernels import splash as jsplash
from dstack_tpu_torch.workloads.kernels import autotune, flash, platform, splash

TOL = 1e-5
B, T, H, KH, D = 2, 128, 4, 2, 16
CSRC = Path(flash.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def isolated_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(autotune.ENV_DIR, str(tmp_path))
    monkeypatch.setattr(autotune, "_memo", None)
    monkeypatch.setattr(autotune, "_session", {})
    monkeypatch.setattr(jautotune, "_memo", None)
    yield


def qkv(seed, t=T, b=B, h=H, kh=KH):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, n, D).astype(np.float32) for n in (h, kh, kh)]


def torch_of(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def test_env_dir_override(tmp_path):
    assert autotune.cache_dir() == str(tmp_path)
    assert autotune.cache_path().startswith(str(tmp_path))


def test_record_lookup_roundtrip():
    assert autotune.record("flash", 128, 8192, (64, 32), gen="sm90")
    assert autotune.lookup("flash", 128, 8192, gen="sm90") == (64, 32)
    # Persisted, not just memoised: a cold reload sees the same entry.
    autotune._memo = None
    assert autotune.lookup("flash", 128, 8192, gen="sm90") == (64, 32)


def test_generation_is_part_of_the_key():
    autotune.record("flash", 32, 256, (64, 64), gen="sm90")
    assert autotune.lookup("flash", 32, 256, gen="cpu") is None
    assert autotune.lookup("flash", 32, 256, gen="v5p") is None
    # The port ships no entries: the JAX package's TPU defaults are not its.
    assert autotune.lookup("flash", 128, 4096, gen="v5p") is None
    assert platform.chip_generation("cpu") == "cpu"


def test_corrupt_cache_is_healed_by_record():
    os.makedirs(autotune.cache_dir(), exist_ok=True)
    with open(autotune.cache_path(), "w") as f:
        f.write("{not json")
    assert autotune.lookup("flash", 64, 2048, gen="sm90") is None
    assert autotune.record("splash", 64, 1024, (32, 32), gen="sm90")
    assert autotune.lookup("splash", 64, 1024, gen="sm90") == (32, 32)


def test_malformed_entries_are_dropped_not_fatal():
    os.makedirs(autotune.cache_dir(), exist_ok=True)
    with open(autotune.cache_path(), "w") as f:
        json.dump({
            "flash|cpu|16|128": [0, 64],
            "flash|cpu|16|64": "big",
            "splash|cpu|16|128": [32, 32, 32],
            "flash|cpu|32|256": [64, 64],
        }, f)
    assert autotune.lookup("flash", 16, 128, gen="cpu") is None
    assert autotune.lookup("flash", 16, 64, gen="cpu") is None
    assert autotune.lookup("splash", 16, 128, gen="cpu") is None
    assert autotune.lookup("flash", 32, 256, gen="cpu") == (64, 64)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's flash and splash (interpret mode on the CPU) and
    splash_reference on the module's inputs, once."""
    q, k, v = (jnp.asarray(a) for a in qkv(40))
    return dict(
        flash=np.asarray(jflash.flash_attention(q, k, v)),
        splash=np.asarray(jsplash.splash_reference(q, k, v, window=48)),
        flash_32=np.asarray(jflash.flash_attention(q, k, v, block_q=32, block_k=32)),
    )


def test_stale_nondividing_entry_is_ignored_by_the_kernels(jax_refs):
    autotune.record("flash", D, T, (96, 96), gen="cpu")
    autotune.record("splash", D, T, (96, 96), gen="cpu")
    q, k, v = torch_of(qkv(40))
    out = flash.flash_attention(q, k, v)
    assert flash.resolved_blocks["flash"] == (128, 128)  # the largest divisor
    np.testing.assert_allclose(out.numpy(), jax_refs["flash"], atol=TOL)
    out_s = splash.splash_attention(q, k, v, window=48)
    assert splash.resolved_blocks["splash"] == (128, 128)
    np.testing.assert_allclose(out_s.numpy(), jax_refs["splash"], atol=TOL)


def test_tuned_blocks_are_picked_up(jax_refs):
    autotune.record("flash", D, T, (32, 32), gen="cpu")
    q, k, v = torch_of(qkv(40))
    out = flash.flash_attention(q, k, v)
    assert flash.resolved_blocks["flash"] == (32, 32)
    np.testing.assert_allclose(out.numpy(), jax_refs["flash_32"], atol=TOL)


def test_tune_sweeps_persists_and_reports():
    q, k, v = torch_of(qkv(42, t=32, b=1, h=1, kh=1))
    report = autotune.tune("flash", q, k, v, gen="cpu", include_bwd=False, repeats=1)
    assert report["kernel"] == "flash" and report["gen"] == "cpu"
    assert (report["head_dim"], report["seq"]) == (D, 32)
    assert set(report["sweep"]) == {f"{a}x{b}" for a in (32, 16, 8) for b in (32, 16, 8)}
    assert autotune.lookup("flash", D, 32, gen="cpu") == tuple(report["blocks"])
    with open(autotune.cache_path()) as f:
        assert "flash|cpu|16|32" in json.load(f)


def test_a_pair_handed_to_a_rank_is_used_without_writing_the_cache():
    autotune.remember("splash", 128, 8192, (64, 32), gen="sm90")
    assert autotune.lookup("splash", 128, 8192, gen="sm90") == (64, 32)
    assert not os.path.exists(autotune.cache_path())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_file_reads_in_the_other_package(writer):
    mine, theirs = (jautotune, autotune) if writer == "jax" else (autotune, jautotune)
    assert mine.record("flash", 64, 2048, (64, 32), gen="sm90")
    assert mine.record("splash", 16, 128, (32, 32), gen="cpu")
    assert theirs.lookup("flash", 64, 2048, gen="sm90") == (64, 32)
    assert theirs.lookup("splash", 16, 128, gen="cpu") == (32, 32)
    assert theirs.lookup("flash", 64, 2048, gen="v4") is None


EXPLICIT = [("flash", (32, 32)), ("flash", (64, 16)), ("splash", (32, 64)),
            ("splash", (16, 32))]


@pytest.mark.parametrize("kernel,blocks", EXPLICIT, ids=lambda x: str(x))
def test_explicit_blocks_match_jax_interpret_mode(kernel, blocks):
    """Forward and the gradients of sum(o * r) at explicit blocks, the port
    on the CPU against JAX's kernels at the same blocks."""
    arrays = qkv(43)
    r = np.random.RandomState(44).randn(B, T, H, D).astype(np.float32)
    kw = dict(window=48) if kernel == "splash" else {}
    jfn = (jsplash.splash_attention if kernel == "splash" else jflash.flash_attention)
    tfn = (splash.splash_attention if kernel == "splash" else flash.flash_attention)
    bq, bk = blocks

    def jloss(q, k, v):
        return jnp.sum(jfn(q, k, v, block_q=bq, block_k=bk, **kw) * r)

    jout = jfn(*(jnp.asarray(a) for a in arrays), block_q=bq, block_k=bk, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    leaves = torch_of(arrays, grad=True)
    out = tfn(*leaves, block_q=bq, block_k=bk, **kw)
    (out * torch.from_numpy(r)).sum().backward()
    assert (flash.resolved_blocks if kernel == "flash" else splash.resolved_blocks)[kernel] \
        == blocks
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL)
    for leaf, g in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), atol=TOL)


@pytest.mark.parametrize("kernel", ["flash", "splash"])
def test_blocks_that_do_not_divide_raise_as_in_jax(kernel):
    arrays = qkv(45)
    jfn = jsplash.splash_attention if kernel == "splash" else jflash.flash_attention
    tfn = splash.splash_attention if kernel == "splash" else flash.flash_attention
    with pytest.raises(ValueError, match="block-divisible"):
        jfn(*(jnp.asarray(a) for a in arrays), block_q=48, block_k=64)
    with pytest.raises(ValueError, match=f"{kernel} attention needs block-divisible"):
        tfn(*torch_of(arrays), block_q=48, block_k=64)


def test_on_cuda_blocks_come_from_the_menu(monkeypatch):
    """resolve_blocks for a CUDA computation (no card is touched): the
    default pair without an entry, a cached menu pair, a cached pair off the
    menu ignored, and explicit blocks off the menu refused."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(autotune, "generation_of", lambda device: "sm90")
    assert flash.resolve_blocks("flash", 8192, 8192, 128, cuda) == flash.DEFAULT_BLOCKS
    autotune.record("splash", 128, 8192, (32, 32), gen="sm90")
    assert flash.resolve_blocks("splash", 8192, 8192, 128, cuda) == (32, 32)
    autotune.record("flash", 128, 8192, (512, 512), gen="sm90")
    assert flash.resolve_blocks("flash", 8192, 8192, 128, cuda) == flash.DEFAULT_BLOCKS
    assert flash.resolve_blocks("flash", 100, 100, 128, cuda, 128, 64) == (128, 64)
    with pytest.raises(ValueError, match=r"not on the tile menu \[\(32, 32\)"):
        flash.resolve_blocks("flash", 8192, 8192, 128, cuda, 48, 48)


def test_the_default_pair_runs_todays_tiles():
    assert flash.TILE_MENU[flash.DEFAULT_BLOCKS] == flash.Tiles(
        fwd=(64, 64), dq=(64, 32), dkv=(32, 64))
    # At least one other pair changes a real tile of the forward and of dq.
    others = [t for p, t in flash.TILE_MENU.items() if p != flash.DEFAULT_BLOCKS]
    assert any(t.fwd != (64, 64) for t in others) and any(t.dq == (64, 64) for t in others)


def _padded(cols):
    return cols + 8


def _built_edges(source: str, args: str) -> tuple:
    """The tile edges ``by_tile`` instantiates in ``args``' tensor-core
    launch of ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    body = text[text.index(f"struct {args} {{"):]
    body = body[:body.index("\n};\n")]
    return tuple(int(x) for x in re.search(r"by_tile<([\d, ]+)>", body).group(1).split(","))


def test_every_pair_maps_to_tiles_each_body_takes():
    """Forward and dq blocks own 64 q rows and dk/dv blocks 64 keys (4 warps
    of 16); the other edge is one that both sources build the kernel at
    (their ``by_tile`` lists; the library refuses any other edge); each
    tile's shared memory fits a block at D 128 with documents; and a pair
    off the menu is refused before any launch."""
    edges = {}
    for args in ("FwdArgs", "DqArgs", "DkvArgs"):
        built = {_built_edges(src, args) for src in ("flash_attention.cu", "splash_attention.cu")}
        assert len(built) == 1, (args, built)
        edges[args] = built.pop()
    smem_limit = 232448
    for pair, tiles in flash.TILE_MENU.items():
        assert flash.menu_tiles(pair) == tiles
        assert tiles.fwd[0] == 64 and tiles.fwd[1] in edges["FwdArgs"], pair
        assert tiles.dq[0] == 64 and tiles.dq[1] in edges["DqArgs"], pair
        assert tiles.dkv[1] == 64 and tiles.dkv[0] in edges["DkvArgs"], pair
        for d in (32, 64, 128):
            ld = _padded(d)
            fwd = (64 + 2 * 2 * tiles.fwd[1]) * ld * 2 + 2 * tiles.fwd[1] * 4
            dq = ((1 + 3) * 64 + 2 * 2 * tiles.dq[1]) * ld * 2 + 2 * tiles.dq[1] * 4
            rows = tiles.dkv[0]
            dkv = (2 * 64 + 2 * rows + 3 * rows) * ld * 2 + rows * d * 4 + 16 * rows + 8 * rows
            assert max(fwd, dq, dkv) <= smem_limit, (pair, d)
            assert rows * d % 512 == 0  # dk/dv splits do in whole float4 steps
    with pytest.raises(ValueError, match=r"\(48, 48\) are not on the tile menu"):
        flash.menu_tiles((48, 48))
