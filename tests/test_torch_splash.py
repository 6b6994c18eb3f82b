"""The port's splash attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks:

- the plain versions of the three CUDA kernels (``kernels/splash.py``)
  against the Pallas kernels run in interpret mode at block 16, as
  tests/test_kernels.py runs them: causal, causal with a window of 24
  (n_rep = 4), a window of 48 with three packed documents, and full
  attention with documents. Forward o and lse, then dq, dk, dv on the Pallas
  forward's o and lse. fp32 on both sides, so only the summation order
  differs: atol 1e-5;
- gradients of sum(sin(splash_attention(...))) through the port's autograd
  function against jax.grad of the JAX kernel, atol 1e-4 (the tolerance of
  TestSplashKernel);
- rows that see no key, the dispatch through ``attention_core``, the
  config check, the wrappers' CPU path and launch counters, and the build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import attention as jattn
from dstack_tpu.workloads.kernels import splash as jsplash
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads.config import get_config, validate_config
from dstack_tpu_torch.workloads.kernels import build, flash, splash

TOL = 1e-5
GRAD_TOL = 1e-4
BLOCK = 16  # the Pallas kernels' block here: T = 128 walks 8 blocks

# name -> (t, h, kh, d, causal, window, doc lengths or None)
CASES = {
    "causal": (64, 4, 2, 16, True, 0, None),
    "window24-n_rep4": (128, 8, 2, 16, True, 24, None),
    "window48-docs": (128, 4, 2, 16, True, 48, (40, 56, 32)),
    "full-docs": (64, 4, 2, 16, False, 0, (20, 30, 14)),
}


def t(a):
    return torch.from_numpy(np.array(a))


def qkv(seed, t_len=64, h=4, kh=2, d=16, b=2):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, t_len, n, d).astype(np.float32) for n in (h, kh, kh))


def doc_ids(lengths, b=2):
    """[B, sum(lengths)] int32: document i covers lengths[i] positions; the
    second row's documents come in reverse order."""
    row = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lengths)])
    rev = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lengths[::-1])])
    return np.stack([row, rev][:b])


def to3(x):
    """[B, T, H, D] -> [B*H, T, D], the kernels' layout."""
    b, t_len, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t_len, d))


@pytest.fixture(scope="module")
def pallas():
    """Per case: the inputs and the Pallas kernels' fwd and bwd outputs."""
    out = {}
    for i, (name, (t_len, h, kh, d, causal, window, lengths)) in enumerate(CASES.items()):
        q, k, v = (to3(x) for x in qkv(i, t_len, h, kh, d))
        do = np.random.RandomState(100 + i).randn(*q.shape).astype(np.float32)
        docs = doc_ids(lengths) if lengths else np.zeros((2, t_len), np.int32)
        args = (docs, docs, causal, window, lengths is not None, BLOCK, BLOCK, True)
        o, lse = jsplash._splash_fwd_3d(q, k, v, *args)
        dq, dk, dv = jsplash._splash_bwd_3d(q, k, v, o, lse, do, *args)
        out[name] = dict(q=q, k=k, v=v, do=do, docs=docs if lengths else None,
                         o=np.asarray(o), lse=np.asarray(lse),
                         dq=np.asarray(dq), dk=np.asarray(dk), dv=np.asarray(dv))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_pallas_kernels(case, pallas):
    x = pallas[case]
    causal, window = CASES[case][4], CASES[case][5]
    q, k, v, do = t(x["q"]), t(x["k"]), t(x["v"]), t(x["do"])
    docs = None if x["docs"] is None else t(x["docs"])
    o, lse = splash.splash_fwd_plain(q, k, v, docs, docs, causal, window)
    np.testing.assert_allclose(o.numpy(), x["o"], atol=TOL)
    np.testing.assert_allclose(lse.numpy(), x["lse"], atol=TOL)
    # The backward kernels on the Pallas forward's own residuals.
    o_ref, lse_ref = t(x["o"]), t(x["lse"])
    delta = (do * o_ref).sum(-1)
    args = (q, k, v, do, lse_ref, delta, docs, docs, causal, window)
    dq = splash.splash_bwd_dq_plain(*args)
    dk, dv = splash.splash_bwd_dkv_plain(*args)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got.numpy(), x[name], atol=TOL, err_msg=name)


def test_autograd_matches_jax_grad():
    """Window 32 and three documents, fwd and bwd through both custom VJPs."""
    q, k, v = qkv(11, t_len=64)
    docs = doc_ids((10, 34, 20))

    def jloss(q, k, v):
        o = jsplash.splash_attention(q, k, v, window=32, doc_ids=docs, block_q=BLOCK,
                                     block_k=BLOCK, interpret=True)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out = splash.splash_attention(tq, tk, tv, window=32, doc_ids=t(docs))
    assert out.dtype == torch.float32 and out.shape == tq.shape
    torch.sin(out).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, err_msg=f"d{name}")


def test_reference_matches_jax_reference():
    q, k, v = qkv(12, t_len=48)
    docs = doc_ids((5, 30, 13))
    for kw in (dict(window=16), dict(window=16, doc_ids=docs), dict(causal=False, doc_ids=docs)):
        want = jsplash.splash_reference(q, k, v, **kw)
        tkw = {**kw, "doc_ids": t(docs)} if "doc_ids" in kw else kw
        got = splash.splash_reference(t(q), t(k), t(v), **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, err_msg=str(kw))


def test_rows_that_see_no_key_give_neg_inf_lse_and_zero_grads():
    """A query row whose document has no key (docq 9 against keys of 0/1)
    comes out o = 0, lse = NEG_INF; its dq is zero and it adds to dk and dv
    what a row with do = 0 adds: nothing."""
    q, k, v = (t(to3(x)) for x in qkv(7, t_len=32))
    docq = t(doc_ids((16, 16)))
    docq[:, 5] = 9
    dock = t(doc_ids((16, 16)))
    do = t(np.random.RandomState(7).randn(*q.shape).astype(np.float32))
    o, lse = splash.splash_fwd_plain(q, k, v, docq, dock, True, 8)
    assert not o[:, 5].any() and bool((lse[:, 5] == splash.NEG_INF).all())
    assert bool(torch.isfinite(o).all()) and bool((lse[:, [4, 6]] > splash.NEG_INF).all())
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, docq, dock, True, 8)
    dq = splash.splash_bwd_dq_plain(*args)
    assert not dq[:, 5].any() and bool(torch.isfinite(dq).all())
    silent = do.clone()
    silent[:, 5] = 0
    got = splash.splash_bwd_dkv_plain(*args)
    want = splash.splash_bwd_dkv_plain(q, k, v, silent, lse, (silent * o).sum(-1), docq, dock,
                                       True, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


class TestDispatch:
    def test_attention_core_matches_jax_attention_core(self):
        q, k, v = qkv(15, t_len=128)
        docs = doc_ids((40, 56, 32))
        want = jattn.attention_core(q, k, v, "splash", None, window=48, doc_ids=docs)
        got = tattn.attention_core(t(q), t(k), t(v), "splash", window=48, doc_ids=t(docs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)

    def test_cpu_odd_length_falls_back_to_the_reference(self):
        q, k, v = (t(x) for x in qkv(16, t_len=63))
        with pytest.raises(ValueError, match="block-divisible"):
            splash.splash_attention(q, k, v, window=16)
        got = tattn.attention_core(q, k, v, "splash", window=16)
        assert torch.equal(got, splash.splash_reference(q, k, v, window=16))

    def test_window_without_causal_raises(self):
        q, k, v = (t(x) for x in qkv(14))
        with pytest.raises(ValueError, match="causal"):
            splash.splash_attention(q, k, v, causal=False, window=16)

    def test_other_impls_ignore_window_and_doc_ids(self):
        q, k, v = (t(x) for x in qkv(17))
        docs = t(doc_ids((30, 34)))
        for impl in ("blockwise", "flash", "plain"):
            got = tattn.attention_core(q, k, v, impl, window=16, doc_ids=docs)
            assert torch.equal(got, tattn.attention_core(q, k, v, impl)), impl

    @pytest.mark.parametrize("t_len", [63, 1000])
    def test_tensors_off_the_cpu_reach_the_kernel_wrappers(self, t_len):
        """Only CPU tensors take the reference fallback or the block-divisible
        error: elsewhere the splash route goes to the kernel wrappers at any
        length, and those launch or raise. A `meta` tensor stands for one the
        kernels do not take."""
        q = torch.empty((1, t_len, 4, 16), device="meta")
        k = torch.empty((1, t_len, 2, 16), device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            tattn.attention_core(q, k, k, "splash", window=16)

    def test_validate_config_takes_splash_and_checks_its_menu(self):
        """splash shares the in-repo kernel's menu: 576 takes a block of 64,
        63 takes none; a window needs splash."""
        validate_config(get_config("test", attn_impl="splash", attn_window=64), seq=576)
        with pytest.raises(ValueError, match="block-divisible"):
            validate_config(get_config("test", attn_impl="splash"), seq=63)
        with pytest.raises(ValueError, match="attn_window"):
            validate_config(get_config("test", attn_impl="flash", attn_window=64), seq=128)
        with pytest.raises(ValueError, match="attn_window"):
            validate_config(get_config("test", attn_impl="splash", attn_window=-1), seq=128)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(self):
        q, k, v = (t(x).requires_grad_(True) for x in qkv(10))
        splash.reset_launches()
        flash.reset_launches()
        out = splash.splash_attention(q, k, v, window=16, doc_ids=t(doc_ids((30, 34))))
        torch.sin(out).sum().backward()
        assert splash.launches == {"splash_fwd": 0, "splash_bwd_dq": 0, "splash_bwd_dkv": 0}
        assert not any(flash.launches.values())
        assert q.grad is not None and k.grad.dtype == torch.float32

    def test_tensors_off_the_cpu_never_take_the_plain_versions(self):
        q = torch.empty((8, 64, 16), device="meta")
        k = torch.empty((4, 64, 16), device="meta")
        lse = torch.empty((8, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            splash.splash_fwd(q, k, k, None, None, True, 16)
        with pytest.raises(ValueError, match="CUDA device"):
            splash.splash_bwd_dq(q, k, k, q, lse, lse, None, None, True, 16)
        with pytest.raises(ValueError, match="CUDA device"):
            splash.splash_bwd_dkv(q, k, k, q, lse, lse, None, None, True, 16)

    def test_the_build_compiles_the_splash_source(self, tmp_path):
        assert "splash_attention" in build.sources()
        argv = build.nvcc_argv("nvcc", build.CSRC_DIR / "splash_attention.cu", tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in argv


# Card tolerance, atol only, as flash is held: kernel and plain version
# both compute in fp32 and differ in summation order alone.
CARD_TOL = 2e-5


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """On an sm_90 card: each splash kernel against its plain version, fp32
    and bf16, windowed with documents, a ragged last tile (T = 72) and full
    attention with documents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90) and nvcc")
    for dtype, t_len, causal, window, lengths in [
        (torch.float32, 72, True, 40, None), (torch.bfloat16, 256, True, 100, (90, 100, 66)),
        (torch.bfloat16, 128, False, 0, (60, 68)),
    ]:
        q, k, v = (t(to3(x)).cuda().to(dtype) for x in qkv(12, t_len=t_len, d=128))
        docs = t(doc_ids(lengths)).cuda() if lengths else None
        do = torch.randn(q.shape, device="cuda")
        o, lse = splash.splash_fwd(q, k, v, docs, docs, causal, window)
        ro, rlse = splash.splash_fwd_plain(q, k, v, docs, docs, causal, window)
        torch.testing.assert_close(o, ro, atol=CARD_TOL, rtol=0)
        torch.testing.assert_close(lse, rlse, atol=CARD_TOL, rtol=0)
        args = (q, k, v, do, rlse, (do * ro).sum(-1), docs, docs, causal, window)
        got = (splash.splash_bwd_dq(*args), *splash.splash_bwd_dkv(*args))
        ref = (splash.splash_bwd_dq_plain(*args), *splash.splash_bwd_dkv_plain(*args))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=CARD_TOL, rtol=0)
