"""The port's flash attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks:

- the plain versions of the three CUDA kernels (``kernels/flash.py``)
  against the Pallas kernels run in interpret mode, as tests/test_kernels.py
  runs them: forward o and lse, causal (n_rep = 2) and full (n_rep = 4),
  then dq, dk, dv on the same o, lse and do. fp32 on both sides, so only the
  summation order differs: atol 1e-5;
- gradients of sum(sin(flash_attention(q, k, v))) through the port's
  autograd function against jax.grad of the JAX kernel, atol 1e-4 (the JAX
  tests' tolerance for the same check);
- the dispatch (block-divisible lengths, the blockwise fallback, the
  ``flash_tpu`` contract, meshes not ported), the wrappers' CPU path and
  launch counters, and the build of the CUDA source (its library path
  follows the headers it includes);
- the split-bf16 products of the tensor-core kernels (forward, dq, dk/dv),
  emulated in fp64: three bf16 terms hold fp32 values exactly, every
  product the kernels issue stays within half the card tolerance, and a do
  of bf16 values leaves the two low planes that the kernels skip exactly
  zero.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads.kernels import flash as jflash
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads.config import get_config, validate_config
from dstack_tpu_torch.workloads.kernels import build, flash

TOL = 1e-5
GRAD_TOL = 1e-4
BLOCK = 16  # the Pallas kernels' block here: T = 64 walks 4 blocks

# name -> (t, h, kh, d, causal)
CASES = {
    "causal": (64, 4, 2, 16, True),
    "full-n_rep4": (64, 8, 2, 16, False),
}


def t(a):
    return torch.from_numpy(np.array(a))


def qkv(seed, t_len=64, h=4, kh=2, d=16, b=2):
    rng = np.random.RandomState(seed)
    return tuple(
        rng.randn(b, t_len, n, d).astype(np.float32) for n in (h, kh, kh)
    )


def to3(x):
    """[B, T, H, D] -> [B*H, T, D], the kernels' layout."""
    b, t_len, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t_len, d))


@pytest.fixture(scope="module")
def pallas():
    """Per case: the inputs and the Pallas kernels' fwd and bwd outputs."""
    out = {}
    for i, (name, (t_len, h, kh, d, causal)) in enumerate(CASES.items()):
        q, k, v = (to3(x) for x in qkv(i, t_len, h, kh, d))
        do = np.random.RandomState(100 + i).randn(*q.shape).astype(np.float32)
        o, lse = jflash._flash_fwd_3d(q, k, v, causal, BLOCK, BLOCK, True)
        dq, dk, dv = jflash._flash_bwd_3d(q, k, v, o, lse, do, causal, BLOCK, BLOCK, True)
        out[name] = dict(q=q, k=k, v=v, do=do, o=np.asarray(o), lse=np.asarray(lse),
                         dq=np.asarray(dq), dk=np.asarray(dk), dv=np.asarray(dv))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_pallas_kernels(case, pallas):
    x = pallas[case]
    causal = CASES[case][4]
    q, k, v, do = t(x["q"]), t(x["k"]), t(x["v"]), t(x["do"])
    o, lse = flash.flash_fwd_plain(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), x["o"], atol=TOL)
    np.testing.assert_allclose(lse.numpy(), x["lse"], atol=TOL)
    # The backward kernels on the Pallas forward's own residuals.
    o_ref, lse_ref = t(x["o"]), t(x["lse"])
    delta = (do * o_ref).sum(-1)
    dq = flash.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
    dk, dv = flash.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got.numpy(), x[name], atol=TOL, err_msg=name)


def test_fully_masked_rows_give_neg_inf_lse_and_zero_grads():
    """The guards: a row whose lse is NEG_INF (all keys masked) contributes
    nothing to any gradient, and its own dq is zero."""
    q, k, v = (t(to3(x)) for x in qkv(7, t_len=16))
    do = t(np.random.RandomState(7).randn(*q.shape).astype(np.float32))
    o, lse = flash.flash_fwd_plain(q, k, v, True)
    delta = (do * o).sum(-1)
    dead = lse.clone()
    dead[:, 3] = flash.NEG_INF  # as if row 3 saw nothing
    dq = flash.flash_bwd_dq_plain(q, k, v, do, dead, delta, True)
    assert not dq[:, 3].any() and torch.isfinite(dq).all()
    # A dead row adds to dk and dv what a row with do = 0 and delta = 0 adds:
    # nothing.
    silent_do, silent_delta = do.clone(), delta.clone()
    silent_do[:, 3] = 0
    silent_delta[:, 3] = 0
    got = flash.flash_bwd_dkv_plain(q, k, v, do, dead, delta, True)
    want = flash.flash_bwd_dkv_plain(q, k, v, silent_do, lse, silent_delta, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


def test_autograd_matches_jax_grad():
    q, k, v = qkv(11)
    causal = True

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jflash.flash_attention(q, k, v, causal=causal)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    torch.sin(out).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, err_msg=f"d{name}")


class TestDispatch:
    def test_ragged_length_raises_and_attention_core_falls_back(self):
        q, k, v = (t(x) for x in qkv(3, t_len=63))
        assert flash.pick_flash_block(63) is None
        with pytest.raises(ValueError, match="block-divisible"):
            flash.flash_attention(q, k, v)
        got = tattn.attention_core(q, k, v, "flash")
        assert torch.equal(got, tattn.blockwise_attention(q, k, v))

    def test_flash_tpu_returns_q_dtype_and_falls_back_off_its_menu(self):
        q, k, v = (t(x).bfloat16() for x in qkv(4, t_len=128))
        out = tattn.flash_attention_tpu(q, k, v)
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        ref = flash.flash_attention(q, k, v).to(torch.bfloat16)
        assert torch.equal(out, ref)
        q, k, v = (t(x) for x in qkv(5, t_len=64))  # 64 is off the 512/256/128 menu
        assert torch.equal(tattn.flash_attention_tpu(q, k, v), tattn.blockwise_attention(q, k, v))

    def test_auto_and_flash_tpu_run_blockwise_on_the_cpu(self):
        q, k, v = (t(x) for x in qkv(6, t_len=128))
        ref = tattn.blockwise_attention(q, k, v)
        for impl in ("auto", "flash_tpu"):
            assert torch.equal(tattn.attention_core(q, k, v, impl), ref)
        assert tattn.flash_available(torch.device("cuda")) and not tattn.flash_available("cpu")

    def test_tensors_off_the_cpu_reach_the_kernels_at_every_length(self):
        """Only CPU tensors take the blockwise fallback or the block-divisible
        error: elsewhere every flash route goes to the kernel wrappers at any
        length, and those launch or raise. A `meta` tensor stands for one the
        kernels do not take."""
        for t_len, impl in ((63, "flash"), (1000, "flash"), (1000, "flash_tpu")):
            q = torch.empty((1, t_len, 4, 16), device="meta")
            k = torch.empty((1, t_len, 2, 16), device="meta")
            call = (lambda: tattn.flash_attention_tpu(q, k, k)) if impl == "flash_tpu" else (
                lambda: tattn.attention_core(q, k, k, impl))
            with pytest.raises(ValueError, match="CUDA device"):
                call()

    def test_splash_and_meshes_are_not_ported(self, tmp_path):
        """Splash, the training mesh and now the sequence-parallel mesh are
        ported (tests/test_torch_splash.py, test_torch_train_mesh.py,
        test_torch_ring.py; the name is the one this test had while sp was
        refused): attention_core(flash) at sp 2, on two gloo ranks each
        holding its half of the sequence, runs ring attention and equals
        the blockwise walk over the whole sequence."""
        from tests.torch_mesh_worker import start_world

        q, k, v = qkv(8)
        results = start_world([("attention_core_sp", dict(shape=dict(fsdp=1, sp=2), q=q, k=k,
                                                          v=v, impl="flash"))],
                              2, tmp_path / "world", timeout=120)()
        got = np.zeros(q.shape, np.float32)
        for (rank,) in results:
            got[rank["q_index"]] = rank["out"]
        want = tattn.blockwise_attention(*(t(x) for x in (q, k, v))).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)

    def test_validate_config_checks_each_impls_block_menu(self):
        """576 takes the in-repo kernel's block of 64 but none of the public
        kernel's 512/256/128; 63 takes neither."""
        validate_config(get_config("test", attn_impl="flash"), seq=576)
        for impl, seq in (("flash_tpu", 576), ("flash", 63)):
            with pytest.raises(ValueError, match="block-divisible"):
                validate_config(get_config("test", attn_impl=impl), seq=seq)

    def test_plain_attention_matches_blockwise_in_fp32(self):
        q, k, v = (t(x) for x in qkv(9))
        for causal in (True, False):
            np.testing.assert_allclose(
                tattn.plain_attention(q, k, v, causal=causal).numpy(),
                tattn.blockwise_attention(q, k, v, causal=causal).numpy(), atol=TOL,
            )


# The headers under csrc/, each its own case of the header-hash test: the
# tensor-core pieces, the tensor-core bodies shared by flash and splash, and
# the CUDA-core tile helpers.
HEADERS = ["attention_cuda_core.cuh", "attention_mma.cuh", "attention_mma_kernels.cuh"]


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(self):
        q, k, v = (t(x).requires_grad_(True) for x in qkv(10))
        flash.reset_launches()
        torch.sin(flash.flash_attention(q, k, v)).sum().backward()
        assert flash.launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        assert q.grad is not None and k.grad.dtype == torch.float32

    def test_tensors_off_the_cpu_never_take_the_plain_versions(self):
        """A tensor that is not on the CPU goes to a kernel or raises; here a
        `meta` tensor stands for one the kernels do not take."""
        q = torch.empty((8, 64, 16), device="meta")
        k = torch.empty((4, 64, 16), device="meta")
        lse = torch.empty((8, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            flash.flash_fwd(q, k, k, True)
        with pytest.raises(ValueError, match="CUDA device"):
            flash.flash_bwd_dq(q, k, k, q, lse, lse, True)
        with pytest.raises(ValueError, match="CUDA device"):
            flash.flash_bwd_dkv(q, k, k, q, lse, lse, True)

    def test_the_build_compiles_the_flash_source(self, tmp_path):
        assert "flash_attention" in build.sources()
        argv = build.nvcc_argv("nvcc", build.CSRC_DIR / "flash_attention.cu", tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in argv

    @pytest.mark.parametrize("header", HEADERS)
    def test_library_path_changes_when_a_header_changes(self, header, tmp_path, monkeypatch):
        """The sources include ``csrc/*.cuh``, so an edited header must build a
        new library of each source that includes it and never load one built
        from the old header."""
        assert sorted(p.name for p in build.CSRC_DIR.glob("*.cuh")) == HEADERS
        csrc = tmp_path / "csrc"
        shutil.copytree(build.CSRC_DIR, csrc)
        monkeypatch.setattr(build, "CSRC_DIR", csrc)
        line = f'#include "{header}"'
        users = [n for n in build.sources() if line in (csrc / f"{n}.cu").read_text()]
        assert "flash_attention" in users
        before = {n: build.library_path(n) for n in users}
        assert {n: build.library_path(n) for n in users} == before  # stable
        path = csrc / header
        path.write_bytes(path.read_bytes() + b"\n// edited\n")
        after = {n: build.library_path(n) for n in users}
        for n in users:
            assert after[n] != before[n] and after[n].parent == before[n].parent, n
        (csrc / "extra.cuh").write_text("// a new header\n")
        for n in users:
            assert build.library_path(n) not in (before[n], after[n]), n


# -- the split-bf16 products of the tensor-core kernels ----------------------
#
# csrc/flash_attention.cu runs the forward, dq and dk/dv on bf16 tensor cores
# and keeps the fp32 contract by writing each fp32 operand as a sum of bf16
# terms (t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1)) with one mma
# per term: P.V with P in 3 terms; dq's dO.V^T over the 3 planes of dO and
# dS.K with dS in 3 terms; dk/dv's dS^T.Q with dS^T in 3 terms, V.dO^T over
# the 3 planes of dO, and P^T.dO over the 6 products of terms i + j < 3.
# Below, an emulation of exactly those products in fp64 on one head of the
# llama3_1b geometry (D 128), cut to T 512.

SPLIT_TERMS = 3
PDO_PRODUCTS = [(i, j) for i in range(SPLIT_TERMS) for j in range(SPLIT_TERMS) if i + j < SPLIT_TERMS]


def split_bf16(x32: torch.Tensor, terms: int = SPLIT_TERMS):
    """The bf16 terms of fp32 values, as fp64 tensors; each residual is
    exact in fp32."""
    out, r = [], x32.clone()
    for _ in range(terms):
        t_ = r.to(torch.bfloat16).to(torch.float32)
        out.append(t_.double())
        r = r - t_
    return out


@pytest.fixture(scope="module")
def split_operands():
    """One causal head at T 512, D 128: bf16 q, k, v, fp32 do, and the fp32
    p and ds the kernels compute (here in fp64, then rounded to fp32)."""
    rng = np.random.RandomState(40)
    t_len, d = 512, 128
    q, k, v = (torch.from_numpy(rng.randn(t_len, d)).to(torch.bfloat16).double() for _ in range(3))
    do = torch.from_numpy(rng.randn(t_len, d).astype(np.float32))
    s = (q @ k.T) / np.sqrt(d)
    s = s.masked_fill(torch.ones(t_len, t_len, dtype=torch.bool).triu(1), -np.inf)
    p = torch.softmax(s, -1)
    o = p @ v
    delta = (do.double() * o).sum(-1, keepdim=True)
    ds = p * (do.double() @ v.T - delta) / np.sqrt(d)
    return dict(q=q, k=k, v=v, do=do, p=p.float(), ds=ds.float())


def test_three_bf16_terms_hold_fp32_values_exactly(split_operands):
    rng = np.random.RandomState(41)
    wide = torch.from_numpy((rng.randn(4096) * np.exp(rng.uniform(-60, 60, 4096))).astype(np.float32))
    for name, x in (("p", split_operands["p"]), ("ds", split_operands["ds"]),
                    ("do", split_operands["do"]), ("wide", wide)):
        terms = split_bf16(x)
        assert torch.equal(sum(terms), x.double()), name
        # Two terms are not enough: the third holds bits of most values.
        assert not torch.equal(sum(terms[:2]), x.double()), name


def test_split_products_stay_within_half_the_card_tolerance(split_operands):
    """Each product the kernels issue, from the kept terms, against the fp64
    product of the fp32 operands: under 1e-5 (half of chip_smoke.py's atol
    2e-5); one bf16 term alone would be far outside it."""
    x = split_operands
    p, ds, do = x["p"], x["ds"], x["do"]
    pt, dst, dot = split_bf16(p), split_bf16(ds), split_bf16(do)
    products = {
        "P.V": (sum(t_ @ x["v"] for t_ in pt), p.double() @ x["v"], pt[0] @ x["v"]),
        "dS^T.Q": (sum(t_.T @ x["q"] for t_ in dst), ds.double().T @ x["q"], dst[0].T @ x["q"]),
        "V.dO^T": (sum(x["v"] @ t_.T for t_ in dot), x["v"] @ do.double().T, x["v"] @ dot[0].T),
        "P^T.dO": (sum(pt[i].T @ dot[j] for i, j in PDO_PRODUCTS), p.double().T @ do.double(),
                   pt[0].T @ dot[0]),
    }
    for name, (kept, exact, one_term) in products.items():
        err = float((kept - exact).abs().max())
        assert err < 1e-5, f"{name}: {err:.3e}"
        assert float((one_term - exact).abs().max()) > 1e-5, name


def test_dq_split_products_stay_within_half_the_card_tolerance(split_operands):
    """dq's products from their kept terms against the fp64 products of the
    fp32 operands: dO.V^T over do's planes and dS.K with dS in 3 terms, each
    under 1e-5; one bf16 term alone is outside it."""
    x = split_operands
    ds, do = x["ds"], x["do"]
    dst, dot = split_bf16(ds), split_bf16(do)
    products = {
        "dO.V^T": (sum(t_ @ x["v"].T for t_ in dot), do.double() @ x["v"].T, dot[0] @ x["v"].T),
        "dS.K": (sum(t_ @ x["k"] for t_ in dst), ds.double() @ x["k"], dst[0] @ x["k"]),
    }
    for name, (kept, exact, one_term) in products.items():
        err = float((kept - exact).abs().max())
        assert err < 1e-5, f"{name}: {err:.3e}"
        assert float((one_term - exact).abs().max()) > 1e-5, name


def test_a_do_of_bf16_values_leaves_its_low_planes_zero(split_operands):
    """Training's do holds bf16 values (the model casts o to bf16): its first
    plane is the whole value and the two low planes, which the dq and dk/dv
    kernels skip when a tile's are all zero, are exactly zero; an fp32 do's
    are not."""
    do_bf16 = split_operands["do"].to(torch.bfloat16).to(torch.float32)
    planes = split_bf16(do_bf16)
    assert torch.equal(planes[0], do_bf16.double())
    assert not planes[1].any() and not planes[2].any()
    assert split_bf16(split_operands["do"])[1].any()


# Card tolerance, atol only: the largest |kernel - plain| measured by
# chip_smoke.py on an H100 is 3.1e-6 (dk/dv of the tensor-core kernel at T
# 8192, against plain sums taken in fp64), 6x inside 2e-5; a kernel that
# drops one tile is off by far more (chip_smoke.py prints that reading
# beside the limit).
CARD_TOL = 2e-5


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """On an sm_90 card: each flash kernel against its plain version, fp32
    and bf16, causal and full, a ragged last tile (T = 72) included; at bf16
    D 128 all three launches run the tensor-core kernels, at fp32 the
    CUDA-core ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90) and nvcc")
    for name in flash.launches:
        assert flash.instantiation(name, torch.bfloat16, 128).startswith("bf16 tensor cores")
        assert flash.instantiation(name, torch.float32, 128).startswith("CUDA cores")
    for dtype, (t_len, causal) in [(torch.float32, (72, True)), (torch.bfloat16, (72, False)),
                                   (torch.bfloat16, (256, True))]:
        q, k, v = (t(to3(x)).cuda().to(dtype) for x in qkv(12, t_len=t_len, d=128))
        do = torch.randn(q.shape, device="cuda")
        o, lse = flash.flash_fwd(q, k, v, causal)
        ro, rlse = flash.flash_fwd_plain(q, k, v, causal)
        torch.testing.assert_close(o, ro, atol=CARD_TOL, rtol=0)
        torch.testing.assert_close(lse, rlse, atol=CARD_TOL, rtol=0)
        delta = (do * ro).sum(-1)
        got = (flash.flash_bwd_dq(q, k, v, do, rlse, delta, causal),
               *flash.flash_bwd_dkv(q, k, v, do, rlse, delta, causal))
        ref = (flash.flash_bwd_dq_plain(q, k, v, do, rlse, delta, causal),
               *flash.flash_bwd_dkv_plain(q, k, v, do, rlse, delta, causal))
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=CARD_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,t_len", [("auto", 1000), ("flash_tpu", 1000), ("flash", 1000),
                                        ("flash", 63)])
def test_dispatch_launches_the_kernels_at_any_length_on_the_card(impl, t_len):
    """On the card no length takes the blockwise walk: T = 1000 (off the
    512/256/128 menu) and T = 63 (no block at all) launch each flash kernel
    once for a forward and a backward, and agree with blockwise in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90) and nvcc")
    q, k, v = (t(x).cuda() for x in qkv(13, t_len=t_len, d=128, b=1))
    w = torch.randn(q.shape, device="cuda")
    grads = {}
    for name in (impl, "blockwise"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        flash.reset_launches()
        out = tattn.attention_core(*leaves, name)
        (out.float() * w).sum().backward()
        if name == impl:
            assert flash.launches == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
            assert out.dtype == q.dtype
        grads[name] = (out.detach(), *(x.grad for x in leaves))
    for g, r in zip(grads[impl], grads["blockwise"]):
        torch.testing.assert_close(g, r, atol=CARD_TOL, rtol=0)
