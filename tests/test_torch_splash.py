"""The port's splash attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks:

- the plain versions of the three CUDA kernels (``kernels/splash.py``)
  against the Pallas kernels run in interpret mode at block 16, as
  tests/test_kernels.py runs them: causal, causal with a window of 24
  (n_rep = 4), a window of 48 with three packed documents, and full
  attention with documents. Forward o and lse, then dq, dk, dv on the Pallas
  forward's o and lse. fp32 on both sides, so only the summation order
  differs: atol 1e-5;
- emulations of the tensor-core forward, dq and dk/dv walks of
  csrc/attention_mma_kernels.cuh under splash's BandMask (their tile edges,
  band bounds, edge tiles, dk/dv's far-to-near order, p, ds and do in three
  bf16 terms, per-tile sums) against the same Pallas outputs, at the card's
  tile edges and at small ones that walk several tiles here, atol 1e-5; and
  a read of the sources: the tensor-core kernels exist only at bf16 D
  32/64/128, and flash and splash share their bodies;
- gradients of sum(sin(splash_attention(...))) through the port's autograd
  function against jax.grad of the JAX kernel, atol 1e-4 (the tolerance of
  TestSplashKernel);
- rows that see no key, the dispatch through ``attention_core``, the
  config check, the wrappers' CPU path and launch counters, and the build.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash import split_bf16

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
    # A window that is a multiple of no tile edge below, and a length that
    # is a multiple of no row edge (the Pallas kernels take a block of 19).
    "ragged76-window21-docs": (76, 4, 2, 16, True, 21, (30, 46)),
}
PALLAS_BLOCKS = {"ragged76-window21-docs": 19}


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
        block = PALLAS_BLOCKS.get(name, BLOCK)
        args = (docs, docs, causal, window, lengths is not None, block, block, True)
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


# -- the tensor-core walks ---------------------------------------------------
#
# csrc/attention_mma_kernels.cuh's forward, dq and dk/dv bodies, which flash
# and splash share, run under splash's BandMask: the forward walks 64-row q
# tiles over the KV tiles [lo, hi) of 64 keys, dq the same q tiles over KV
# tiles of 32 keys; dk/dv walks each 64-key tile's 32-row q tiles [q_lo,
# q_hi) from the farthest to the nearest, the n_rep heads interleaved; only
# edge tiles (across the causal diagonal, the window's edge, the ragged end,
# or any tile when documents are given) compare elements. Below, those walks
# in torch, with the bf16 products exact (fp64), p and ds (and do) in three
# bf16 terms, each tile's products summed on their own and added into the
# fp32 sums. The tile edges are parameters: the card's, and small ones under
# which these inputs walk several tiles.

# name -> ((fwd rows, fwd keys), (dk/dv keys, dk/dv rows), (dq rows, dq keys))
WALK_EDGES = {
    "card": ((64, 64), (64, 32), (64, 32)),
    "small": ((16, 16), (16, 8), (16, 8)),
}
PDO_PRODUCTS = [(i, j) for i in range(3) for j in range(3) if i + j < 3]


def band_bounds(t_len, s_len, causal, window):
    """BandMask's tile ranges and edge test at row and key tile edges."""

    def kv_range(q0, rows, keys):
        lo = max(0, q0 - (window - 1)) // keys if window else 0
        n_kv = -(-s_len // keys)
        hi = min(n_kv, (min(t_len, q0 + rows) - 1) // keys + 1) if causal else n_kv
        return lo, hi

    def q_range(k0, keys, rows):
        n_q = -(-t_len // rows)
        lo = min(k0 // rows, n_q) if causal else 0
        hi = min(n_q, (min(s_len, k0 + keys) - 1 + window - 1) // rows + 1) if window else n_q
        return lo, hi

    def edge(q0, k0, rows, keys, docs):
        return (docs or (causal and k0 + keys - 1 > q0)
                or bool(window and k0 + window <= q0 + rows - 1) or k0 + keys > s_len)

    return kv_range, q_range, edge


def pad_rows(x, r0, n):
    """Rows [r0, r0 + n) of x [G, L, ...], zero past L (cp.async zero fill)."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), dtype=x.dtype)
    rows = x[:, r0:r0 + n]
    out[:, :rows.shape[1]] = rows
    return out


def live_pairs(qp, kp, t_len, s_len, causal, window, docq=None, dock=None):
    """[G or 1, len(qp), len(kp)]: query qp sees key kp (both exist)."""
    live = (qp[:, None] < t_len) & (kp[None, :] < s_len)
    if causal:
        live &= kp[None, :] <= qp[:, None]
    if window:
        live &= kp[None, :] > qp[:, None] - window
    live = live[None]
    if docq is not None:
        dq = docq[:, qp.clamp(max=t_len - 1)]
        dk = dock[:, kp.clamp(max=s_len - 1)]
        live = live & (dq[:, :, None] == dk[:, None, :])
    return live


def splash_fwd_walk(q3, k3, v3, docs, causal, window, rows=64, keys=64):
    """(o, lse) fp32 as splash_fwd_mma_kernel computes them."""
    bh, t_len, d = q3.shape
    bkh, s_len, _ = k3.shape
    n_rep = bh // bkh
    scale = np.float32(1.0 / np.sqrt(d))
    kv_range, _, edge = band_bounds(t_len, s_len, causal, window)
    kv_row = torch.arange(bh) // n_rep
    docq = dock = None
    if docs is not None:
        per_row = docs[torch.arange(bh) // (bh // docs.shape[0])]
        docq, dock = per_row[:, :t_len], per_row[:, :s_len]
    o = torch.zeros((bh, t_len, d))
    lse = torch.zeros((bh, t_len))
    for q0 in range(0, t_len, rows):
        qt = pad_rows(q3, q0, rows).double()
        qp = torch.arange(q0, q0 + rows)
        m = torch.full((bh, rows), splash.NEG_INF)
        l = torch.zeros((bh, rows))
        acc = torch.zeros((bh, rows, d))
        lo, hi = kv_range(q0, rows, keys)
        for jk in range(lo, hi):
            k0 = jk * keys
            kt = pad_rows(k3, k0, keys)[kv_row].double()
            vt = pad_rows(v3, k0, keys)[kv_row].double()
            s = (qt @ kt.transpose(1, 2)).float() * scale
            if edge(q0, k0, rows, keys, docs is not None):
                kp = torch.arange(k0, k0 + keys)
                s = torch.where(live_pairs(qp, kp, t_len, s_len, causal, window, docq, dock),
                                s, splash.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            safe = torch.where(m_new == splash.NEG_INF, 0.0, m_new)
            corr = torch.where(m == splash.NEG_INF, 0.0, torch.exp(m - safe))
            p = torch.exp(s - safe[..., None])
            l = l * corr + p.sum(-1)
            pv = sum(t_ @ vt for t_ in split_bf16(p))
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        l_safe = torch.clamp(l, min=1e-20)
        n = min(rows, t_len - q0)
        o[:, q0:q0 + n] = (acc / l_safe[..., None])[:, :n]
        lse[:, q0:q0 + n] = (torch.where(m == splash.NEG_INF, splash.NEG_INF, m)
                             + torch.log(l_safe))[:, :n]
    return o, lse


def splash_dq_walk(q3, k3, v3, do3, lse, delta, docs, causal, window, rows=64, keys=32):
    """dq fp32 as splash_bwd_dq_mma_kernel computes it: per q tile, the KV
    tiles [lo, hi) of its band (lo from the window's lower edge, clamped
    before dividing), p = exp(s scale - lse) (0 on rows whose lse is
    NEG_INF, and on rows past T), element compares on edge tiles only, dP
    over do's three bf16 planes, dS in three terms, each tile's dS K added
    into the fp32 sum."""
    bh, t_len, d = q3.shape
    bkh, s_len, _ = k3.shape
    n_rep = bh // bkh
    scale = np.float32(1.0 / np.sqrt(d))
    kv_range, _, edge = band_bounds(t_len, s_len, causal, window)
    kv_row = torch.arange(bh) // n_rep
    docq = dock = None
    if docs is not None:
        per_row = docs[torch.arange(bh) // (bh // docs.shape[0])]
        docq, dock = per_row[:, :t_len], per_row[:, :s_len]
    dq = torch.zeros((bh, t_len, d))
    for q0 in range(0, t_len, rows):
        qt = pad_rows(q3, q0, rows).double()
        qp = torch.arange(q0, q0 + rows)
        planes = split_bf16(pad_rows(do3, q0, rows))
        ls = torch.full((bh, rows), splash.NEG_INF)  # NEG_INF past T: those rows' p is 0
        n = min(rows, t_len - q0)
        ls[:, :n] = lse[:, q0:q0 + n]
        dl = pad_rows(delta, q0, rows)
        acc = torch.zeros((bh, rows, d))
        lo, hi = kv_range(q0, rows, keys)
        for jk in range(lo, hi):
            k0 = jk * keys
            kt = pad_rows(k3, k0, keys)[kv_row].double()
            vt = pad_rows(v3, k0, keys)[kv_row].double()
            s = (qt @ kt.transpose(1, 2)).float()
            p = torch.where(ls[..., None] == splash.NEG_INF, 0.0,
                            torch.exp(s * scale - ls[..., None]))
            if edge(q0, k0, rows, keys, docs is not None):
                kp = torch.arange(k0, k0 + keys)
                p = torch.where(live_pairs(qp, kp, t_len, s_len, causal, window, docq, dock),
                                p, 0.0)
            dp = sum(pl @ vt.transpose(1, 2) for pl in planes).float()
            ds = p * (dp - dl[..., None]) * scale
            acc += sum(t_ @ kt for t_ in split_bf16(ds)).float()
        dq[:, q0:q0 + n] = acc[:, :n]
    return dq


def splash_dkv_walk(q3, k3, v3, do3, lse, delta, docs, causal, window, keys=64, rows=32):
    """(dk, dv) fp32 as splash_bwd_dkv_mma_kernel computes them."""
    bh, t_len, d = q3.shape
    bkh, s_len, _ = k3.shape
    n_rep = bh // bkh
    scale = np.float32(1.0 / np.sqrt(d))
    _, q_range, edge = band_bounds(t_len, s_len, causal, window)
    docq = dock = None
    if docs is not None:
        per_kv = docs[torch.arange(bkh) // (bkh // docs.shape[0])]
        docq, dock = per_kv[:, :t_len], per_kv[:, :s_len]
    dk = torch.zeros((bkh, s_len, d))
    dv = torch.zeros((bkh, s_len, d))
    for k0 in range(0, s_len, keys):
        kt = pad_rows(k3, k0, keys).double()
        vt = pad_rows(v3, k0, keys).double()
        kp = torch.arange(k0, k0 + keys)
        dk_acc = torch.zeros((bkh, keys, d))
        dv_acc = torch.zeros((bkh, keys, d))
        lo, hi = q_range(k0, keys, rows)
        for iq in range(hi - 1, lo - 1, -1):  # far to near, heads interleaved
            q0 = iq * rows
            qp = torch.arange(q0, q0 + rows)
            for rep in range(n_rep):
                heads = torch.arange(bkh) * n_rep + rep
                qt = pad_rows(q3[heads], q0, rows).double()
                planes = split_bf16(pad_rows(do3[heads], q0, rows))
                ls = pad_rows(lse[heads], q0, rows)  # zero past T, as the fetch fills it
                dl = pad_rows(delta[heads], q0, rows)
                st = (kt @ qt.transpose(1, 2)).float()  # [G, keys, rows]
                p = torch.where(ls[:, None] == splash.NEG_INF, 0.0,
                                torch.exp(st * scale - ls[:, None]))
                if edge(q0, k0, rows, keys, docs is not None) or q0 + rows > t_len:
                    live = live_pairs(qp, kp, t_len, s_len, causal, window, docq, dock)
                    p = torch.where(live.transpose(1, 2), p, 0.0)
                dpt = sum(vt @ pl.transpose(1, 2) for pl in planes).float()
                ds = p * (dpt - dl[:, None]) * scale
                pt, dst = split_bf16(p), split_bf16(ds)
                dv_acc += sum(pt[i] @ planes[j] for i, j in PDO_PRODUCTS).float()
                dk_acc += sum(t_ @ qt for t_ in dst).float()
        n = min(keys, s_len - k0)
        dk[:, k0:k0 + n] = dk_acc[:, :n]
        dv[:, k0:k0 + n] = dv_acc[:, :n]
    return dk, dv


@pytest.mark.parametrize("edges", list(WALK_EDGES))
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_forward_walk_matches_pallas(case, edges, pallas):
    x = pallas[case]
    causal, window = CASES[case][4], CASES[case][5]
    docs = None if x["docs"] is None else t(x["docs"])
    rows, keys = WALK_EDGES[edges][0]
    o, lse = splash_fwd_walk(t(x["q"]), t(x["k"]), t(x["v"]), docs, causal, window, rows, keys)
    np.testing.assert_allclose(o.numpy(), x["o"], atol=TOL)
    np.testing.assert_allclose(lse.numpy(), x["lse"], atol=TOL)


@pytest.mark.parametrize("edges", list(WALK_EDGES))
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_dq_walk_matches_pallas(case, edges, pallas):
    """On the Pallas forward's o and lse, as the kernels run in training."""
    x = pallas[case]
    causal, window = CASES[case][4], CASES[case][5]
    docs = None if x["docs"] is None else t(x["docs"])
    rows, keys = WALK_EDGES[edges][2]
    do, o = t(x["do"]), t(x["o"])
    dq = splash_dq_walk(t(x["q"]), t(x["k"]), t(x["v"]), do, t(x["lse"]), (do * o).sum(-1),
                        docs, causal, window, rows, keys)
    np.testing.assert_allclose(dq.numpy(), x["dq"], atol=TOL)


@pytest.mark.parametrize("edges", list(WALK_EDGES))
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_dkv_walk_matches_pallas(case, edges, pallas):
    """On the Pallas forward's o and lse, as the kernels run in training."""
    x = pallas[case]
    causal, window = CASES[case][4], CASES[case][5]
    docs = None if x["docs"] is None else t(x["docs"])
    keys, rows = WALK_EDGES[edges][1]
    do, o = t(x["do"]), t(x["o"])
    dk, dv = splash_dkv_walk(t(x["q"]), t(x["k"]), t(x["v"]), do, t(x["lse"]), (do * o).sum(-1),
                             docs, causal, window, keys, rows)
    np.testing.assert_allclose(dk.numpy(), x["dk"], atol=TOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), x["dv"], atol=TOL, err_msg="dv")


def test_tensor_core_kernels_exist_only_at_bf16_d32_64_128():
    """Read from the sources: TensorCore<T, D> holds for bf16 at D 32, 64 and
    128 alone, and the splash forward, dq and dk/dv dispatch on it to their
    tensor-core kernels, each a wrapper of the body that flash's kernel of
    the same name wraps (the shared bodies, under BandMask and
    CausalMask)."""
    header = (build.CSRC_DIR / "attention_mma.cuh").read_text()
    dims = sorted(int(x) for x in re.findall(r"struct TensorCore<__nv_bfloat16, (\d+)>", header))
    assert dims == [32, 64, 128]
    assert re.search(r"struct TensorCore \{\s*static constexpr bool value = false;", header)
    src = (build.CSRC_DIR / "splash_attention.cu").read_text()
    assert '#include "attention_mma_kernels.cuh"' in src
    args = {name: src[src.index(f"struct {name} {{"):] for name in ("FwdArgs", "DqArgs", "DkvArgs")}
    args = {name: body[:body.index("\n};\n")] for name, body in args.items()}
    flash_src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for name, kernel, body in (("FwdArgs", "splash_fwd", "fwd_mma_body"),
                               ("DqArgs", "splash_bwd_dq", "dq_mma_body"),
                               ("DkvArgs", "splash_bwd_dkv", "dkv_mma_body")):
        assert "if constexpr (TensorCore<T, D>::value)" in args[name], name
        # The tensor-core kernels take the menu pair's tile as a third
        # template argument (the tile menu, kernels/flash.py TILE_MENU).
        assert f"{kernel}_mma_kernel<D, DOCS, " in args[name], name
        assert f"{kernel}_kernel<T, D>" in args[name], name
        assert re.search(rf"{kernel}_mma_kernel\([^{{]*\{{\s*attn_mma::{body}<D, \w+>", src), name
        flash_kernel = kernel.replace("splash", "flash")
        assert re.search(rf"{flash_kernel}_mma_kernel\([^{{]*\{{\s*attn_mma::{body}<D, \w+>",
                         flash_src), name


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
    attention with documents; at bf16 D 128 the forward, dq and dk/dv
    launches run the tensor-core kernels, at fp32 the CUDA-core ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90) and nvcc")
    for name in splash.launches:
        assert splash.instantiation(name, torch.bfloat16, 128).startswith("bf16 tensor cores")
        assert splash.instantiation(name, torch.float32, 128).startswith("CUDA cores")
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
