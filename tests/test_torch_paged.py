"""The PyTorch port's attention against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks:

- the plain versions of the CUDA kernels (``kernels/paged.py``) against the
  Pallas kernels run in interpret mode, every row included (kv_len == 0 rows
  are zeros in both);
- the gather references (``attention.py``) against the JAX XLA references
  (decode on active rows: both give garbage for kv_len == 0), and against
  the kernel semantics on the chunk rows the engine reads;
- ``blockwise_attention`` against JAX, with and without a padded last block;
- the kernel wrappers, the build's compiler flags and ``decode_impl``;
- the tile walk of the tensor-core chunk kernel (``paged_chunk_mma_kernel``),
  emulated in torch, against the Pallas chunk kernel: GQA rows folded, K/V
  tiles gathered row by row through the page table (a page size that does
  not divide the tile included), each row's limit, the tile-level mask skip,
  P in three bf16 terms;
- the split-KV decode walk (``paged_decode_split_kernel`` and its combine),
  emulated in torch, against the Pallas decode kernel: split edges inside a
  page and on a slot's last position, kv_len 0 and 1, n_rep 1, 2 and 4.

Tolerance 1e-5: fp32 on both sides, only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import attention as jattn
from dstack_tpu.workloads.kernels import paged as jpaged
from dstack_tpu_torch.workloads import attention as tattn
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads.kernels import build, paged

TOL = 1e-5
S, C, H, KH, D, PAGE, N, P = 4, 3, 4, 2, 16, 8, 12, 6
KV_LENS = np.array([0, 5, 17, 48], np.int32)
STARTS = np.array([0, 3, 15, 45], np.int32)  # chunk rows start at kv_len - valid


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    return {
        "q": rng.randn(S, H, D).astype(np.float32),
        "qc": rng.randn(S, C, H, D).astype(np.float32),
        "kp": rng.randn(N, PAGE, KH, D).astype(np.float32),
        "vp": rng.randn(N, PAGE, KH, D).astype(np.float32),
        "pt": rng.randint(0, N, (S, P)).astype(np.int32),
    }


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def pallas_out(inputs):
    """The Pallas kernels in interpret mode, as tests/test_kernels.py runs them."""
    x = inputs
    decode = jpaged.paged_decode_attention_pallas(
        x["q"], x["kp"], x["vp"], x["pt"], KV_LENS, interpret=True
    )
    chunk = jpaged.paged_chunk_attention_pallas(
        x["qc"], x["kp"], x["vp"], x["pt"], STARTS, KV_LENS, interpret=True
    )
    return np.asarray(decode), np.asarray(chunk)


class TestPlainVersusPallas:
    def test_decode_all_rows(self, inputs, pallas_out):
        x = inputs
        got = paged.paged_decode_attention_plain(
            t(x["q"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(KV_LENS)
        )
        np.testing.assert_allclose(got.numpy(), pallas_out[0], atol=TOL)
        assert not got[0].any(), "kv_len == 0 gives zeros, as the Pallas kernel"

    def test_chunk_all_rows(self, inputs, pallas_out):
        x = inputs
        got = paged.paged_chunk_attention_plain(
            t(x["qc"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(STARTS), t(KV_LENS)
        )
        np.testing.assert_allclose(got.numpy(), pallas_out[1], atol=TOL)
        assert not got[0].any()

    def test_decode_is_chunk_with_one_query(self, inputs):
        x = inputs
        args = (t(x["kp"]), t(x["vp"]), t(x["pt"]))
        dec = paged.paged_decode_attention_plain(t(x["q"]), *args, t(KV_LENS))
        chk = paged.paged_chunk_attention_plain(
            t(x["q"])[:, None], *args, t(KV_LENS - 1), t(KV_LENS)
        )
        assert torch.equal(dec, chk[:, 0])


class TestGatherReferences:
    def test_decode_active_rows(self, inputs):
        x = inputs
        ref = jattn.paged_decode_attention(x["q"], x["kp"], x["vp"], x["pt"], KV_LENS)
        got = tattn.paged_decode_attention(
            t(x["q"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(KV_LENS)
        )
        active = KV_LENS > 0
        np.testing.assert_allclose(got.numpy()[active], np.asarray(ref)[active], atol=TOL)
        assert torch.isfinite(got).all()

    def test_chunk_all_rows(self, inputs):
        x = inputs
        ref = np.asarray(jattn.paged_chunk_attention(x["qc"], x["kp"], x["vp"], x["pt"], STARTS))
        got = tattn.paged_chunk_attention(
            t(x["qc"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(STARTS)
        ).numpy()
        # Both mask by causality alone, so every row agrees.
        np.testing.assert_allclose(got, ref, atol=TOL)

    def test_chunk_agrees_with_the_kernel_semantics_on_valid_rows(self, inputs):
        """Rows i < valid (those the engine reads) see pos < kv_len through
        causality alone, so the gather reference and the kernels agree there."""
        x = inputs
        args = (t(x["qc"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(STARTS))
        got = tattn.paged_chunk_attention(*args).numpy()
        kernel = paged.paged_chunk_attention_plain(*args, t(KV_LENS)).numpy()
        for s, valid in enumerate(KV_LENS - STARTS):
            np.testing.assert_allclose(got[s, :valid], kernel[s, :valid], atol=TOL)


@pytest.mark.parametrize(
    "t_len,s_len,block",
    [(8, 8, 512), (20, 20, 8), (5, 13, 4)],
    ids=["one-block", "padded-blocks", "kv-longer"],
)
def test_blockwise_attention(t_len, s_len, block):
    rng = np.random.RandomState(t_len * 100 + s_len)
    q = rng.randn(2, t_len, 4, 16).astype(np.float32)
    k = rng.randn(2, s_len, 2, 16).astype(np.float32)
    v = rng.randn(2, s_len, 2, 16).astype(np.float32)
    offset = s_len - t_len
    ref = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=offset, block_size=block
    )
    got = tattn.blockwise_attention(t(q), t(k), t(v), q_offset=offset, block_size=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_path(self, inputs):
        x = inputs
        paged.reset_launches()
        dec = paged.paged_decode_attention_cuda(
            t(x["q"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(KV_LENS)
        )
        chk = paged.paged_chunk_attention_cuda(
            t(x["qc"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(STARTS), t(KV_LENS)
        )
        assert paged.launches == {"paged_decode_attention": 0, "paged_chunk_attention": 0}
        assert torch.equal(
            dec,
            paged.paged_decode_attention_plain(
                t(x["q"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(KV_LENS)
            ),
        )
        assert chk.shape == (S, C, H, D) and chk.dtype == torch.float32

    def test_cuda_decode_impl_on_cpu_raises(self):
        with pytest.raises(ValueError, match="cuda"):
            tserve.resolve_decode_impl("cuda", torch.device("cpu"))
        assert tserve.resolve_decode_impl("auto", torch.device("cpu")) == "plain"
        assert tserve.resolve_decode_impl("auto", torch.device("cuda")) == "cuda"

    def test_tensors_off_the_cpu_never_take_the_plain_path(self):
        """A tensor that is not on the CPU goes to the kernel or raises;
        here a `meta` tensor stands for one the kernel does not take."""
        q = torch.empty((S, H, D), device="meta")
        kp = torch.empty((N, PAGE, KH, D), device="meta")
        pt = torch.empty((S, P), dtype=torch.int32, device="meta")
        lens = torch.empty((S,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="CUDA device"):
            paged.paged_decode_attention_cuda(q, kp, kp, pt, lens)
        with pytest.raises(ValueError, match="CUDA device"):
            paged.paged_chunk_attention_cuda(q[:, None], kp, kp, pt, lens, lens)

    def test_build_raises_without_nvcc_or_on_a_failed_compile(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build.shutil, "which", lambda _: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_all()
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'error: no card here'\nexit 1\n")
        fake.chmod(0o755)
        monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
        with pytest.raises(RuntimeError, match="no card here"):
            build.build_all()
        assert not list((tmp_path / "out").iterdir()), "a failed build leaves no library"

    def test_nvcc_targets_sm90a(self, tmp_path):
        argv = build.nvcc_argv("nvcc", build.CSRC_DIR / "paged_attention.cu", tmp_path / "x.so")
        assert "arch=compute_90a,code=sm_90a" in argv
        assert {"-shared", "-O3", "-std=c++17"} <= set(argv)
        assert build.sources() == ["flash_attention", "paged_attention", "splash_attention"]
        lib = build.library_path("paged_attention")
        assert lib.parent == build.BUILD_DIR and lib.parent.parent.name == "build"
        assert len(lib.stem.split("-")[-1]) == 16  # the source hash


# -- the tile walk of the tensor-core chunk kernel ---------------------------
#
# csrc/paged_attention.cu's paged_chunk_mma_kernel folds the n_rep query heads
# of a KV head into its row axis (folded row r is chunk row r // n_rep, head
# kh * n_rep + r % n_rep), takes 64 folded rows a block, gathers 64-key K/V
# tiles row by row through the page table, masks only the tiles that cross
# the block's first row's limit, and multiplies P by V in three bf16 terms.
# Below, that walk in torch, with the bf16 products exact (fp64) and the sums
# in fp32; the tile edges are parameters so that the small inputs here cross
# several row and key tiles.

def split_bf16(x32: torch.Tensor, terms: int):
    """The leading bf16 terms of fp32 values; each residual is exact in fp32."""
    out, r = [], x32.clone()
    for _ in range(terms):
        t_ = r.to(torch.bfloat16).to(torch.float32)
        out.append(t_)
        r = r - t_
    return out


def chunk_tile_walk(q, k_pages, v_pages, page_table, starts, kv_lens, rows=64, keys=64,
                    terms=3):
    """fp32 [S, C, H, D] as paged_chunk_mma_kernel computes it (P in
    ``terms`` bf16 terms)."""
    s_n, c, h, d = q.shape
    _, page, kh_n, _ = k_pages.shape
    n_rep = h // kh_n
    folded = c * n_rep
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros((s_n, c, h, d), dtype=torch.float32)
    for s in range(s_n):
        kv_end = min(int(kv_lens[s]), page_table.shape[1] * page)

        def limit(r):
            return max(0, min(kv_end, int(starts[s]) + r // n_rep + 1))

        for kh in range(kh_n):
            for r0 in range(0, folded, rows):
                r = torch.arange(r0, min(r0 + rows, folded))
                ci, hi = r // n_rep, kh * n_rep + r % n_rep
                qt = q[s, ci, hi].double()
                lim = torch.tensor([limit(int(x)) for x in r])
                first, visible = limit(r0), limit(min(folded, r0 + rows) - 1)
                m = torch.full((len(r),), paged.NEG_INF)
                l = torch.zeros(len(r))
                acc = torch.zeros((len(r), d))
                for k0 in range(0, visible, keys):
                    pos = torch.arange(k0, k0 + keys)
                    live = pos < visible  # zero-filled past the last visible position
                    pid = page_table[s, torch.where(live, pos // page, 0)].long()
                    kt = torch.where(live[:, None], k_pages[pid, pos % page, kh].double(), 0.0)
                    vt = torch.where(live[:, None], v_pages[pid, pos % page, kh].double(), 0.0)
                    sc = (qt @ kt.T).float() * scale
                    if k0 + keys > first:  # only tiles that cross a row's limit compare
                        sc = torch.where(pos[None, :] < lim[:, None], sc, paged.NEG_INF)
                    m_new = torch.maximum(m, sc.amax(1))
                    safe = torch.where(m_new == paged.NEG_INF, 0.0, m_new)
                    corr = torch.where(m == paged.NEG_INF, 0.0, torch.exp(m - safe))
                    p_ = torch.exp(sc - safe[:, None])
                    l = l * corr + p_.sum(1)
                    # The tile's P V in a zeroed tile, one rounded add into acc.
                    pv = sum(t_.double() @ vt for t_ in split_bf16(p_, terms))
                    acc = acc * corr[:, None] + pv.float()
                    m = m_new
                out[s, ci, hi] = acc / torch.clamp(l, min=1e-20)[:, None]
    return out


def repage(inputs, page):
    """The same slots' K/V sequences in a shuffled pool of ``page``-row pages."""
    x = inputs
    n = -(-P * PAGE // page)
    perm = np.random.RandomState(page).permutation(S * n)
    table = perm.reshape(S, n).astype(np.int32)
    kp = np.zeros((S * n, page, KH, D), np.float32)
    vp = np.zeros_like(kp)
    for s in range(S):
        seq_k = x["kp"][x["pt"][s]].reshape(P * PAGE, KH, D)
        seq_v = x["vp"][x["pt"][s]].reshape(P * PAGE, KH, D)
        for j in range(n):
            rows = slice(j * page, min((j + 1) * page, P * PAGE))
            kp[table[s, j], : rows.stop - rows.start] = seq_k[rows]
            vp[table[s, j], : rows.stop - rows.start] = seq_v[rows]
    return kp, vp, table


@pytest.mark.parametrize("page,rows,keys", [(PAGE, 64, 64), (12, 64, 64), (PAGE, 4, 16),
                                            (12, 4, 16)])
def test_chunk_tile_walk_matches_pallas(inputs, pallas_out, page, rows, keys):
    """The tensor-core chunk kernel's walk, emulated, against the Pallas chunk
    kernel in interpret mode on every row (kv_len == 0 rows zero); page 12
    does not divide a key tile, so tiles gather across page boundaries."""
    x = inputs
    kp, vp, table = (x["kp"], x["vp"], x["pt"]) if page == PAGE else repage(x, page)
    got = chunk_tile_walk(t(x["qc"]), t(kp), t(vp), t(table), t(STARTS), t(KV_LENS), rows, keys)
    np.testing.assert_allclose(got.numpy(), pallas_out[1], atol=TOL)
    assert not got[0].any()


def test_one_bf16_term_of_p_is_not_enough(inputs, pallas_out):
    """The split is what holds the walk to fp32: with P rounded to one bf16
    term the emulated walk misses the Pallas kernel by far more than 1e-5."""
    x = inputs
    got = chunk_tile_walk(t(x["qc"]), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(STARTS), t(KV_LENS),
                          terms=1)
    assert np.abs(got.numpy() - pallas_out[1]).max() > 10 * TOL


# -- the split-KV decode walk --------------------------------------------------
#
# csrc/paged_attention.cu's paged_decode_split_kernel gives each block one
# split of `split` positions of a (slot, KV head) and all n_rep query heads
# of that KV head; it gathers K/V tiles of `tile` positions row by row
# through the page table (zero past the split's end), runs the online softmax
# over them in fp32 and writes the split's unnormalised o and its (max, sum)
# per head; splits that start at or past the slot's end write nothing.
# paged_decode_combine_kernel joins the splits as one online softmax would.
# Below, that walk in torch, at the card's tile and split (32, 256) and at
# edges that fall inside pages, against the Pallas decode kernel.

# name -> (H, kv_lens): n_rep 1 and 4 over the module's two KV heads; kv_len
# 0 and 1, and lengths that end on the split edges below (24, 48 = P * PAGE).
DECODE_CASES = {
    "n_rep1": (2, np.array([1, 0, 48, 24], np.int32)),
    "n_rep4": (8, np.array([24, 48, 0, 1], np.int32)),
}


def decode_split_walk(q, k_pages, v_pages, page_table, kv_lens, split, tile=32):
    """fp32 [S, H, D] as paged_decode_split_kernel and
    paged_decode_combine_kernel compute it."""
    s_n, h, d = q.shape
    _, page, kh_n, _ = k_pages.shape
    n_rep = h // kh_n
    scale = np.float32(1.0 / np.sqrt(d))
    out = torch.zeros((s_n, h, d))
    for s in range(s_n):
        end = min(int(kv_lens[s]), page_table.shape[1] * page)
        for kh in range(kh_n):
            heads = slice(kh * n_rep, (kh + 1) * n_rep)
            qh = q[s, heads].float()
            parts = []  # (o, m, l) of each split that starts before `end`
            for s0 in range(0, end, split):
                s1 = min(end, s0 + split)
                m = torch.full((n_rep,), paged.NEG_INF)
                l = torch.zeros(n_rep)
                acc = torch.zeros((n_rep, d))
                for t0 in range(s0, s1, tile):
                    pos = torch.arange(t0, t0 + tile)
                    live = pos < s1  # zero-filled past the split's end
                    pid = page_table[s, torch.where(live, pos // page, 0)].long()
                    kt = torch.where(live[:, None], k_pages[pid, pos % page, kh].float(), 0.0)
                    vt = torch.where(live[:, None], v_pages[pid, pos % page, kh].float(), 0.0)
                    sc = torch.where(live[None], (qh @ kt.T) * scale, paged.NEG_INF)
                    m_new = torch.maximum(m, sc.amax(1))
                    safe = torch.where(m_new == paged.NEG_INF, 0.0, m_new)
                    corr = torch.where(m == paged.NEG_INF, 0.0, torch.exp(m - safe))
                    p_ = torch.where(live[None], torch.exp(sc - safe[:, None]), 0.0)
                    l = l * corr + p_.sum(1)
                    acc = acc * corr[:, None] + p_ @ vt
                    m = m_new
                parts.append((acc, m, l))
            if parts:  # kv_len 0: no split wrote, the output stays zero
                m_all = torch.stack([m for _, m, _ in parts]).amax(0)
                w = [torch.exp(m - m_all) for _, m, _ in parts]
                l_all = sum(l * w_ for (_, _, l), w_ in zip(parts, w))
                o = sum(o * w_[:, None] for (o, _, _), w_ in zip(parts, w))
                out[s, heads] = o / torch.clamp(l_all, min=1e-20)[:, None]
    return out


@pytest.fixture(scope="module")
def pallas_decode_cases(inputs):
    """Per DECODE_CASES entry: q, its kv_lens and the Pallas decode kernel's
    output (interpret mode) on the module's pages and table."""
    x = inputs
    rng = np.random.RandomState(1)
    out = {}
    for name, (h, lens) in DECODE_CASES.items():
        q = rng.randn(S, h, D).astype(np.float32)
        ref = jpaged.paged_decode_attention_pallas(q, x["kp"], x["vp"], x["pt"], lens,
                                                   interpret=True)
        out[name] = (q, lens, np.asarray(ref))
    return out


# (page, tile, split): split edges inside a page (12 over pages of 8; 8 and 32
# over pages of 12), a split of one page's rows, and the card's tile and split.
SPLIT_WALKS = [(PAGE, 4, 12), (12, 4, 8), (12, 32, 32), (PAGE, 8, 8), (PAGE, 32, 256)]


@pytest.mark.parametrize("page,tile,split", SPLIT_WALKS)
@pytest.mark.parametrize("case", ["n_rep1", "n_rep2", "n_rep4"])
def test_decode_split_walk_matches_pallas(inputs, pallas_out, pallas_decode_cases, case, page,
                                          tile, split):
    """The split-KV decode walk, emulated, against the Pallas decode kernel in
    interpret mode: active rows within 1e-5 (fp32 on both sides, the splits
    change only the order of the sums), rows of kv_len 0 zero."""
    x = inputs
    if case == "n_rep2":
        q, lens, ref = x["q"], KV_LENS, pallas_out[0]
    else:
        q, lens, ref = pallas_decode_cases[case]
    kp, vp, table = (x["kp"], x["vp"], x["pt"]) if page == PAGE else repage(x, page)
    got = decode_split_walk(t(q), t(kp), t(vp), t(table), t(lens), split, tile).numpy()
    active = lens > 0
    np.testing.assert_allclose(got[active], ref[active], atol=TOL)
    assert not got[~active].any()


def test_a_dropped_split_misses_the_pallas_kernel(inputs, pallas_decode_cases):
    """The combine must take every split that starts before kv_len: with the
    last split of each slot left out, the emulated walk misses the Pallas
    kernel by far more than 1e-5."""
    x = inputs
    q, lens, ref = pallas_decode_cases["n_rep4"]
    cut = np.where(lens > 0, (lens - 1) // 12 * 12, 0).astype(np.int32)
    got = decode_split_walk(t(q), t(x["kp"]), t(x["vp"]), t(x["pt"]), t(cut), 12, 4).numpy()
    active = lens > 0
    assert np.abs(got[active] - ref[active]).max() > 10 * TOL


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """On an sm_90 card: each kernel against its plain version, bf16 and fp32,
    at llama3_8b head geometry (D 128, n_rep 4), and decode at n_rep 1 and
    2 and D 96 too; the bf16 chunk launch runs the tensor-core kernel, every
    decode launch the split-KV kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90) and nvcc")
    assert paged.instantiation("paged_chunk_attention", torch.bfloat16, 128).startswith(
        "bf16 tensor cores")
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 128), (torch.bfloat16, 96)):
        desc = paged.instantiation("paged_decode_attention", dtype, d)
        assert "paged_decode_split_kernel" in desc
    assert paged.instantiation("paged_chunk_attention", torch.float32, 128).startswith("CUDA cores")
    rng = np.random.RandomState(3)
    h, kh, d = 32, 8, 128
    x = {
        "q": t(rng.randn(S, h, d).astype(np.float32)).cuda(),
        "qc": t(rng.randn(S, C, h, d).astype(np.float32)).cuda(),
        "kp": t(rng.randn(N, PAGE, kh, d).astype(np.float32)).cuda(),
        "vp": t(rng.randn(N, PAGE, kh, d).astype(np.float32)).cuda(),
        "pt": t(rng.randint(0, N, (S, P)).astype(np.int32)).cuda(),
    }
    lens, starts = t(KV_LENS).cuda(), t(STARTS).cuda()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-4)):
        q, qc, kp, vp = (x[k].to(dtype) for k in ("q", "qc", "kp", "vp"))
        got = paged.paged_decode_attention_cuda(q, kp, vp, x["pt"], lens)
        ref = paged.paged_decode_attention_plain(q, kp, vp, x["pt"], lens)
        torch.testing.assert_close(got, ref, atol=tol, rtol=1e-3)
        got = paged.paged_chunk_attention_cuda(qc, kp, vp, x["pt"], starts, lens)
        ref = paged.paged_chunk_attention_plain(qc, kp, vp, x["pt"], starts, lens)
        torch.testing.assert_close(got, ref, atol=tol, rtol=1e-3)
    for h, kh, d in ((8, 8, 128), (16, 8, 128), (32, 8, 96)):
        q = torch.randn((S, h, d), device="cuda", dtype=torch.bfloat16)
        kp, vp = (torch.randn((N, PAGE, kh, d), device="cuda", dtype=torch.bfloat16)
                  for _ in range(2))
        got = paged.paged_decode_attention_cuda(q, kp, vp, x["pt"], lens)
        ref = paged.paged_decode_attention_plain(q, kp, vp, x["pt"], lens)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-3)
