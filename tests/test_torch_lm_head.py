"""The training lm_head's product (``model.LmHeadProduct``), on the CPU and
on the card.

- ``split_bf16``: the three bf16 planes of an fp32 cotangent sum back to it
  exactly (an fp64 sum), down to the size ``(p - onehot) / count`` takes at
  32768 tokens;
- the chunked and the unchunked loss's gradients of ``x`` and ``lm_head``
  through the Function and through the upcast product ``x.float() @
  lm_head.float()`` it replaced: each is the bf16 rounding of a value within
  1e-6 (of the largest entry) of the fp64 gradient, and a backward that
  drops the two low planes is not;
- ``fp32_runs_product``: a reduction cut into runs of at most ``K_RUN``
  covers every index of K once, at lengths that do and do not divide;
- ``LmHeadProduct.products``: bf16 operands move it by the products taken,
  fp32 operands leave it alone;
- on an sm_90 card, at the training cell's chunk (M 1024, D 4096, V 32000):
  the forward logits and the fp32 dX and dW before their casts (each
  reduction in runs of at most ``K_RUN``) against fp64
  sums of the same bf16 operands and fp32 cotangent, beside the upcast fp32
  product's errors, and the time of one chunk's forward and backward on
  either path (CUDA events).

No JAX here: the Function's CPU path is the upcast product the JAX-parity
tests (test_torch_model, test_torch_moe, test_torch_pipeline) already hold.
"""

import numpy as np
import pytest
import torch

from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads.config import get_config

CPU = torch.device("cpu")
TINY_KW = dict(
    n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=251,
    max_seq_len=64, dtype="bfloat16", param_dtype="float32", remat=False,
)
# How far, as a share of the largest entry, the fp32 gradients before their
# casts may lie from the fp64 gradient.
GRAD_TOL = 1e-6


def cotangent(rows: int, vocab: int, count: int, seed: int, spread: float) -> torch.Tensor:
    """fp32 ``(softmax(logits) - onehot(targets)) / count``: the cotangent
    of a mean cross-entropy's logits over ``count`` tokens."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn(rows, vocab, generator=gen) * spread
    targets = torch.randint(0, vocab, (rows,), generator=gen)
    p = torch.softmax(logits, -1)
    return (p - torch.nn.functional.one_hot(targets, vocab)) / count


def split_cases():
    gen = torch.Generator().manual_seed(3)
    # fp32 values of every significand, signs and exponents 2^-100..2^100.
    bits = torch.randint(0, 2 ** 23, (64, 96), generator=gen, dtype=torch.int32)
    exps = torch.randint(27, 228, (64, 96), generator=gen, dtype=torch.int32)
    signs = torch.randint(0, 2, (64, 96), generator=gen, dtype=torch.int32)
    wide = ((signs << 31) | (exps << 23) | bits).view(torch.float32)
    wide[0, :8] = 0.0
    return {
        "normal": torch.randn(64, 96, generator=gen),
        "wide": wide,
        "ce_32768_tokens": cotangent(64, 32000, 32768, 4, 4.0),
    }


@pytest.mark.parametrize("case", ["normal", "wide", "ce_32768_tokens"])
def test_split_bf16_sums_back_exactly(case):
    g = split_cases()[case]
    terms = tmodel.split_bf16(g)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3 * g.shape[0], g.shape[1])
    planes = terms.double().view(3, *g.shape)
    assert torch.equal(planes.sum(0), g.double())
    if case == "ce_32768_tokens":
        tiny = g.abs()[g != 0].min().item()
        assert tiny < 1e-12, "the case reaches the far tail of the softmax"
        # the low planes carry what one bf16 rounding loses
        assert planes[2].abs().max() > 0 and not torch.equal(planes[0], g.double())


def bf16_bracket_holds(got: torch.Tensor, ref: torch.Tensor, tol: float) -> bool:
    """Whether bf16 ``got`` is the bf16 rounding of some value within
    ``tol * max|ref|`` of fp64 ``ref``: rounding is monotone, so it lies
    between the roundings of the ends."""
    t = tol * ref.abs().max().item()
    lo = (ref - t).float().bfloat16()
    hi = (ref + t).float().bfloat16()
    return bool(((got >= lo) & (got <= hi)).all())


def bf16_sum_bracket_holds(got: torch.Tensor, refs: list, tol: float) -> bool:
    """As ``bf16_bracket_holds`` for a bf16 sum of the bf16 roundings of
    values within ``tol`` (of the largest entry) of each fp64 ``refs[i]``,
    summed first to last or last to first: every rounding and every bf16
    addition is monotone, so the sum lies between those of the ends. The
    chunked loss sums each chunk's bf16 dW so."""
    t = tol * max(r.abs().max().item() for r in refs)
    ends = []
    for shift in (-t, t):
        for order in (refs, refs[::-1]):
            acc = None
            for r in order:
                term = (r + shift).float().bfloat16()
                acc = term if acc is None else acc + term
            ends.append(acc)
    lo = torch.minimum(ends[0], ends[1])
    hi = torch.maximum(ends[2], ends[3])
    return bool(((got >= lo) & (got <= hi)).all())


def chunked_loss(x, lm_head, targets, chunk):
    if chunk:
        total, count = tmodel._chunked_nll(x, lm_head, targets, chunk)
    else:
        total, count = tmodel._nll_sum(tmodel._logits(x, lm_head, "none"), targets)
    return total / count


def loss_grads(x, lm_head, targets, chunk):
    x, lm_head = (t.detach().requires_grad_(True) for t in (x, lm_head))
    return torch.autograd.grad(chunked_loss(x, lm_head, targets, chunk), (x, lm_head))


def fp64_grads(x, lm_head, targets, chunk):
    """The fp64 dX of the whole loss, and the fp64 dW of each chunk's part
    of it (one part when ``chunk`` is 0)."""
    x, lm_head = (t.detach().double().requires_grad_(True) for t in (x, lm_head))
    count = (targets >= 0).sum()
    parts = []
    for c0 in range(0, x.shape[1], chunk or x.shape[1]):
        c1 = c0 + (chunk or x.shape[1])
        total, _ = tmodel._nll_sum(x[:, c0:c1] @ lm_head, targets[:, c0:c1])
        parts.append(total / count)
    dws = [torch.autograd.grad(part, lm_head, retain_graph=True)[0] for part in parts]
    return torch.autograd.grad(sum(parts), x)[0], dws


def grads_hold(grads, dx_ref, dw_refs) -> bool:
    return (bf16_bracket_holds(grads[0], dx_ref, GRAD_TOL)
            and bf16_sum_bracket_holds(grads[1], dw_refs, GRAD_TOL))


@pytest.mark.parametrize("chunk", [0, 8])
def test_loss_gradients_match_the_upcast_product(chunk, monkeypatch):
    """dX and dW through the Function and through the upcast product are
    each the bf16 rounding (dW at loss_chunk 8: the bf16 sum of the four
    chunks' roundings) of values within 1e-6 of the fp64 gradients."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 32, 64, generator=gen).bfloat16()
    lm_head = (torch.randn(64, 251, generator=gen) / 8).bfloat16()
    targets = torch.randint(0, 251, (2, 32), generator=gen)
    targets[0, :5] = -1
    dx_ref, dw_refs = fp64_grads(x, lm_head, targets, chunk)

    before = tmodel.LmHeadProduct.products
    new = loss_grads(x, lm_head, targets, chunk)
    assert tmodel.LmHeadProduct.products > before
    assert all(g.dtype == torch.bfloat16 for g in new)
    assert grads_hold(new, dx_ref, dw_refs)
    with monkeypatch.context() as m:
        m.setattr(tmodel, "_logits", lambda a, w, quant: a.float() @ w.float())
        assert grads_hold(loss_grads(x, lm_head, targets, chunk), dx_ref, dw_refs)

    # A backward that keeps only the hi plane lies far outside the limit.
    split = tmodel.split_bf16

    def hi_only(g):
        terms = split(g)
        terms.view(3, -1, g.shape[-1])[1:] = 0
        return terms

    with monkeypatch.context() as m:
        m.setattr(tmodel, "split_bf16", hi_only)
        assert not grads_hold(loss_grads(x, lm_head, targets, chunk), dx_ref, dw_refs)


@pytest.mark.parametrize("k", [251, 2048, 3072, 32000, 32001])
def test_runs_cover_the_whole_reduction(k):
    gen = torch.Generator().manual_seed(k)
    a = torch.randn(6, k, generator=gen).bfloat16()
    b = torch.randn(k, 5, generator=gen).bfloat16()
    got = tmodel.fp32_runs_product(a, b)
    ref = a.double() @ b.double()
    assert got.dtype == torch.float32
    assert ((got.double() - ref).abs().max() / ref.abs().max()).item() < GRAD_TOL
    # the runs' edges: one index of K dropped is far off
    b_cut = b.clone()
    b_cut[-1] = 0
    assert not torch.allclose(tmodel.fp32_runs_product(a, b_cut).double(), ref,
                              rtol=0, atol=GRAD_TOL * ref.abs().max().item())


@pytest.mark.parametrize("dtype,chunk,taken", [
    ("float32", 8, 0), ("float32", 0, 0),
    # chunks x (forward, recompute, dX, dW); unchunked: forward, dX, dW
    ("bfloat16", 8, 4 * 4), ("bfloat16", 0, 3),
])
def test_products_count_the_bf16_path_only(dtype, chunk, taken):
    cfg = get_config("test", **{**TINY_KW, "dtype": dtype, "loss_chunk": chunk})
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    for v in params.values():
        v.requires_grad_(True)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 32)))
    before = tmodel.LmHeadProduct.products
    tmodel.loss_fn(params, tokens, tokens, cfg).backward()
    assert tmodel.LmHeadProduct.products - before == taken
    assert params["lm_head"].grad.abs().sum() > 0


def card_line() -> str:
    import subprocess

    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "power limit unread"
    return f"{torch.cuda.get_device_name(0)}, {limit}, torch {torch.__version__}"


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.cuda
def test_lm_head_on_the_card():
    """At the training cell's chunk (2 x 512 rows of Mistral-7B's D 4096 and
    V 32000): the tensor-core forward and the fp32 dX and dW of the split
    backward, each reduction in runs of at most K_RUN, within 1e-5 of the largest entry of fp64 sums of the same bf16
    operands and fp32 cotangent (the upcast fp32 product's errors printed
    beside them), the Function's bf16 dX and dW the roundings of those, and
    the time of one chunk's forward and backward on each path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    m, d, v = 1024, 4096, 32000
    x = torch.randn(2, m // 2, d, generator=gen, device=dev).bfloat16()
    w = (torch.randn(d, v, generator=gen, device=dev) / d ** 0.5).bfloat16()
    g = cotangent(m, v, 32768, 8, 4.0).to(dev).view(2, m // 2, v)
    x2, g2 = x.view(m, d), g.view(m, v)

    ref_logits = x2.double() @ w.double()
    ref_dx = g2.double() @ w.double().t()
    ref_dw = x2.double().t() @ g2.double()
    terms = tmodel.split_bf16(g2)
    new = {
        "logits": tmodel.LmHeadProduct.apply(x, w).view(m, v),
        "dx": tmodel.lm_head_dx(terms, w),
        "dw": tmodel.lm_head_dw(x2, terms),
    }
    old = {
        "logits": x2.float() @ w.float(),
        "dx": g2 @ w.float().t(),
        "dw": x2.float().t() @ g2,
    }
    refs = {"logits": ref_logits, "dx": ref_dx, "dw": ref_dw}
    errs = {name: (rel_err(new[name], refs[name]), rel_err(old[name], refs[name]))
            for name in refs}
    del ref_logits

    xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    before = tmodel.LmHeadProduct.products
    tmodel.LmHeadProduct.apply(xl, wl).backward(g)
    taken = tmodel.LmHeadProduct.products - before
    assert xl.grad.dtype == wl.grad.dtype == torch.bfloat16
    rounded = [bf16_bracket_holds(got, ref, 1e-5)
               for got, ref in ((xl.grad.view(m, d), ref_dx), (wl.grad, ref_dw))]
    del ref_dx, ref_dw, refs

    def run_new():
        xl.grad = wl.grad = None
        tmodel.LmHeadProduct.apply(xl, wl).backward(g)

    def run_old():
        xl.grad = wl.grad = None
        (xl.float() @ wl.float()).backward(g)

    times = {}
    for name, fn in (("upcast", run_old), ("split", run_new), ("split ", run_new),
                     ("upcast ", run_old)):
        times.setdefault(name.strip(), []).append(events_ms(fn))
    print(f"\nlm_head chunk M {m} D {d} V {v} [{card_line()}]")
    for name, (new_err, old_err) in errs.items():
        print(f"  {name}: max |err| / max |fp64| tensor cores {new_err:.3e}, "
              f"upcast fp32 {old_err:.3e}")
    for name, ms in times.items():
        print(f"  fwd+bwd {name}: " + " / ".join(f"{t:.4f}" for t in ms) + " ms")
    print(f"  products taken by one forward and backward: {taken}")
    for name, (new_err, _) in errs.items():
        assert new_err < 1e-5, (name, new_err)
    assert taken == 3 and all(rounded), (taken, rounded)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,taken", [("bfloat16", 4 * 4), ("float32", 0)])
def test_train_step_takes_the_product_on_the_card(dtype, taken):
    """One optimizer step of the training step on the card (the test preset,
    loss_chunk 8 over 32 tokens): bf16 operands take the Function's
    products, fp32 ones none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90)")
    from dstack_tpu_torch.workloads import train

    dev = torch.device("cuda")
    cfg = get_config("test", **{**TINY_KW, "dtype": dtype, "loss_chunk": 8,
                                "attn_impl": "blockwise"})
    optimizer = train.make_optimizer(mu_dtype="bfloat16")
    state = train.init_train_state(cfg, optimizer, dev)
    step = train.make_train_step(cfg, optimizer)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 32))).to(dev)
    before = tmodel.LmHeadProduct.products
    state, metrics = step(state, tokens, tokens)
    assert tmodel.LmHeadProduct.products - before == taken
    assert torch.isfinite(metrics["loss"]) and state.step == 1
