"""The PyTorch port's quantization against the JAX package, on the CPU.

The same seeded numpy weights go through ``dstack_tpu.workloads.quantize``
and ``dstack_tpu_torch.workloads.quantize``: int8 values must be equal as
int8, fp8 values equal bit for bit (compared through uint8 views), and the
fp32 scales exactly equal. ``weight_only_matmul`` agrees with JAX's within
atol 1e-5 / rtol 1e-5 (both sum exact products in fp32, in different
orders). The serve layout (``quantize_serve_params``) has the JAX keys and
dtypes, and ``convert.params_from_numpy`` carries a JAX-quantized tree
across unchanged.

Training's half: ``int8_matmul`` bit-equal to JAX's (exact int32 sums),
``fp8_matmul`` within 1e-6 of the largest output (the same exact products
summed in another order), the straight-through gradients exactly the fp32
gradients of ``x @ w``, the lm_head under int8 and fp8 as JAX's forward has
it, and three quantized train steps against JAX's ``make_train_step``
(within QUANT_STEP_RTOL, for the reason given there).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import quantize as jq
from dstack_tpu.workloads import serve as jserve
from dstack_tpu_torch.workloads import quantize as tq
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads.convert import params_from_numpy

TINY_KW = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=251, max_seq_len=128, dtype="float32", param_dtype="float32",
    remat=False,
)

# A stacked [L, K, N] weight with one all-zero output channel (scale 1) and
# one channel of ties at .5 after scaling (round half to even).
SHAPE = (2, 48, 40)


def weight(dtype: str = "float32") -> np.ndarray:
    w = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    w[:, :, 3] = 0.0
    w[0, :, 5] = np.arange(48) - 23.5  # absmax 23.5: w / scale hits .5 steps
    return w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w


def as_torch(a: np.ndarray) -> torch.Tensor:
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    return params_from_numpy({"w": a}, torch.device("cpu"), dtype)["w"]


def dtype_name(values) -> str:
    if isinstance(values, torch.Tensor):
        return str(values.dtype).removeprefix("torch.")
    return np.asarray(values).dtype.name


def bits(values) -> np.ndarray:
    """int8 values as they are; fp8 values as their uint8 bits."""
    if isinstance(values, torch.Tensor):
        if values.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return values.view(torch.uint8).numpy()
        return values.numpy()
    a = np.asarray(values)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "fn", ["int8", "fp8-e4m3", "fp8-e5m2", "weight-int8", "weight-fp8", "weight-axis0"]
)
def test_quantized_values_are_bit_equal_to_jax(fn, dtype):
    w = weight(dtype)
    jw, tw = jnp.asarray(w), as_torch(w)
    if fn == "int8":
        ref, got = jq.quantize_int8(jw, axis=-2), tq.quantize_int8(tw, axis=-2)
    elif fn.startswith("fp8-"):
        fmt = fn[4:]
        ref, got = jq.quantize_fp8(jw, -2, fmt), tq.quantize_fp8(tw, -2, fmt)
    elif fn == "weight-axis0":
        ref, got = jq.quantize_weight(jw, axis=0), tq.quantize_weight(tw, axis=0)
    else:
        mode = fn[len("weight-"):]
        ref, got = jq.quantize_weight(jw, mode=mode), tq.quantize_weight(tw, mode=mode)
    (ref_v, ref_s), (got_v, got_s) = ref, got
    assert dtype_name(got_v) == dtype_name(ref_v)
    np.testing.assert_array_equal(bits(got_v), bits(ref_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(
        tq.dequantize(got_v, got_s).numpy(), np.asarray(jq.dequantize(ref_v, ref_s))
    )


def test_scales_of_a_zero_channel_are_one_and_the_tables_match():
    _, scales = tq.quantize_int8(as_torch(weight()), axis=-2)
    assert torch.all(scales[:, :, 3] == 1.0)
    assert tq.QUANT_MODES == jq.QUANT_MODES
    assert tq.WEIGHT_ONLY_MODES == jq.WEIGHT_ONLY_MODES
    assert tq.FP8_MAX == jq.FP8_MAX and tq.INT8_MAX == jq.INT8_MAX
    assert tq.FP8_DEFAULT_FORMAT == jq.FP8_DEFAULT_FORMAT
    for fmt, dtype in tq.FP8_DTYPES.items():
        assert torch.finfo(dtype).max == float(jnp.finfo(jq.FP8_DTYPES[fmt]).max)
    assert all(tq.is_weight_only(m) == jq.is_weight_only(m) for m in tq.QUANT_MODES)
    with pytest.raises(ValueError, match="unknown quant mode"):
        tq.check_quant("int4")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_weight_only_matmul_matches_jax(mode, x_dtype):
    rng = np.random.RandomState(1)
    w = rng.randn(64, 40).astype(np.float32)
    x = rng.randn(3, 5, 64).astype(np.float32)
    if x_dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    jv, js = jq.quantize_weight(jnp.asarray(w), mode=mode)
    tv, ts = tq.quantize_weight(torch.from_numpy(w), mode=mode)
    ref = np.asarray(jq.weight_only_matmul(jnp.asarray(x), jv, js))
    got = tq.weight_only_matmul(as_torch(x), tv, ts)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 40)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def trees():
    """A small model's JAX init_params tree, as numpy arrays."""
    from dstack_tpu.workloads import model as jmodel
    from dstack_tpu.workloads.config import get_config

    params = jmodel.init_params(get_config("test", **TINY_KW), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_serve_layout_matches_jax_and_converts_unchanged(mode, trees):
    ref = jserve.quantize_serve_params({k: jnp.asarray(v) for k, v in trees.items()}, mode=mode)
    fp = params_from_numpy(trees, torch.device("cpu"), torch.float32)
    got = tserve.quantize_serve_params(dict(fp), mode=mode)
    assert list(got) == list(ref)
    # The JAX-quantized tree, carried across by convert, equals the port's.
    carried = params_from_numpy(
        {k: np.asarray(v) for k, v in ref.items()}, torch.device("cpu"), torch.float32
    )
    for key in ref:
        assert got[key].dtype == carried[key].dtype, key
        assert dtype_name(got[key]) == dtype_name(ref[key]), key
        np.testing.assert_array_equal(bits(got[key]), bits(ref[key]), err_msg=key)
        np.testing.assert_array_equal(bits(carried[key]), bits(got[key]), err_msg=key)
    assert tserve._serve_layer_keys(mode) == jserve._serve_layer_keys(mode)
    assert tserve._serve_layer_keys("none") == jserve._serve_layer_keys("none")


def test_consume_drains_the_input_tree(trees):
    fp = params_from_numpy(trees, torch.device("cpu"), torch.float32)
    out = tserve.quantize_serve_params(fp, consume=True, mode="fp8")
    assert fp == {} and "lm_head_q" in out and "lm_head" not in out


def test_engine_takes_a_quantized_tree_as_it_quantizes_its_own(trees):
    from dstack_tpu_torch.workloads.config import get_config

    cfg = get_config("test", **TINY_KW)
    ecfg = tserve.EngineConfig(page_size=8, num_pages=32, max_batch=4, max_seq=128, quant="fp8")
    fp = params_from_numpy(trees, torch.device("cpu"), torch.float32)
    pre = params_from_numpy(
        {k: np.asarray(v) for k, v in jserve.quantize_serve_params(
            {k: jnp.asarray(v) for k, v in trees.items()}, mode="fp8").items()},
        torch.device("cpu"), torch.float32,
    )
    streams = []
    for params in (fp, pre):
        engine = tserve.ServeEngine(cfg, ecfg, params=params, device="cpu")
        assert "lm_head" not in engine.params
        assert engine.params["wq_q"].dtype == torch.float8_e4m3fn
        reqs = [engine.submit(p, max_new_tokens=6) for p in ([1, 2, 3], [9, 8, 7, 6])]
        while engine.has_work():
            engine.step()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]
    assert "lm_head" in fp, "the engine does not consume the caller's tree"


# -- training's quantized projections (straight-through) ---------------------------


def operands(x_dtype="float32", seed=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = (rng.randn(64, 40) / 8).astype(np.float32)
    if x_dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return x, w


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_int8_matmul_is_bit_equal_to_jax(x_dtype):
    """Exact int32 sums on both sides, then the same fp32 scale products."""
    x, w = operands(x_dtype)
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tq.int8_matmul(as_torch(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (3, 5, 40)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_fp8_matmul_matches_jax_within_its_tolerance(x_dtype):
    """Bit-equal fp8 operands and scales; the exact products are summed in
    fp32 in another order, so the outputs agree within 1e-6 of the largest
    |output|."""
    x, w = operands(x_dtype)
    ref = np.asarray(jq.fp8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tq.fp8_matmul(as_torch(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_ste_grads_are_exactly_the_fp_grads(mode):
    """The backward of the quantized product is the fp32 backward of x @ w
    against the original operands, in their dtypes; and JAX's within 1e-6."""
    x, w = operands()
    g = np.random.RandomState(7).randn(3, 5, 40).astype(np.float32)
    ste = {"int8": tq.int8_matmul_ste, "fp8": tq.fp8_matmul_ste}[mode]
    grads = {}
    for name, fn in (("ste", ste), ("fp", lambda a, b: a @ b)):
        tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
        fn(tx, tw).backward(torch.from_numpy(g))
        grads[name] = (tx.grad.numpy(), tw.grad.numpy())
    for got, want in zip(grads["ste"], grads["fp"]):
        np.testing.assert_array_equal(got, want)
    jste = {"int8": jq.int8_matmul_ste, "fp8": jq.fp8_matmul_ste}[mode]
    _, vjp = jax.vjp(jste, jnp.asarray(x), jnp.asarray(w))
    for got, want in zip(grads["ste"], vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def quant_trees():
    from dstack_tpu.workloads import model as jmodel
    from dstack_tpu.workloads.config import get_config

    params = jmodel.init_params(get_config("test", **TINY_KW), jax.random.PRNGKey(1))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_lm_head_follows_jax_under_each_quant_mode(quant, quant_trees):
    """The forward's logits against JAX's (1e-5): under int8 the lm_head is
    the quantized product of the final hidden state, under fp8 it stays the
    fp product."""
    from dstack_tpu.workloads import model as jmodel
    from dstack_tpu.workloads.config import get_config as jget
    from dstack_tpu_torch.workloads import model as tmodel
    from dstack_tpu_torch.workloads.config import get_config as tget

    jcfg, tcfg = jget("test", quant=quant, **TINY_KW), tget("test", quant=quant, **TINY_KW)
    tokens = np.random.RandomState(8).randint(0, 251, (2, 12)).astype(np.int32)
    params = params_from_numpy(quant_trees, torch.device("cpu"), torch.float32)
    ref = np.asarray(jmodel.forward({k: jnp.asarray(v) for k, v in quant_trees.items()},
                                    jnp.asarray(tokens), jcfg))
    logits = tmodel.forward(params, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-5)
    hidden = tmodel.forward(params, torch.from_numpy(tokens), tcfg, return_hidden=True)
    head = (tq.int8_matmul(hidden, params["lm_head"]) if quant == "int8"
            else hidden @ params["lm_head"])
    np.testing.assert_array_equal(logits.numpy(), head.numpy())


# Quantized train steps against JAX: relative tolerance of losses and grad
# norms. The two sides' fp32 roundings differ by ~1e-7 (summation order);
# an activation or weight that close to an int8 or e4m3 rounding boundary
# quantizes to the next grid value on one side only (one step of 1/127 of
# its row's absmax, or 2^-3 of itself), which moves the loss by ~1e-4.
QUANT_STEP_RTOL = 1e-3


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_train_steps_match_jax(quant, quant_trees):
    """3 updates under --quant against JAX's make_train_step from the same
    parameters and batches: loss and unclipped grad norm at every step
    within QUANT_STEP_RTOL."""
    from dstack_tpu.workloads import train as jtrain
    from dstack_tpu.workloads.config import get_config as jget
    from dstack_tpu_torch.workloads import train as ttrain
    from dstack_tpu_torch.workloads.config import get_config as tget

    jcfg, tcfg = jget("test", quant=quant, **TINY_KW), tget("test", quant=quant, **TINY_KW)
    jparams = {k: jnp.array(v) for k, v in quant_trees.items()}
    jstate = jtrain.TrainState(jparams, jtrain.make_optimizer().init(jparams),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.make_train_step(jcfg, jtrain.make_optimizer())
    optimizer = ttrain.make_optimizer()
    state = ttrain.init_train_state(
        tcfg, optimizer, params=params_from_numpy(quant_trees, torch.device("cpu"), torch.float32))
    step = ttrain.make_train_step(tcfg, optimizer)
    for i in range(3):
        tokens = np.random.RandomState(30 + i).randint(0, 251, (2, 16)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        jstate, jm = jstep(jstate, tokens, targets)
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=QUANT_STEP_RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=QUANT_STEP_RTOL)
        assert m["step"] == int(jm["step"]) == i + 1
