"""The PyTorch port's weight-only quantization against the JAX package, on
the CPU.

The same seeded numpy weights go through ``dstack_tpu.workloads.quantize``
and ``dstack_tpu_torch.workloads.quantize``: int8 values must be equal as
int8, fp8 values equal bit for bit (compared through uint8 views), and the
fp32 scales exactly equal. ``weight_only_matmul`` agrees with JAX's within
atol 1e-5 / rtol 1e-5 (both sum exact products in fp32, in different
orders). The serve layout (``quantize_serve_params``) has the JAX keys and
dtypes, and ``convert.params_from_numpy`` carries a JAX-quantized tree
across unchanged.
"""

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
    import jax

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
