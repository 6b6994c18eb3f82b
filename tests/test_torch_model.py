"""The PyTorch port's model against the JAX package, on the CPU.

The JAX ``init_params`` tree goes through ``convert.params_from_numpy`` into
the port; both forwards then see the same weights and tokens. fp32 on both
sides: logits agree to 1e-4 (summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy

TINY_KW = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=251, max_seq_len=128, dtype="float32", param_dtype="float32",
    remat=False,
)
JTINY = jget_config("test", **TINY_KW)
TTINY = tget_config("test", **TINY_KW)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jmodel.init_params(JTINY, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(
        {k: np.asarray(v) for k, v in jax_params.items()}, CPU, torch.float32
    )


def test_forward_logits_match_jax(jax_params, torch_params):
    tokens = np.random.RandomState(0).randint(0, JTINY.vocab_size, (2, 24)).astype(np.int32)
    ref = np.asarray(jmodel.forward(jax_params, jnp.asarray(tokens), JTINY))
    got = tmodel.forward(torch_params, torch.from_numpy(tokens), TTINY)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("offset", [0, 1000])
def test_rope_and_rms_norm_match_jax(offset):
    rng = np.random.RandomState(offset)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    pos = np.arange(5) + offset
    ref = jmodel._rope(jnp.asarray(x), jnp.asarray(pos), TTINY.rope_theta)
    got = tmodel._rope(torch.from_numpy(x), torch.from_numpy(pos), TTINY.rope_theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref = jmodel._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tmodel._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_params_from_numpy_stores_the_serving_dtype(jax_params):
    """bf16 storage holds exactly the values of JAX's cast-on-use weights,
    whether the tree arrives in fp32 or already in bf16."""
    tree = {k: np.asarray(v) for k, v in jax_params.items()}
    bf16_tree = {k: v.astype(jnp.bfloat16) for k, v in tree.items()}  # ml_dtypes bf16
    from_fp32 = params_from_numpy(tree, CPU, torch.bfloat16)
    from_bf16 = params_from_numpy(bf16_tree, CPU, torch.bfloat16)
    for k in tree:
        want = bf16_tree[k].astype(np.float32)
        assert from_fp32[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(from_fp32[k].float().numpy(), want)
        np.testing.assert_array_equal(from_bf16[k].float().numpy(), want)


def test_init_params_layout_matches_jax():
    shapes = jax.eval_shape(lambda k: jmodel.init_params(JTINY, k), jax.random.PRNGKey(0))
    got = tmodel.init_params(TTINY, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in shapes.items()
    }
    assert all(v.dtype == torch.float32 for v in got.values())
    std = got["wq"].std().item() * TTINY.d_model ** 0.5
    assert 0.9 < std < 1.1, "normal / sqrt(fan_in), as the JAX init"
    again = tmodel.init_params(TTINY, torch.Generator().manual_seed(0), CPU)
    assert all(torch.equal(got[k], again[k]) for k in got), "seeded: reproducible"


def test_weights_are_cast_to_the_activation_dtype_on_use():
    """fp32 master weights under dtype=bfloat16 give, bit for bit, the
    forward of the same weights stored in bf16 (every projection and the
    lm_head cast on use, as the reference does), and the gradients reach the
    fp32 masters."""
    cfg = tget_config("test", **{**TINY_KW, "dtype": "bfloat16", "remat": True})
    masters = tmodel.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    stored = {k: v.to(torch.bfloat16) for k, v in masters.items()}
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        assert torch.equal(tmodel.forward(masters, tokens, cfg), tmodel.forward(stored, tokens, cfg))
        hidden = tmodel.forward(masters, tokens, cfg, return_hidden=True)
    assert hidden.dtype == torch.bfloat16 and hidden.shape == (2, 16, cfg.d_model)
    for v in masters.values():
        v.requires_grad_(True)
    tmodel.loss_fn(masters, tokens, tokens, cfg).backward()
    for k, v in masters.items():
        assert v.grad.dtype == torch.float32 and torch.isfinite(v.grad).all(), k
        assert v.grad.abs().sum() > 0, k


@pytest.mark.parametrize("seq,chunk", [(32, 8), (30, 8), (7, 64)])
def test_pick_loss_chunk_matches_jax(seq, chunk):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tmodel.pick_loss_chunk(tget_config("test", loss_chunk=chunk), seq)
        ref = jmodel.pick_loss_chunk(jget_config("test", loss_chunk=chunk), seq)
    assert got == ref
