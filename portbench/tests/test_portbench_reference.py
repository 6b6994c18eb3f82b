"""The plain references agree with the port's CPU path at the port's
``test`` and ``moe_test`` preset sizes (fp32), on the benchmark's weights.
This test may import both; the references import nothing of the port."""

import dataclasses

import numpy as np
import pytest
import torch

from dstack_tpu_torch.workloads import model as port_model
from dstack_tpu_torch.workloads import moe as port_moe
from dstack_tpu_torch.workloads.config import get_config
from portbench.lib import weights
from portbench.reference import dense, moe as ref_moe

CPU = torch.device("cpu")


def ref_of(cfg, window=0, **moe):
    return dense.RefConfig(d_model=cfg.d_model, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                           rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, window=window,
                           **moe)


def loss_and_grads(fn, params):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    value = fn(leaves)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return float(value.detach()), dict(zip(leaves, grads))


def batch(vocab, b=2, t=64, seed=3):
    rows = np.random.default_rng(seed).integers(0, vocab, size=(b, t + 1))
    return torch.from_numpy(rows[:, :-1]), torch.from_numpy(rows[:, 1:])


@pytest.mark.parametrize("impl,window", [("blockwise", 0), ("splash", 16), ("flash", 0)])
def test_dense_reference_matches_port(impl, window):
    cfg = get_config("test", attn_impl=impl, attn_window=window, remat=False, loss_chunk=16,
                     dtype="float32")
    ref = ref_of(cfg, window)
    params = weights.draw(dense.tree_shapes(ref), 11, ref.d_model, CPU, torch.float32)
    tokens, targets = batch(cfg.vocab_size)
    got, got_g = loss_and_grads(lambda p: port_model.loss_fn(p, tokens, targets, cfg), params)
    want, want_g = loss_and_grads(lambda p: dense.loss(p, tokens, targets, ref), params)
    assert got == pytest.approx(want, rel=1e-5)
    for k in params:
        scale = float(want_g[k].abs().max())
        assert float((got_g[k] - want_g[k]).abs().max()) <= 2e-4 * scale, k


def test_moe_reference_matches_port():
    cfg = dataclasses.replace(port_moe.MOE_PRESETS["moe_test"], remat=False, loss_chunk=16,
                              router_group=32, aux_loss_weight=0.02, dtype="float32")
    ref = ref_of(cfg, n_experts=cfg.n_experts, top_k=cfg.top_k,
                 capacity_factor=cfg.capacity_factor, router_group=cfg.router_group,
                 aux_weight=cfg.aux_loss_weight)
    params = weights.draw(dense.tree_shapes(ref), 12, ref.d_model, CPU, torch.float32)
    tokens, targets = batch(cfg.vocab_size)
    got, got_g = loss_and_grads(lambda p: port_moe.loss_fn(p, tokens, targets, cfg), params)
    want, want_g = loss_and_grads(
        lambda p: dense.loss(p, tokens, targets, ref, block=ref_moe.moe_block), params)
    assert got == pytest.approx(want, rel=1e-5)
    for k in params:
        scale = float(want_g[k].abs().max())
        assert float((got_g[k] - want_g[k]).abs().max()) <= 2e-4 * scale, k


def test_moe_reference_drops_past_capacity():
    """Every token choosing expert 0 first: only the first ``capacity``
    claims of a group reach it."""
    ref = dense.RefConfig(d_model=8, n_layers=1, n_heads=2, n_kv_heads=1, d_ff=4, vocab=16,
                          rope_theta=1e4, norm_eps=1e-5, n_experts=4, top_k=1,
                          capacity_factor=1.0, router_group=8)
    w = {"router": torch.zeros(8, 4), "w_gate": torch.ones(4, 8, 4),
         "w_up": torch.ones(4, 8, 4), "w_down": torch.ones(4, 4, 8)}
    w["router"][:, 0] = 1.0
    h = torch.ones(1, 8, 8)
    out, _ = ref_moe.moe_mlp(h, w, ref)
    kept = (out.abs().sum(-1) > 0)[0]
    assert kept.tolist() == [True, True] + [False] * 6   # capacity ceil(1*8*1/4) = 2
