"""The save_proj remat policy against the JAX package's, on the CPU.

JAX's ``remat_policy="save_proj"`` saves the outputs it names "proj" (q, k,
v, gate, up and the attention output before wo) and recomputes the rest.
The port marks the same tensors with two ops of its own that the selective
checkpoint policy saves (``model.remat_policy_of``). Here, at 2 layers in
fp32 on the numpy-seeded tree: the dense ``loss_fn`` (blockwise and flash
attention) and the MoE ``loss_fn`` give JAX's loss and every gradient
within 1e-5 under save_proj; and a dispatch mode that watches the backward
names the projections whose forward product runs again there: every one
under "full", none under "dots", and under "save_proj" wo and w_down only
(wo alone with the recompute's early stop, the default, which never reruns
w_down: its output is not read by the backward).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import moe as tmoe
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy

TOL = 1e-5
KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=251,
          max_seq_len=128, dtype="float32", param_dtype="float32", remat=True,
          remat_policy="save_proj")
MOE_KW = dict(KW, n_experts=4, top_k=2, capacity_factor=0.75, router_group=8)
B, T = 2, 16
CPU = torch.device("cpu")
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def np_tree(shapes):
    rng = np.random.RandomState(0)
    return {k: np.ones(s.shape, np.float32) if k.endswith("norm")
            else (rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
            for k, s in shapes.items()}


def batch(vocab):
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, vocab, (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -3:] = -1
    return tokens, targets


def port_value_and_grads(loss_fn, tree, tokens, targets, cfg):
    params = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(tree, CPU, torch.float32).items()}
    loss = loss_fn(params, torch.from_numpy(tokens), torch.from_numpy(targets), cfg)
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p in params.items()}


@pytest.mark.parametrize("attn_impl", ["blockwise", "flash"])
def test_dense_save_proj_loss_and_grads_match_jax(attn_impl):
    jcfg = jget_config("test", **KW, attn_impl=attn_impl)
    tcfg = tget_config("test", **KW, attn_impl=attn_impl)
    tree = np_tree(jax.eval_shape(lambda k: jmodel.init_params(jcfg, k), jax.random.PRNGKey(0)))
    tokens, targets = batch(KW["vocab_size"])
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jmodel.loss_fn), static_argnums=3)(
        tree, tokens, targets, jcfg)
    loss, grads = port_value_and_grads(tmodel.loss_fn, tree, tokens, targets, tcfg)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


def test_moe_save_proj_loss_and_grads_match_jax():
    jcfg, tcfg = jmoe.MoeConfig(**MOE_KW), tmoe.MoeConfig(**MOE_KW)
    tree = np_tree(jax.eval_shape(lambda k: jmoe.init_moe_params(jcfg, k),
                                  jax.random.PRNGKey(0)))
    tokens, targets = batch(MOE_KW["vocab_size"])
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jmoe.loss_fn), static_argnums=3)(
        tree, tokens, targets, jcfg)
    loss, grads = port_value_and_grads(tmoe.loss_fn, tree, tokens, targets, tcfg)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


class ForwardProducts(TorchDispatchMode):
    """Counts the aten.mm calls whose right operand is a layer's projection
    weight exactly as the forward reads it (same storage and strides): the
    forward products. The backward's dx products read the weight
    transposed, and its dw products read the gradient."""

    def __init__(self, params, n_layers):
        super().__init__()
        self.weights = {(params[n][i].data_ptr(), params[n][i].stride()): n
                        for n in PROJECTIONS for i in range(n_layers)}
        self.counts = dict.fromkeys(PROJECTIONS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            name = self.weights.get((args[1].data_ptr(), args[1].stride()))
            if name is not None:
                self.counts[name] += 1
        return func(*args, **(kwargs or {}))


RECOMPUTED = {
    # policy: (early stop on, early stop off) -> projections rerun in the backward
    "full": (set(PROJECTIONS) - {"w_down"}, set(PROJECTIONS)),
    "dots": (set(), set()),
    "save_proj": ({"wo"}, {"wo", "w_down"}),
}


@pytest.mark.parametrize("early_stop", [True, False], ids=["early-stop", "no-early-stop"])
@pytest.mark.parametrize("policy", list(RECOMPUTED))
def test_the_backward_recomputes_the_projections_the_policy_leaves(policy, early_stop):
    cfg = tget_config("test", **{**KW, "remat_policy": policy})
    tree = np_tree({k: jax.ShapeDtypeStruct(s, jnp.float32)
                    for k, s in tmodel.param_shapes(cfg).items()})
    params = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(tree, CPU, torch.float32).items()}
    tokens, targets = (torch.from_numpy(a) for a in batch(cfg.vocab_size))
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        loss = tmodel.loss_fn(params, tokens, targets, cfg)
        mode = ForwardProducts(params, cfg.n_layers)
        with mode:
            loss.backward()
    want = RECOMPUTED[policy][0 if early_stop else 1]
    assert mode.counts == {n: cfg.n_layers if n in want else 0 for n in PROJECTIONS}
