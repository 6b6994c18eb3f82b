"""The port's MoE decoder (``dstack_tpu_torch/workloads/moe.py``) against the
JAX package's ``moe.py``, on the CPU.

One tiny geometry for the file: d_model 64, 2 layers, 4 experts, top-2,
routing groups of 8 tokens (4 groups a batch of 2 x 16) and a capacity
factor of 0.75, so that every group drops tokens past its 3 slots an
expert. The JAX tree's shapes, drawn with numpy, go through
``convert.params_from_numpy``; the inputs are numpy, seeded. fp32 on both
sides: routing (with the zero router's ties), the capacity, ``fake_quant``,
``moe_mlp``, the forward's logits and aux loss (whole and as the chunked
loss's hidden state), the loss and its gradients, and 3 AdamW steps at
grad_accum 1 and 2 agree within 1e-5 (the parameters with
``test_torch_train.py``'s allowance for AdamW's sign-like step). The
presets' parameter counts are JAX's, and an MoE checkpoint written by
either package restores in the other bit for bit. Under --quant int8 and
fp8 the loss agrees to 1e-3 (grid flips), and ``train.main`` takes the
reference's MoE flags together and asks for the card without --device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dstack_tpu.workloads import moe as jmoe
from dstack_tpu.workloads import quantize as jquant
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.checkpoint import CheckpointManager as JaxManager
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import moe as tmoe
from dstack_tpu_torch.workloads import quantize as tquant
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.convert import params_from_numpy

TOL = 1e-5
KW = dict(vocab_size=251, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
          max_seq_len=128, dtype="float32", param_dtype="float32", remat=False,
          n_experts=4, top_k=2, capacity_factor=0.75, router_group=8)
B, T = 2, 16
CPU = torch.device("cpu")


def cfgs(**kw):
    kw = {**KW, **kw}
    return jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)


@pytest.fixture(scope="module")
def np_params():
    """The JAX ``init_moe_params`` layout, drawn with numpy (normal /
    sqrt(fan_in), norms at one)."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda k: jmoe.init_moe_params(cfgs()[0], k), jax.random.PRNGKey(0))
    tree = {}
    for k, s in shapes.items():
        if k.endswith("norm"):
            tree[k] = np.ones(s.shape, np.float32)
        else:
            fan_in = KW["d_model"] if k == "embed" else s.shape[-2]
            tree[k] = (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
    return tree


def torch_params(np_params):
    params = params_from_numpy(np_params, CPU, torch.float32)
    return {k: v.requires_grad_(True) for k, v in params.items()}


def batch(seed=0, ignore=True, b=B):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, KW["vocab_size"], (b, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    if ignore:
        targets[:, -3:] = -1
    return tokens, targets


@pytest.fixture(scope="module")
def jax_loss_and_grads(np_params):
    """JAX value_and_grad of moe.loss_fn on batch(), per loss_chunk."""
    tokens, targets = batch()
    fn = jax.jit(jax.value_and_grad(jmoe.loss_fn), static_argnums=3)
    return {chunk: fn(np_params, tokens, targets, cfgs(loss_chunk=chunk)[0]) for chunk in (0, 8)}


def test_the_converted_tree_has_the_jax_layout(np_params):
    params = params_from_numpy(np_params, CPU, torch.float32)
    shapes = tmoe.moe_param_shapes(cfgs()[1])
    assert list(params) == list(np_params) and set(shapes) == set(params)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np_params[k], err_msg=k)


@pytest.mark.parametrize("tokens", [1, 8, 16, 1000])
@pytest.mark.parametrize("factor", [0.75, 1.25, 2.0])
def test_expert_capacity_matches_jax(tokens, factor):
    jcfg, tcfg = cfgs(capacity_factor=factor)
    assert tmoe.expert_capacity(tcfg, tokens) == jmoe.expert_capacity(jcfg, tokens)


@pytest.mark.parametrize("case", ["random", "zero-router-ties"])
def test_top_k_routing_matches_jax(case):
    """combine, dispatch and the aux loss at capacity 3 over groups of 8
    (tokens drop). With a zero router every probability is equal: top-k
    must take the lowest indices first, as lax.top_k does."""
    rng = np.random.RandomState(7)
    logits = (rng.randn(4, 8, 4).astype(np.float32) if case == "random"
              else np.zeros((4, 8, 4), np.float32))
    jc, jd, ja = jax.jit(jmoe.top_k_routing, static_argnums=(1, 2))(jnp.asarray(logits), 2, 3)
    tc, td, ta = tmoe.top_k_routing(torch.from_numpy(logits), 2, 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(ta.item(), float(ja), rtol=TOL)
    dropped = 2 * 8 - np.asarray(jd).sum(axis=(1, 2, 3))
    assert (dropped > 0).all(), "every group must drop tokens at capacity 3"
    if case != "random":
        # Ties: experts 0 and 1 take every token; 2 and 3 stay empty.
        assert not td[..., 2:, :].any() and td[..., :2, :].any()


def test_fake_quant_matches_jax():
    rng = np.random.RandomState(8)
    w = (rng.randn(4, 64, 128) * rng.rand(4, 1, 128)).astype(np.float32)
    want = np.asarray(jquant.fake_quant(jnp.asarray(w), axis=1))
    t = torch.from_numpy(w).requires_grad_(True)
    got = tquant.fake_quant(t, axis=1)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(w))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_moe_mlp_matches_jax(quant, np_params):
    """One layer's experts on [2, 16, 64] activations: the output, the aux
    loss, and the gradients of the router and the experts."""
    jcfg, tcfg = cfgs(quant=quant)
    x = np.random.RandomState(9).randn(B, T, KW["d_model"]).astype(np.float32)
    layer = {k: np_params[k][1] for k in ("router", "w_gate", "w_up", "w_down")}
    r = np.random.RandomState(10).randn(B, T, KW["d_model"]).astype(np.float32)

    def jloss(layer):
        out, aux = jmoe.moe_mlp(jnp.asarray(x), layer, jcfg, None)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(layer)
    params = torch_params(np_params)
    out, aux = tmoe.moe_mlp(torch.from_numpy(x), params, 1, tcfg)
    (out * torch.from_numpy(r)).sum().add(aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)
    for k in layer:
        np.testing.assert_allclose(params[k].grad[1].numpy(), np.asarray(jgrads[k]), atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("return_hidden", [False, True], ids=["logits", "hidden"])
def test_forward_matches_jax(return_hidden, np_params):
    jcfg, tcfg = cfgs()
    tokens, _ = batch(11)
    want, jaux = jmoe.forward(np_params, jnp.asarray(tokens), jcfg,
                              return_hidden=return_hidden)
    with torch.no_grad():
        got, aux = tmoe.forward(params_from_numpy(np_params, CPU, torch.float32),
                                torch.from_numpy(tokens), tcfg, return_hidden=return_hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=TOL)


@pytest.mark.parametrize(
    "kw", [dict(), dict(loss_chunk=8, remat=True), dict(remat=True, remat_policy="dots")],
    ids=["whole", "chunked-remat", "remat-dots"],
)
def test_loss_and_grads_match_jax(kw, np_params, jax_loss_and_grads):
    tcfg = cfgs(**kw)[1]
    tokens, targets = batch()
    ref_loss, ref_grads = jax_loss_and_grads[tcfg.loss_chunk]
    loss, grads = ttrain.value_and_grad(
        tmoe.loss_fn, torch_params(np_params), torch.from_numpy(tokens),
        torch.from_numpy(targets), cfg=tcfg,
    )
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_steps(np_params, tmp_path_factory):
    """JAX's ``make_moe_train_step``, 3 updates at grad_accum 1 and 2 from
    the same parameters and batches: the losses and the parameters after
    the last; the grad_accum 1 run's state after its first update is saved
    by JAX's manager (the checkpoint test's)."""
    jcfg, _ = cfgs()
    ckpt = tmp_path_factory.mktemp("jax-moe-ckpt")
    out = {"ckpt": ckpt}
    for grad_accum in (1, 2):
        optimizer, state = _jax_state(np_params)
        step = jmoe.make_moe_train_step(jcfg, optimizer, grad_accum=grad_accum)
        losses = []
        for i in range(3):
            state["params"], state["opt"], loss = step(state["params"], state["opt"],
                                                       *batch(20 + i, ignore=False, b=4))
            losses.append(float(loss))
            if grad_accum == 1 and i == 0:
                JaxManager(str(ckpt), process_index=0, process_count=1).save(
                    1, state, data_offset=1,
                    mesh_shape={"dp": 1, "fsdp": 1, "ep": 1, "tp": 1, "sp": 1}, block=True)
                out["saved"] = _jax_entries(state)
        out[grad_accum] = dict(losses=losses,
                               params={k: np.asarray(v) for k, v in state["params"].items()})
    return out


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum, np_params, jax_steps):
    """3 AdamW updates from the same parameters and batches against
    ``make_moe_train_step``: the loss at every step, and the parameters
    after the last with ``test_torch_train.py``'s allowance."""
    _, tcfg = cfgs()
    optimizer = ttrain.make_optimizer()
    state = tmoe.init_moe_train_state(tcfg, optimizer, params=torch_params(np_params))
    step = tmoe.make_moe_train_step(tcfg, optimizer, grad_accum=grad_accum)
    for i in range(3):
        tokens, targets = batch(20 + i, ignore=False, b=4)
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        np.testing.assert_allclose(m["loss"].item(), jax_steps[grad_accum]["losses"][i],
                                   rtol=TOL)
        assert m["step"] == i + 1
    want = jax_steps[grad_accum]["params"]
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - want[k]).ravel() for k, p in state.params.items()
    ])
    assert (diffs > TOL).mean() <= 1e-4, (diffs > TOL).sum()
    assert diffs.max() <= 3 * optimizer.learning_rate


@pytest.mark.parametrize("name", sorted(jmoe.MOE_PRESETS))
def test_presets_and_parameter_counts_match_jax(name):
    want, got = jmoe.MOE_PRESETS[name], tmoe.MOE_PRESETS[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_params() == want.num_params()
    assert got.active_params() == want.active_params()


def _jax_state(np_params):
    optimizer = jtrain.make_optimizer()
    params = {k: jnp.array(v) for k, v in np_params.items()}
    return optimizer, {"params": params, "opt": optimizer.init(params)}


def _jax_entries(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in flat}


def _port_state(np_params):
    optimizer = ttrain.make_optimizer()
    return optimizer, tmoe.init_moe_train_state(cfgs()[1], optimizer,
                                                params=torch_params(np_params))


def test_a_jax_moe_checkpoint_restores_in_the_port_bit_exactly(np_params, jax_steps):
    """The reference's MoE state ``{"params", "opt"}`` after one step, saved
    by its manager, restores into the port's MoeTrainState: every leaf bit
    for bit, under JAX's key paths, and the step from the count."""
    want = jax_steps["saved"]
    _, port = _port_state(np_params)
    tree, manifest = tckpt.CheckpointManager(str(jax_steps["ckpt"])).restore(
        ttrain.state_tree(port))
    ttrain.load_state_tree(port, tree)
    got = {k: v.detach().numpy() for k, v in tckpt.leaf_entries(ttrain.state_tree(port))}
    assert list(got) == list(want) and manifest["step"] == 1 and port.step == 1
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


def test_a_port_moe_checkpoint_restores_in_jax_bit_exactly(np_params, tmp_path):
    _, tcfg = cfgs()
    optimizer, port = _port_state(np_params)
    step = tmoe.make_moe_train_step(tcfg, optimizer)
    port, _ = step(port, *(torch.from_numpy(a) for a in batch(31)))
    tckpt.CheckpointManager(str(tmp_path)).save(1, ttrain.state_tree(port), data_offset=1,
                                                block=True)
    _, template = _jax_state(np_params)
    restored, _ = JaxManager(str(tmp_path), process_index=0, process_count=1).restore(template)
    got = _jax_entries(restored)
    want = {k: v.detach().numpy() for k, v in tckpt.leaf_entries(ttrain.state_tree(port))}
    assert list(got) == list(want)
    for key, leaf in want.items():
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_loss_matches_jax(quant, np_params):
    """Under --quant the attention projections are quantized products and,
    for int8 only, the experts fake-quantized (the reference leaves them
    alone under fp8). A value within ~1e-7 of a grid boundary (the two
    sides' fp32 roundings differ that much) lands on the next grid value on
    one side only, so the loss agrees to 1e-3, as the dense quantized step
    does (tests/test_torch_train_mesh.py)."""
    jcfg, tcfg = cfgs(quant=quant)
    tokens, targets = batch(12)
    want = jax.jit(jmoe.loss_fn, static_argnums=3)(np_params, tokens, targets, jcfg)
    with torch.no_grad():
        got = tmoe.loss_fn(params_from_numpy(np_params, CPU, torch.float32),
                           torch.from_numpy(tokens), torch.from_numpy(targets), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-3)


def test_main_takes_the_moe_branchs_flags_on_the_cpu(tmp_path):
    """The flags the reference's MoE branch takes, together: int8, grad
    accumulation, the bf16 first moment, the dots policy, splash with a
    window, a token file, no prefetch, and a checkpointed run resumed."""
    data = tmp_path / "tokens.bin"
    np.random.RandomState(0).randint(0, 4096, 16 * 33).astype(np.uint16).tofile(data)
    argv = ["--device", "cpu", "--config", "moe_test", "--seq", "32", "--quant", "int8",
            "--grad-accum", "2", "--mu-dtype", "bfloat16", "--remat-policy", "dots",
            "--attn-impl", "splash", "--attn-window", "16", "--data", str(data),
            "--prefetch", "0", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--checkpoint-every", "1", "--resume"]
    first = ttrain.main(argv + ["--steps", "2"])
    resumed = ttrain.main(argv + ["--steps", "3"])
    assert first["tokens_per_sec"] > 0 and resumed["compile_s"] > 0
    assert "mfu" not in first
    manifest = tckpt.CheckpointManager(str(tmp_path / "ckpt")).read_manifest()
    assert manifest["step"] == 3
    assert [leaf["key"] for leaf in manifest["leaves"]][0] == "['opt'][1][0].count"


def test_main_without_a_device_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--config", "moe_test", "--steps", "1"])
