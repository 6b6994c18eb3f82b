"""The port's training path against the JAX package, on the CPU.

The JAX ``init_params`` tree goes through ``convert.params_from_numpy`` into
the port, and both sides see the same tokens (numpy, seeded). fp32 on both
sides, so only the summation order differs: losses, gradients and grad
norms agree within 1e-5, and so do the parameters after three AdamW steps
but for AdamW-amplified rounding noise in a few entries (bounded in
test_train_steps_match_jax). Also here: the splash loss and gradients
under a window, the clip and the optimizer (fp32 and bf16 first moment)
against optax, the data sources against the JAX package's, the timed loop's
telemetry keys, and the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dstack_tpu.workloads import data as jdata
from dstack_tpu.workloads import model as jmodel
from dstack_tpu.workloads import telemetry as jtelemetry
from dstack_tpu.workloads import train as jtrain
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import data as tdata
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import telemetry as ttelemetry
from dstack_tpu_torch.workloads import train as ttrain
from dstack_tpu_torch.workloads.config import get_config as tget_config
from dstack_tpu_torch.workloads.convert import params_from_numpy

TOL = 1e-5
TINY_KW = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=251, max_seq_len=128, dtype="float32", param_dtype="float32",
    remat=False,
)
B, T = 2, 16
CPU = torch.device("cpu")


def cfgs(**kw):
    kw = {**TINY_KW, **kw}
    return jget_config("test", **kw), tget_config("test", **kw)


@pytest.fixture(scope="module")
def np_params():
    """The JAX ``init_params`` layout, drawn with numpy (normal / sqrt(fan_in),
    norms at one)."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(cfgs()[0], k), jax.random.PRNGKey(0))
    tree = {}
    for k, s in shapes.items():
        if k.endswith("norm"):
            tree[k] = np.ones(s.shape, np.float32)
        else:
            tree[k] = (rng.randn(*s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
    return tree


def torch_params(np_params):
    """A fresh fp32 copy of the tree, trainable (training mutates it)."""
    params = params_from_numpy(np_params, CPU, torch.float32)
    return {k: v.requires_grad_(True) for k, v in params.items()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(np_params):
    """JAX value_and_grad of loss_fn on batch(), per loss_chunk (remat does
    not change the values, so the reference runs without it)."""
    tokens, targets = batch()
    fn = jax.jit(jax.value_and_grad(jmodel.loss_fn), static_argnums=3)
    return {
        chunk: fn(np_params, tokens, targets, cfgs(loss_chunk=chunk)[0]) for chunk in (0, 8)
    }


def batch(seed=0, ignore=True):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, TINY_KW["vocab_size"], (B, T)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    if ignore:
        targets[:, -3:] = -1
    return tokens, targets


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(loss_chunk=8, remat=True), dict(remat=True, remat_policy="dots")],
    ids=["full-logits", "chunked-remat", "remat-dots"],
)
def test_loss_and_grads_match_jax(kw, np_params, jax_loss_and_grads):
    tcfg = cfgs(**kw)[1]
    tokens, targets = batch()
    ref_loss, ref_grads = jax_loss_and_grads[tcfg.loss_chunk]
    loss, grads = ttrain.value_and_grad(
        tmodel.loss_fn, torch_params(np_params), torch.from_numpy(tokens),
        torch.from_numpy(targets), cfg=tcfg,
    )
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


def test_flash_and_blockwise_give_the_same_loss_and_grads(np_params):
    """attn_impl=flash (the kernels' plain versions on the CPU, through the
    autograd function) against the blockwise walk."""
    tokens, targets = (torch.from_numpy(a) for a in batch(1))
    out = {}
    for impl in ("flash", "blockwise"):
        cfg = cfgs(attn_impl=impl, remat=True)[1]
        out[impl] = ttrain.value_and_grad(
            tmodel.loss_fn, torch_params(np_params), tokens, targets, cfg=cfg
        )
    np.testing.assert_allclose(out["flash"][0].item(), out["blockwise"][0].item(), rtol=TOL)
    for k, g in out["flash"][1].items():
        np.testing.assert_allclose(g.numpy(), out["blockwise"][1][k].numpy(), atol=TOL, err_msg=k)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(grad_accum, np_params):
    """3 updates from the same parameters and batches: loss and the unclipped
    grad norm at every step, and every parameter after the last one.

    AdamW's step m / (sqrt(v) + eps) is sign-like, so a gradient entry that
    cancels to rounding noise (~1e-7 here, with an O(1) relative error) can
    move its parameter by up to lr a step on one side and not the other:
    all but 1 in 10^4 parameters must agree within 1e-5, and those few
    within the 3 * lr such steps can make."""
    jcfg, tcfg = cfgs()
    jparams = {k: jnp.array(v) for k, v in np_params.items()}
    jstate = jtrain.TrainState(
        params=jparams, opt_state=jtrain.make_optimizer().init(jparams),
        step=jnp.zeros((), jnp.int32),
    )
    jstep = jtrain.make_train_step(jcfg, jtrain.make_optimizer(), grad_accum=grad_accum)
    optimizer = ttrain.make_optimizer()
    state = ttrain.init_train_state(tcfg, optimizer, params=torch_params(np_params))
    step = ttrain.make_train_step(tcfg, optimizer, grad_accum=grad_accum)
    norms = []
    for i in range(3):
        tokens, targets = batch(10 + i, ignore=False)
        jstate, jm = jstep(jstate, tokens, targets)
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=TOL)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=TOL)
        norms.append(m["grad_norm"].item())
        assert m["step"] == int(jm["step"]) == i + 1
    assert max(norms) > 1.0, "the clip must have scaled at least one step"
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - np.asarray(jstate.params[k])).ravel()
        for k, p in state.params.items()
    ])
    assert (diffs > TOL).mean() <= 1e-4, (diffs > TOL).sum()
    assert diffs.max() <= 3 * optimizer.learning_rate


def test_adamw_matches_optax_on_the_same_grads():
    """The update itself, fed identical gradients: torch's AdamW with the
    port's clip against optax's chain, 3 steps, every entry within 1e-6."""
    rng = np.random.RandomState(4)
    params = [rng.randn(6, 5).astype(np.float32), rng.randn(9).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params] for s in (3.0, 0.1, 1.0)]
    tx = jtrain.make_optimizer()
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    optimizer = ttrain.make_optimizer()
    opt = optimizer.build(dict(enumerate(tp)))
    for g in grads:
        updates, opt_state = update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = [torch.from_numpy(x.copy()) for x in g]
        ttrain.clip_by_global_norm_(tg, optimizer.grad_clip, ttrain.global_norm(tg))
        for p, x in zip(tp, tg):
            p.grad = x
        opt.step()
    for p, w in zip(tp, jp):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6)


def test_bf16_mu_adamw_matches_optax_on_the_same_grads():
    """optax.adamw(mu_dtype=bfloat16) against the port's AdamWBf16Mu, fed
    identical gradients for 3 steps: the bf16 first moment bit for bit, the
    fp32 second moment and the parameters within 1e-6."""
    rng = np.random.RandomState(5)
    params = [rng.randn(6, 5).astype(np.float32), rng.randn(9).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params] for s in (3.0, 0.1, 1.0)]
    optimizer = ttrain.make_optimizer(mu_dtype="bfloat16")
    tx = optax.adamw(optimizer.learning_rate, b1=optimizer.b1, b2=optimizer.b2,
                     weight_decay=optimizer.weight_decay, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = optimizer.build(dict(enumerate(tp)))
    assert isinstance(opt, ttrain.AdamWBf16Mu)
    for g in grads:
        updates, opt_state = update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    adam = opt_state[0]
    for p, w, mu, nu in zip(tp, jp, adam.mu, adam.nu):
        state = opt.state[p]
        assert state["mu"].dtype == torch.bfloat16 and state["nu"].dtype == torch.float32
        np.testing.assert_array_equal(state["mu"].view(torch.int16).numpy(),
                                      np.asarray(mu).view(np.int16))
        np.testing.assert_allclose(state["nu"].numpy(), np.asarray(nu), atol=1e-6)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("mu_dtype,cls", [(None, torch.optim.AdamW),
                                          ("float32", torch.optim.AdamW),
                                          ("bfloat16", ttrain.AdamWBf16Mu)])
def test_make_optimizer_builds_the_first_moment_dtype(mu_dtype, cls):
    params = {"w": torch.ones(4, 3, requires_grad=True)}
    opt = ttrain.make_optimizer(mu_dtype=mu_dtype).build(params)
    assert type(opt) is cls
    params["w"].grad = torch.full((4, 3), 0.5)
    opt.step()
    assert bool((params["w"] < 1).all())


def test_splash_loss_and_grads_match_jax(np_params):
    """attn_impl=splash with a window of 32 over 64 tokens (the kernels'
    plain versions on the CPU; the Pallas kernels in interpret mode in JAX)."""
    jcfg, tcfg = cfgs(attn_impl="splash", attn_window=32, remat=True)
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, TINY_KW["vocab_size"], (B, 64)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    ref_loss, ref_grads = jax.value_and_grad(jmodel.loss_fn)(np_params, tokens, targets, jcfg)
    loss, grads = ttrain.value_and_grad(
        tmodel.loss_fn, torch_params(np_params), torch.from_numpy(tokens),
        torch.from_numpy(targets), cfg=tcfg,
    )
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


def test_apply_perf_overrides_takes_the_window():
    args = type("Args", (), dict(attn_impl="splash", quant="", attn_window=64))()
    cfg = ttrain.apply_perf_overrides(tget_config("test"), args)
    assert (cfg.attn_impl, cfg.attn_window) == ("splash", 64)


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["under-the-clip", "clipped"])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(3)
    grads = [rng.randn(5, 7).astype(np.float32) * scale, rng.randn(11).astype(np.float32) * scale]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrain.global_norm(got)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    ttrain.clip_by_global_norm_(got, 1.0, norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_unported_optimizer_options_raise():
    """mu_dtype=float16, once refused (the name is the one this test had
    then), against jax.jit of optax's update for 3 steps: the fp16 first
    moment bit for bit, the fp32 second moment and the parameters within
    1e-6. The accumulation and data-shard checks still raise."""
    rng = np.random.RandomState(7)
    params = [rng.randn(6, 5).astype(np.float32), rng.randn(9).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) * s for p in params] for s in (3.0, 0.1, 1.0)]
    optimizer = ttrain.make_optimizer(mu_dtype="float16")
    tx = optax.adamw(optimizer.learning_rate, b1=optimizer.b1, b2=optimizer.b2,
                     weight_decay=optimizer.weight_decay, mu_dtype=jnp.float16)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = optimizer.build(dict(enumerate(tp)))
    for g in grads:
        updates, opt_state = update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for p, w, mu, nu in zip(tp, jp, opt_state[0].mu, opt_state[0].nu):
        state = opt.state[p]
        assert state["mu"].dtype == torch.float16
        np.testing.assert_array_equal(state["mu"].view(torch.int16).numpy(),
                                      np.asarray(mu).view(np.int16))
        np.testing.assert_allclose(state["nu"].numpy(), np.asarray(nu), atol=1e-6)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        ttrain.make_train_step(cfgs()[1], ttrain.make_optimizer(), grad_accum=0)
    with pytest.raises(ValueError, match="data shards"):
        ttrain.check_microbatch(6, 2, 2)


class TestData:
    @pytest.mark.parametrize("pi,pc,start", [(0, 1, 0), (1, 2, 5)])
    def test_synthetic_batches_are_identical(self, pi, pc, start):
        kw = dict(process_index=pi, process_count=pc, start_batch=start)
        ref = jdata.synthetic_batches(97, 4, 12, seed=3, **kw)
        got = tdata.synthetic_batches(97, 4, 12, seed=3, **kw)
        for _ in range(3):
            for a, b in zip(next(got), next(ref)):
                np.testing.assert_array_equal(a, b)

    def test_token_file_batches_are_identical(self, tmp_path):
        path = tmp_path / "tokens.bin"
        np.random.RandomState(0).randint(0, 60000, 2000).astype(np.uint16).tofile(path)
        for kw in (dict(), dict(process_index=1, process_count=2, start_batch=7)):
            ref = jdata.token_file_batches(str(path), 4, 31, **kw)
            got = tdata.token_file_batches(str(path), 4, 31, **kw)
            for _ in range(20):  # past one pass of the file: the wrap too
                for a, b in zip(next(got), next(ref)):
                    np.testing.assert_array_equal(a, b)

    def test_input_pipeline_keeps_order_on_the_cpu(self):
        feed = tdata.input_pipeline(2, 8, 50, prefetch=2, device=CPU, start_batch=4)
        try:
            ref = jdata.synthetic_batches(50, 2, 8, process_index=0, process_count=1, start_batch=4)
            for _ in range(4):
                tokens, targets = next(feed)
                np.testing.assert_array_equal(tokens.numpy(), next(ref)[0])
        finally:
            feed.close()


def _points(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def test_timed_loop_writes_the_reference_telemetry(tmp_path):
    """The same kinds, events and keys as the JAX loop, in a sidecar file."""
    streams = {}
    for name, lib, train_lib, loss in (
        ("jax", jtelemetry, jtrain, lambda: jnp.float32(2.5)),
        ("torch", ttelemetry, ttrain, lambda: torch.tensor(2.5)),
    ):
        path = tmp_path / f"{name}.jsonl"
        emitter = lib.TelemetryEmitter(str(path))
        try:
            stats = train_lib._timed_loop(3, 2, 8, loss, telemetry=emitter,
                                          step_extras=lambda: {"input_wait_s": 0.0})
        finally:
            emitter.close()
        assert stats["compile_s"] > 0 and stats["tokens_per_sec"] > 0
        streams[name] = _points(path)
    shape = {
        name: [(p["kind"], p.get("event"), sorted(set(p) - {"ts"})) for p in pts]
        for name, pts in streams.items()
    }
    assert shape["torch"] == shape["jax"]
    assert [p["step"] for p in streams["torch"] if p["kind"] == "step"] == [2, 3]


def test_main_runs_on_the_cpu_when_asked():
    stats = ttrain.main(["--device", "cpu", "--config", "test", "--steps", "2",
                         "--seq", "32", "--batch", "2", "--attn-impl", "flash"])
    assert stats["compile_s"] > 0 and stats["tokens_per_sec"] > 0
    assert "mfu" not in stats, "no MFU is reported for the CPU"


def test_main_runs_splash_with_a_window_and_a_bf16_first_moment_on_the_cpu():
    stats = ttrain.main(["--device", "cpu", "--config", "test", "--attn-impl", "splash",
                         "--attn-window", "16", "--mu-dtype", "bfloat16", "--grad-accum", "2",
                         "--remat-policy", "full", "--steps", "2", "--seq", "32"])
    assert stats["compile_s"] > 0 and stats["tokens_per_sec"] > 0


def test_main_without_a_device_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--config", "test", "--steps", "1"])


@pytest.mark.parametrize("flag", ["quant", "checkpoint-dir", "draft-head", "moe_test", "ep",
                                  "autotune", "save_proj", "splash-autotune"])
def test_ported_flags_run_on_the_cpu(flag, tmp_path, monkeypatch, capsys):
    """The flags that once raised naming ROADMAP items 3b, 4, 8, 9, 10 and
    12 run: int8 training, a checkpointed run (which leaves its final step),
    the draft head's distillation (which saves a DraftTrainState), the MoE
    preset, --ep on a dense config, which the reference ignores, --autotune
    (on the CPU it sweeps the plain versions over the blocks that divide,
    persists the winner and prints the reference's line) for flash and for
    splash, and the save_proj remat policy. (--draft-head on a mesh runs in
    tests/test_torch_mesh_last.py.)"""
    monkeypatch.setenv("DSTACK_TPU_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    argv = {"quant": ["--quant", "int8"],
            "checkpoint-dir": ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"],
            "draft-head": ["--draft-head", "--checkpoint-dir", str(tmp_path)],
            "moe_test": ["--config", "moe_test"],
            "ep": ["--ep", "2"],
            "autotune": ["--attn-impl", "flash", "--autotune"],
            "save_proj": ["--remat-policy", "save_proj"],
            "splash-autotune": ["--attn-impl", "splash", "--attn-window", "16",
                                "--autotune"]}[flag]
    stats = ttrain.main(["--device", "cpu", "--config", "test", "--seq", "32", "--steps", "2",
                         *argv])
    if flag.endswith("autotune"):
        kernel = "splash" if flag.startswith("splash") else "flash"
        line = f"autotune: {kernel} gen=cpu head_dim=32 seq=32 -> blocks=("
        assert line in capsys.readouterr().out
        cache = json.loads((tmp_path / "autotune" / "blocks.json").read_text())
        assert list(cache) == [f"{kernel}|cpu|32|32"]
    assert stats["compile_s"] > 0 and stats["tokens_per_sec"] > 0
    if flag == "moe_test":
        assert "mfu" not in stats and "tf_per_sec" not in stats
    if flag in ("checkpoint-dir", "draft-head"):
        manifest = json.loads((tmp_path / "step-00000002" / "manifest.json").read_text())
        keys = [leaf["key"] for leaf in manifest["leaves"]]
        assert keys[-1] == ".step" and (".draft['w_fuse']" in keys) == (flag == "draft-head")


def test_checkpoint_every_without_a_dir_exits():
    with pytest.raises(SystemExit, match="--checkpoint-every requires --checkpoint-dir"):
        ttrain.main(["--device", "cpu", "--checkpoint-every", "2", "--steps", "1"])
