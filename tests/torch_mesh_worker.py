"""One rank of a gloo world on the CPU, for the port's mesh tests (training
and serving).

    python -m tests.torch_mesh_worker <jobs.pt> <rank> <world> <init file> <out dir>

``start_world`` starts ``world`` of these from the repository root, each
joining the process group through ``file://<init file>`` (no port to clash
on between test workers) with a gloo timeout, and waits for them under a
timeout of its own, so a hung collective fails the test. A rank runs every
``(task, kwargs)`` of the jobs file in order and saves the list of results
to ``<out dir>/rank<r>.pt``. It imports torch and the port only, never JAX:
the tests compute the JAX references in their own process.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GLOO_TIMEOUT = datetime.timedelta(seconds=60)


def start_world(jobs: list, world: int, workdir: Path, timeout: float = 240.0):
    """Start ``jobs`` on ``world`` ranks; returns a function that waits for
    them and gives each rank's results. It fails (after killing the rest)
    if a rank exits non-zero or the world outlives ``timeout`` seconds from
    its start. The caller may compute meanwhile."""
    workdir.mkdir(parents=True, exist_ok=True)
    job_file, init = workdir / "jobs.pt", workdir / "init"
    torch.save(jobs, job_file)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_worker", str(job_file), str(r), str(world),
         str(init), str(workdir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout

    def results() -> List[list]:
        outputs = []
        try:
            for proc in procs:
                outputs.append(proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, (proc, out) in enumerate(zip(procs, outputs)):
            if proc.returncode != 0:
                raise AssertionError(f"rank {r} exited {proc.returncode}:\n{out[-6000:]}")
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]

    return results


# -- tasks -------------------------------------------------------------------

TASKS = {}


def task(fn):
    TASKS[fn.__name__] = fn
    return fn


def _mesh(shape: Dict[str, int]):
    """The mesh of ``shape`` (its axes, and optionally ``ranks``: the global
    ranks in mesh order), connected."""
    from dstack_tpu_torch.workloads import sharding

    return sharding.make_mesh(**shape).connect(CPU)


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 through a uint16 view)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


@task
def ring(shape, kind, quant, x, w, r):
    """One ring on global x [B, T, K], w [K, N] and the loss sum(y * r):
    this rank's y and the gradients of its pieces of x and w, with the
    global index of each piece."""
    from dstack_tpu_torch.workloads import quantize
    from dstack_tpu_torch.workloads.kernels import collective
    from dstack_tpu_torch.workloads.sharding import DATA_AXES

    mesh = _mesh(shape)
    dot = {"none": None, "int8": quantize.INT8_DOT, "fp8": quantize.FP8_DOT}[quant]
    data, tp = mesh.axis_size(DATA_AXES), mesh.shape["tp"]
    di, ti = mesh.index(DATA_AXES), mesh.index("tp")
    b, _, k = x.shape
    n = w.shape[1]
    rows = slice(di * b // data, (di + 1) * b // data)
    if kind == "collective":
        # w [K/tp, N/data] gathered over the data ranks on use, as the
        # model's down-projections take it.
        k_sl, n_sl = slice(ti * k // tp, (ti + 1) * k // tp), slice(0, n)
        nd_sl = slice(di * n // data, (di + 1) * n // data)
        xs = torch.from_numpy(x[rows, :, k_sl]).requires_grad_(True)
        ws = torch.from_numpy(w[k_sl, nd_sl]).requires_grad_(True)
        whole = collective.gather_on_use(ws, 1, mesh, DATA_AXES)
        y = collective.collective_matmul(xs, whole, mesh, matmul=dot)
        w_index = (k_sl, nd_sl)
        x_index = (rows, slice(None), k_sl)
    else:
        kd_sl, n_sl = slice(di * k // data, (di + 1) * k // data), slice(ti * n // tp,
                                                                         (ti + 1) * n // tp)
        xs = torch.from_numpy(x[rows]).requires_grad_(True)
        ws = torch.from_numpy(w[kd_sl, n_sl]).requires_grad_(True)
        xin = collective.reduce_backward(xs, mesh, "tp") if tp > 1 else xs
        y = collective.allgather_matmul(xin, ws, mesh, matmul=dot)
        w_index = (kd_sl, n_sl)
        x_index = (rows, slice(None), slice(None))
    y_index = (rows, slice(None), n_sl)
    (y * torch.from_numpy(r[y_index])).sum().backward()
    return dict(y=_host(y), dx=_host(xs.grad), dw=_host(ws.grad), x_index=x_index,
                w_index=w_index, y_index=y_index)


def _state(shape, cfg_kw, params, mu_dtype):
    from dstack_tpu_torch.workloads import sharding
    from dstack_tpu_torch.workloads import train
    from dstack_tpu_torch.workloads.config import get_config

    mesh = _mesh(shape)
    cfg = get_config("test", **cfg_kw)
    local = sharding.shard_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh)
    optimizer = train.make_optimizer(mu_dtype=mu_dtype)
    state = train.init_train_state(cfg, optimizer, params={k: v.clone() for k, v in local.items()})
    return mesh, cfg, optimizer, state


def _tree(state) -> dict:
    from dstack_tpu_torch.workloads import checkpoint, train

    return {key: _host(leaf) for key, leaf in checkpoint.leaf_entries(train.state_tree(state))}


@task
def train_steps(shape, cfg_kw, params, batches, grad_accum=1, mu_dtype=None, ckpt_dir=None):
    """Steps of the port's sharded train step from the global ``params`` on
    the global ``batches``: each step's loss and grad norm, and this rank's
    state after the last (saved to ``ckpt_dir`` at the last step if given)."""
    from dstack_tpu_torch.workloads import checkpoint, train

    mesh, cfg, optimizer, state = _state(shape, cfg_kw, params, mu_dtype)
    step = train.make_train_step(cfg, optimizer, mesh, grad_accum=grad_accum)
    losses, norms = [], []
    for tokens, targets in batches:
        tokens, targets = train.local_batch(tokens, targets, mesh, grad_accum)
        state, metrics = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    if ckpt_dir is not None:
        manager = checkpoint.CheckpointManager(ckpt_dir, mesh=mesh)
        manager.save(state.step, train.state_tree(state), data_offset=state.step,
                     mesh_shape=dict(mesh.shape), block=True)
        manager.close()
    return dict(losses=losses, norms=norms, coords=mesh.coords(), tree=_tree(state))


@task
def restore(shape, cfg_kw, params, ckpt_dir, mu_dtype=None):
    """This rank's pieces of the latest checkpoint in ``ckpt_dir``, restored
    onto the mesh into a state made from ``params``."""
    from dstack_tpu_torch.workloads import checkpoint, train

    mesh, _, _, state = _state(shape, cfg_kw, params, mu_dtype)
    tree, manifest = checkpoint.CheckpointManager(ckpt_dir, mesh=mesh).restore(
        train.state_tree(state))
    train.load_state_tree(state, tree)
    return dict(coords=mesh.coords(), tree=_tree(state), mesh=manifest["mesh"])


@task
def moe_steps(shape, cfg_kw, params, batches, grad_accum=1, ckpt_dir=None):
    """Steps of the port's MoE train step on the MoE mesh of ``shape``
    (make_moe_mesh's kwargs) from the global ``params`` on the global
    ``batches``: each step's loss and grad norm, this rank's state after the
    last (saved to ``ckpt_dir`` if given) and its coordinates."""
    from dstack_tpu_torch.workloads import checkpoint, moe, sharding, train

    mesh = sharding.make_moe_mesh(**shape).connect(CPU)
    cfg = moe.MoeConfig(**cfg_kw)
    local = moe.shard_moe_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh)
    optimizer = train.make_optimizer()
    state = moe.init_moe_train_state(cfg, optimizer,
                                     params={k: v.clone() for k, v in local.items()})
    step = moe.make_moe_train_step(cfg, optimizer, mesh, grad_accum=grad_accum)
    losses, norms = [], []
    for tokens, targets in batches:
        tokens, targets = train.local_batch(tokens, targets, mesh, grad_accum)
        state, metrics = step(state, torch.from_numpy(tokens), torch.from_numpy(targets))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    if ckpt_dir is not None:
        manager = checkpoint.CheckpointManager(ckpt_dir, mesh=mesh)
        manager.save(state.step, train.state_tree(state), data_offset=state.step,
                     mesh_shape=dict(mesh.shape), block=True)
        manager.close()
    return dict(losses=losses, norms=norms, coords=mesh.coords(), tree=_tree(state))


def _token_slices(mesh, shape):
    """This rank's index into a global [B, T, heads, D] activation: its
    rows over the data axes, its chunk of the sequence, its heads over tp."""
    from dstack_tpu_torch.workloads import sharding

    b, t, h = shape[:3]
    data, tp = mesh.axis_size(sharding.DATA_AXES), mesh.shape["tp"]
    di, ti = mesh.index(sharding.DATA_AXES), mesh.index("tp")
    return (slice(di * b // data, (di + 1) * b // data), sharding.seq_chunk(t, mesh),
            slice(ti * h // tp, (ti + 1) * h // tp))


@task
def ring_attention(shape, q, k, v, r, causal, block_size=512):
    """``attention.ring_attention`` on this rank's part of the global q
    [B, T, H, D] and k, v [B, T, Kh, D] (rows over the data axes, sequence
    over sp, heads over tp), and the gradients of sum(out * r): this rank's
    out, dq, dk, dv with their global indices."""
    from dstack_tpu_torch.workloads import attention

    mesh = _mesh(shape)
    qi, ki = _token_slices(mesh, q.shape), _token_slices(mesh, k.shape)
    qs = torch.from_numpy(q[qi]).requires_grad_(True)
    ks = torch.from_numpy(k[ki]).requires_grad_(True)
    vs = torch.from_numpy(v[ki]).requires_grad_(True)
    out = attention.ring_attention(qs, ks, vs, mesh, causal=causal, block_size=block_size)
    (out * torch.from_numpy(r[qi])).sum().backward()
    return dict(out=_host(out), dq=_host(qs.grad), dk=_host(ks.grad), dv=_host(vs.grad),
                q_index=qi, k_index=ki)


@task
def attention_core_sp(shape, q, k, v, impl):
    """``attention.attention_core(impl)`` on this rank's part of q, k, v
    under the mesh: this rank's output and its global index."""
    from dstack_tpu_torch.workloads import attention

    mesh = _mesh(shape)
    qi, ki = _token_slices(mesh, q.shape), _token_slices(mesh, k.shape)
    out = attention.attention_core(torch.from_numpy(q[qi]), torch.from_numpy(k[ki]),
                                   torch.from_numpy(v[ki]), impl, mesh)
    return dict(out=_host(out), q_index=qi)


@task
def pipeline(shape, cfg_kw, params, tokens, targets, n_micro, grads):
    """The port's GPipe on the (dp, pp) mesh of ``shape`` from the global
    ``params`` and batch: with ``grads`` the loss and the gradient of this
    rank's pieces, else the forward's logits of this rank's rows (in
    ``rows`` order)."""
    from dstack_tpu_torch.workloads import data, pipeline as pp_lib
    from dstack_tpu_torch.workloads.config import get_config

    mesh = pp_lib.make_pp_mesh(**shape).connect(CPU)
    cfg = get_config("test", **cfg_kw)
    local = {k: v.clone().requires_grad_(grads) for k, v in pp_lib.shard_params_pp(
        {k: torch.from_numpy(v) for k, v in params.items()}, mesh).items()}
    rows = data.rank_rows(tokens.shape[0], n_micro, mesh.index("dp"), mesh.shape["dp"])
    tok, tgt = torch.from_numpy(tokens[rows]), torch.from_numpy(targets[rows])
    if not grads:
        with torch.no_grad():
            logits = pp_lib.pipelined_forward(local, tok, cfg, mesh, n_micro)
        return dict(logits=_host(logits), rows=rows, coords=mesh.coords())
    loss = pp_lib.pipelined_loss_fn(local, tok, tgt, cfg, mesh, n_micro)
    got = torch.autograd.grad(loss, list(local.values()))
    return dict(loss=loss.item(), grads={k: _host(g) for k, g in zip(local, got)},
                coords=mesh.coords())


@task
def main_exit(argv):
    """``train.main(argv)`` on this rank, which must end in SystemExit: its
    message."""
    from dstack_tpu_torch.workloads import train

    try:
        train.main(argv)
    except SystemExit as e:
        return str(e)
    raise AssertionError(f"train.main({argv}) did not exit")


def _serve_mesh(shape):
    """The serve mesh of ``shape`` (make_serve_mesh's kwargs), connected."""
    from dstack_tpu_torch.workloads import sharding

    return sharding.make_serve_mesh(**shape).connect(CPU)


def _drain(engine, waves, max_new):
    """Token streams of ``waves`` of prompts, each wave submitted once the
    one before has drained."""
    reqs = []
    for wave in waves:
        reqs += [engine.submit(p, max_new_tokens=max_new) for p in wave]
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
            assert steps < 3000, "engine never drained"
    return [r.tokens for r in reqs]


@task
def serve_streams(mesh, cfg_kw, params, base, cases, draft=None):
    """The port's engine on a serve mesh (``mesh``: make_serve_mesh's
    kwargs) from the whole ``params`` tree (numpy), one engine a case
    ``(overrides, waves, max_new)`` with ``base`` engine settings: each
    case's streams, stats and this rank's leaf and pool shapes."""
    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.config import get_config
    from dstack_tpu_torch.workloads.convert import params_from_numpy

    smesh = _serve_mesh(mesh)
    cfg = get_config("test", **cfg_kw)
    out = {"coords": smesh.coords()}
    for name, (overrides, waves, max_new) in cases.items():
        engine = serve.ServeEngine(
            cfg, serve.EngineConfig(**{**base, **overrides}),
            params=params_from_numpy(params, CPU, torch.float32), device=CPU, mesh=smesh,
            draft_params=params_from_numpy(draft, CPU, torch.float32) if draft else None)
        out[name] = dict(streams=_drain(engine, waves, max_new), stats=engine.stats(),
                         shapes={k: tuple(v.shape) for k, v in engine.params.items()},
                         pool=tuple(engine.k_pages.shape))
    return out


@task
def serve_restore(cfg_kw, ckpt_dir, quants, base, prompts, max_new):
    """``load_serve_params`` of ``ckpt_dir`` on a tp4 serve mesh under each
    of ``quants`` (this rank's pieces, as numpy), and the streams of an
    engine on the pieces restored without quantization."""
    from dstack_tpu_torch.workloads import serve
    from dstack_tpu_torch.workloads.config import get_config

    smesh = _serve_mesh(dict(tp=4))
    cfg = get_config("test", **cfg_kw)
    out = {"coords": smesh.coords()}
    for quant in quants:
        params, manifest = serve.load_serve_params(ckpt_dir, cfg, mesh=smesh, quant=quant,
                                                   device=CPU)
        out[quant] = {k: _host(v) for k, v in params.items()}
        out["mesh"] = manifest["mesh"]
        if quant == "none":
            engine = serve.ServeEngine(cfg, serve.EngineConfig(**base), params=params,
                                       device=CPU, mesh=smesh)
            out["streams"] = _drain(engine, [prompts], max_new)
    return out


@task
def step_sync(message):
    """``serve.StepSync`` on dd2 x tp2: rank 0's ``message`` as each rank
    receives it, and whether ``check`` raised on agreeing tokens and on
    tokens that differ on the last rank."""
    from dstack_tpu_torch.workloads import serve

    mesh = _serve_mesh(dict(tp=2))
    sync = serve.StepSync(mesh)
    got = sync.exchange(message if mesh.rank == 0 else None)
    raised = []
    for token in (7, 7 + (mesh.rank == 3)):
        try:
            sync.check([serve.TokenEvent("req-1", token, 0, False)])
            raised.append(False)
        except RuntimeError:
            raised.append(True)
    return dict(message=got, raised=raised)


@task
def main_losses(argv, presets=None):
    """``train.main(argv)`` on this rank (or meshless, in a process without
    a group) with the named presets' fields replaced by ``presets``
    ({name: overrides}, put back after): the loss of each step it ran and
    its stats."""
    import dataclasses

    import torch.distributed as dist

    from dstack_tpu_torch.workloads import config, moe, train

    tables = {name: moe.MOE_PRESETS if name in moe.MOE_PRESETS else config.PRESETS
              for name in presets or {}}
    saved = {name: table[name] for name, table in tables.items()}
    inner = {fn: getattr(train, fn) for fn in ("train", "distill")}
    losses = []

    def recording(fn):
        def run(*args, **kwargs):
            return inner[fn](*args, on_step=lambda step, loss: losses.append(float(loss)),
                             **kwargs)
        return run

    try:
        for name, table in tables.items():
            table[name] = dataclasses.replace(table[name], **presets[name])
        for fn in inner:
            setattr(train, fn, recording(fn))
        stats = train.main(argv)
    finally:
        for fn, f in inner.items():
            setattr(train, fn, f)
        for name, table in tables.items():
            table[name] = saved[name]
    if dist.is_initialized():
        # Every rank's checkpoint shard is written before the next task reads it.
        dist.barrier()
    return dict(losses=losses, stats=stats)


@task
def moe_aux(shape, cfg_kw, params, tokens):
    """The global aux loss of the MoE forward on the MoE mesh of ``shape``
    from the global ``params`` on this rank's part of ``tokens``."""
    from dstack_tpu_torch.workloads import moe, sharding, train

    mesh = sharding.make_moe_mesh(**shape).connect(CPU)
    cfg = moe.MoeConfig(**cfg_kw)
    local = moe.shard_moe_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh)
    tokens, _ = train.local_batch(tokens, tokens, mesh)
    with torch.no_grad():
        _, aux = moe.forward(local, torch.from_numpy(tokens), cfg, mesh)
    return dict(aux=aux.item())


@task
def main(argv):
    """``train.main(argv)`` on this rank (the group is already up)."""
    from dstack_tpu_torch.workloads import train

    stats = train.main(argv)
    return dict(stats=stats)


def _run() -> None:
    import torch.distributed as dist

    jobs_file, rank, world, init, out = sys.argv[1:]
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=int(rank),
                            world_size=int(world), timeout=GLOO_TIMEOUT)
    try:
        results = [TASKS[name](**kwargs) for name, kwargs in
                   torch.load(jobs_file, weights_only=False)]
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _run()
