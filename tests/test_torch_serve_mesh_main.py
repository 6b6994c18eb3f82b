"""``python -m dstack_tpu_torch.workloads.serve --mesh`` under torchrun's
environment, on the CPU.

Two processes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT: gloo
with ``--device cpu``) serve the ``test`` preset from a checkpoint at
``--mesh tp2``: rank 0 answers ``/generate`` with the tokens of the
meshless port engine on the same checkpoint, ``/stats`` reports
``"mesh": "dd1xtp2"``, and when rank 0 is terminated the follower stops by
itself, within its timeout, and both exit 0. Three processes at ``--mesh
tp3`` fail with the JAX package's validation message (the preset's 8 query
heads do not split 3 ways).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import NamedTuple

import jax
import pytest
import torch

from dstack_tpu.workloads import sharding as jsharding
from dstack_tpu.workloads.config import get_config as jget_config
from dstack_tpu_torch.workloads import checkpoint as tckpt
from dstack_tpu_torch.workloads import model as tmodel
from dstack_tpu_torch.workloads import serve as tserve
from dstack_tpu_torch.workloads.config import get_config

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PROMPT = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]
MAX_NEW = 8
ENGINE_ARGS = ["--max-batch", "2", "--pages", "64", "--page-size", "16"]
STARTUP_S = 120.0
STOP_S = 60.0


class _State(NamedTuple):
    params: dict


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """The ``test`` preset's seeded weights as a ``.params`` subtree."""
    directory = tmp_path_factory.mktemp("serve-mesh-main")
    cfg = get_config("test")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    manager = tckpt.CheckpointManager(str(directory))
    manager.save(1, _State(params), block=True)
    assert manager.save_errors == 0, manager.last_error
    return str(directory)


def start_ranks(world: int, argv: list):
    """``world`` serve processes under torchrun's environment."""
    master = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dstack_tpu_torch.workloads.serve", "--device", "cpu",
             "--config", "test", *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def kill_all(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def get_json(url: str, body=None, timeout: float = 60.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_for_health(url: str, procs) -> None:
    deadline = time.monotonic() + STARTUP_S
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            outs = [p.communicate()[0] for p in procs]
            raise AssertionError(f"a rank exited during startup: {outs}")
        try:
            get_json(url + "/health", timeout=2.0)
            return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("rank 0 never answered /health")


def test_tp2_serves_the_meshless_tokens_and_stops_with_rank_0(checkpoint_dir):
    cfg = get_config("test")
    params, _ = tserve.load_serve_params(checkpoint_dir, cfg, device="cpu")
    engine = tserve.ServeEngine(cfg, tserve.EngineConfig(max_batch=2, num_pages=64,
                                                         page_size=16, max_new_default=64),
                                params=params, device="cpu")
    want = engine.submit(PROMPT, max_new_tokens=MAX_NEW)
    while engine.has_work():
        engine.step()

    port = free_port()
    procs = start_ranks(2, ["--mesh", "tp2", "--checkpoint-dir", checkpoint_dir,
                            "--port", str(port), *ENGINE_ARGS])
    url = f"http://127.0.0.1:{port}"
    try:
        wait_for_health(url, procs)
        answer = get_json(url + "/generate",
                          {"prompt_tokens": PROMPT, "max_tokens": MAX_NEW, "stream": False})
        stats = get_json(url + "/stats")
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=STOP_S)[0] for p in procs]
    finally:
        kill_all(procs)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert answer["tokens"] == want.tokens
    assert stats["mesh"] == "dd1xtp2" and stats["finished_requests"] == 1
    assert "restored checkpoint step 1" in outs[0] and "mesh=dd1xtp2" in outs[0], outs[0]


def test_tp3_fails_with_the_jax_validation_message():
    procs = start_ranks(3, ["--mesh", "tp3", "--port", str(free_port()), *ENGINE_ARGS])
    try:
        outs = [p.communicate(timeout=STARTUP_S)[0] for p in procs]
    finally:
        kill_all(procs)
    with pytest.raises(ValueError) as jax_error:
        jsharding.validate_serve_mesh(jget_config("test"),
                                      jsharding.make_serve_mesh(3, devices=jax.devices()[:3]))
    message = str(jax_error.value)
    assert message.startswith("serve mesh tp=3 must divide n_heads=8")
    for proc, out in zip(procs, outs):
        assert proc.returncode != 0 and message in out, out
