"""The port's entry points (``dstack_tpu_torch/dryrun.py``) against
the repository's JAX ones (``__graft_entry__.py``), on the CPU.

``dryrun_multichip(8, device="cpu")`` starts its gloo worlds (8 ranks for
the dense, multislice and MoE steps, 4 for the pipeline) and prints the JAX
dry run's four lines with JAX's mesh shapes at 8 devices; ``entry()``'s
forward on JAX's ``entry()`` parameters, carried across, gives JAX's logits.
"""

import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dstack_tpu_torch import dryrun
from dstack_tpu_torch.workloads.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
# What __graft_entry__.dryrun_multichip(8) prints before each loss.
JAX_LINES_AT_8 = [
    "dryrun_multichip ok: mesh dp=1 fsdp=2 tp=2 sp=2, loss=",
    "dryrun_multichip multislice ok: 4 slices x 2 devices (fsdp=1 tp=2), loss=",
    "dryrun_multichip MoE ok: ep=2 tp=2 dp=2 (4 experts top-2), loss=",
    "dryrun_multichip pipeline ok: pp=2 dp=2 (GPipe), loss=",
]


@pytest.fixture(scope="module")
def lines():
    return dryrun.dryrun_multichip(8, device="cpu", timeout=240)


@pytest.mark.parametrize("part", range(len(JAX_LINES_AT_8)),
                         ids=["dense", "multislice", "moe", "pipeline"])
def test_the_dry_run_prints_jaxs_lines(part, lines):
    assert len(lines) == len(JAX_LINES_AT_8)
    line = lines[part]
    assert line.startswith(JAX_LINES_AT_8[part]), line
    loss = float(re.search(r"loss=([0-9.eE+-]+|nan|inf)$", line).group(1))
    assert math.isfinite(loss) and loss > 0


def test_the_plan_and_the_factoring_follow_jax():
    assert dryrun.factor_axes(16) == dict(dp=2, fsdp=2, tp=2, sp=2)
    assert dryrun.factor_axes(6) == dict(dp=1, fsdp=3, tp=1, sp=2)
    assert dryrun.plan(16) == [(16, ["dense", "multislice"]), (8, ["moe"]), (4, ["pipeline"])]
    assert dryrun.plan(4) == [(4, ["dense", "multislice", "pipeline"])]
    assert dryrun.multislice_shape(6) == dict(slices=2, per_slice=3, fsdp=3, tp=1)
    assert dryrun.multislice_shape(1) is None


def test_entry_matches_jaxs_entry():
    """The same shapes, tokens and output dtype; on JAX's parameters the
    forward in fp32 activations within 1e-5 of JAX's, and entry()'s own
    bf16 forward within bf16's rounding of it: the ``test`` preset computes
    in bf16, where the two packages round their sums in other orders (a
    few bf16 steps of 2^-7 at logits near 1, over 4 layers)."""
    import __graft_entry__
    from dstack_tpu.workloads import model as jmodel
    from dstack_tpu.workloads.config import get_config as jget_config
    from dstack_tpu_torch.workloads import model as tmodel
    from dstack_tpu_torch.workloads.config import get_config as tget_config

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens))
    fn, (params, tokens) = dryrun.entry("cpu")
    carried = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                torch.device("cpu"), torch.float32)
    assert {k: tuple(v.shape) for k, v in carried.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert tokens.shape == jtokens.shape and not tokens.any()
    with torch.no_grad():
        got = fn(carried, tokens)
        got32 = tmodel.forward(carried, tokens, tget_config("test", dtype="float32"))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    want32 = np.asarray(jmodel.forward(jparams, jtokens, jget_config("test", dtype="float32")))
    np.testing.assert_allclose(got32.numpy(), want32, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=8 * 2.0 ** -7)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()


def test_the_new_modules_import_nothing_of_jax():
    code = ("import sys, dstack_tpu_torch.workloads.pipeline, dstack_tpu_torch.dryrun\n"
            "print([m for m in sys.modules if m.split('.')[0] in ('jax', 'dstack_tpu')])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout
