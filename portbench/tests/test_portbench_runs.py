"""Whole runs of the harness on the CPU at tiny sizes (the look for a
card skipped): sound runs come out correct; the control (the program's fp8
path) and every fault a cell can have come out not correct: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, a token altered where it is produced. One card, so
no exchange between cards to leave out."""

import time

import pytest
import torch

from portbench import run
from portbench.tests import tiny

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


def execute(root, cell, **kw):
    r = run.load_run(cell, SEED, 4.0, False, torch.device("cpu"), time.monotonic(),
                     extra=[root], **kw)
    return r, run.execute(r)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.moe", "tiny.serve", "tiny.serve-closed"])
def test_sound_run_is_correct(root, cell):
    r, result = execute(root, cell)
    assert result["correct"], r.checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s"} and len(result["metrics"]) >= 2
    assert all(c["value"] <= c["limit"] for c in r.checks.values())


@pytest.mark.parametrize("cell,fault", [
    ("tiny.train", "unchanged"), ("tiny.train", "half_batch"), ("tiny.moe", "unchanged"),
    ("tiny.moe", "half_batch"), ("tiny.serve", "token"), ("tiny.serve-closed", "token")])
def test_fault_is_caught(root, cell, fault):
    r, result = execute(root, cell, fault=fault)
    assert not result["correct"], r.checks


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.moe", "tiny.serve"])
def test_control_is_not_correct(root, cell):
    r, result = execute(root, cell, control="fp8")
    assert not result["correct"], r.checks


def test_repeats_for_a_seed(root):
    a, _ = execute(root, "tiny.train")
    b, _ = execute(root, "tiny.train")
    assert a.records["readings"] == b.records["readings"]
