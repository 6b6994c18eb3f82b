"""On the card (marked ``cuda``; skipped elsewhere): each cell's control,
the program's fp8 path, comes out not correct at the cell's own size, and
a sound run comes out correct. Run on the card with
``python3 -m pytest portbench/tests/test_portbench_card.py``."""

import subprocess
import sys

import pytest

from portbench.lib import files


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def one_run(cell, seed, *extra):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed",
                          str(seed), "--seconds", "3", "--trace", "0", *extra],
                         capture_output=True, text=True, cwd=files.ROOT.parent, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", files.names("cells", ".json"))
def test_control_fails_on_the_card(card, cell):
    assert one_run(cell, 3_300_000_001)["correct"]
    assert not one_run(cell, 3_300_000_002, "--control", "fp8")["correct"]
