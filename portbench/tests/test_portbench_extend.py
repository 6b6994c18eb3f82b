"""A new cell, configuration, traffic mix (of a new kind, with a generator
of its own), per-layer metric and kernel family are new files only: dropped into a directory beside the
benchmark's own, the harness finds and runs them, and no file of the
benchmark changes."""

import hashlib
import json
import time

import pytest
import torch

from portbench import run
from portbench.lib import files, gen
from portbench.tests import tiny


def digest():
    h = hashlib.sha256()
    for path in sorted(files.ROOT.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(str(path).encode() + path.read_bytes())
    return h.hexdigest()


ZIPF = """import numpy as np

from portbench.lib.gen import rng


def train_batches(mix, seed, vocab):
    r = rng(seed, 1)
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -mix["zipf_a"]
    while True:
        rows = r.choice(vocab, size=(mix["batch"], mix["seq"] + 1), p=p / p.sum())
        yield rows[:, :-1], rows[:, 1:]
"""


def test_new_files_only(tmp_path):
    before = digest()
    tiny.write(tmp_path)
    pub = dict(tiny.DENSE, num_hidden_layers=1, sliding_window=8)
    (tmp_path / "configs" / "throwaway.json").write_text(json.dumps(
        {"published": pub, "port": {"class": "LlamaConfig", "fields": tiny.port_fields(
            pub, attn_impl="splash", attn_window=8)}}))
    # A new kind of mix: Zipf-skewed token ids, which the general generator
    # refuses, drawn by a generator of its own that the mix names.
    (tmp_path / "traffic" / "throwaway-mix.json").write_text(json.dumps(
        {"kind": "train", "batch": 1, "seq": 32, "tokens": "zipf", "zipf_a": 1.2,
         "generator": "throwaway-zipf"}))
    (tmp_path / "traffic" / "throwaway-zipf.py").write_text(ZIPF)
    (tmp_path / "cells" / "throwaway.cell.json").write_text(json.dumps(
        {"config": "throwaway", "mode": "train", "traffic": "throwaway-mix", "chips": 1,
         "train": dict(tiny.TRAIN, reference_steps=2), "limits": tiny.TRAIN_LIMITS}))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "throwaway.steps.py").write_text(
        'UNIT, BETTER, LAYER, MOVES, SOURCE = "steps", "higher", "train step", '
        '"train_tokens_per_s", "program_counter"\n\n'
        'def read(ctx):\n    return ctx.records.get("steps_traced")\n')
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / "throwaway-attn.json").write_text(json.dumps(
        {"used_by": "attn_roofline.train", "count": "splash",
         "calls": {"fwd": {"kernels": "throwaway_fwd", "count_by": "throwaway_fwd"}}}))

    r = run.load_run("throwaway.cell", 5, 4.0, True, torch.device("cpu"), time.monotonic(),
                     extra=[tmp_path])
    result = run.execute(r)
    assert result["correct"], r.checks
    assert result["metrics"]["throwaway.steps"]["value"] >= 1
    assert result["metrics"]["throwaway.steps"]["unit"] == "steps"
    # On the CPU no device reader finds anything to read.
    assert not any(k.startswith(("mfu", "attn_roofline", "device_idle")) for k in result["metrics"])
    mix = files.load_json("traffic", "throwaway-mix", [tmp_path])
    tokens, _ = next(gen.generator(mix, [tmp_path]).train_batches(mix, 5, 128))
    assert (tokens < 8).mean() > 0.4  # skewed: uniform ids would put 1/16 there
    with pytest.raises(ValueError):
        next(gen.train_batches(mix, 5, 128))
    from portbench.lib.readers import families
    assert "throwaway-attn" in [f.name for f in families("attn_roofline.train", [tmp_path])]
    assert digest() == before
