"""The FLOP and byte counts against brute force, and the model FLOPs per
token against a hand count."""

import itertools

import pytest

from portbench.lib import files, flops
from portbench.reference.dense import ref_config


def brute_pairs(t, window, causal=True):
    return sum(1 for q, k in itertools.product(range(t), range(t))
               if (not causal or k <= q) and (not window or k > q - window))


@pytest.mark.parametrize("t,window,causal", [(1, 0, True), (7, 0, True), (13, 4, True),
                                             (16, 16, True), (16, 1, True), (9, 0, False),
                                             (32, 5, True)])
def test_live_pairs(t, window, causal):
    assert flops.live_pairs(t, window, causal) == brute_pairs(t, window, causal)


@pytest.mark.parametrize("family", ["splash", "flash"])
@pytest.mark.parametrize("t,window", [(12, 0), (12, 5), (20, 3)])
def test_attention_family_counts(family, t, window):
    spec = files.load_json("kernels", family)
    work = files.load_module("kernels", spec["count"]).work
    b, h, kh, d, e = 2, 4, 2, 8, 2
    shape = dict(b=b, h=h, kh=kh, t=t, d=d, window=window, in_bytes=e)
    pairs = b * h * brute_pairs(t, window)
    f, nbytes = work("fwd", shape)
    assert f == 4 * d * pairs
    q, kv = b * h * t * d, b * kh * t * d
    assert nbytes == e * (q + 2 * kv) + 4 * q + 4 * b * h * t
    f, nbytes = work("bwd", shape)
    assert f == 10 * d * pairs
    assert nbytes == e * (q + 2 * kv) + 4 * q + 8 * b * h * t + 4 * (q + 2 * kv)


def test_paged_counts():
    work = files.load_module("kernels", "paged").work
    h, kh, d, e, page = 4, 2, 8, 2, 4
    base = dict(h=h, kh=kh, d=d, in_bytes=e, page=page)
    starts, valid = [0, 5, 9, 3], [3, 4, 0, 1]
    f, nbytes = work("chunk", dict(base, starts=starts, valid=valid))
    pairs = sum(p + 1 for s, v in zip(starts, valid) for p in range(s, s + v))
    keys = sum(s + v for s, v in zip(starts, valid) if v)
    pages = sum(-(-(s + v) // page) for s, v in zip(starts, valid) if v)
    assert f == 4 * d * h * pairs
    assert nbytes == sum(valid) * h * d * (e + 4) + keys * kh * d * e * 2 + 4 * pages
    kv = [1, 17, 4]
    f, nbytes = work("decode", dict(base, kv=kv))
    assert f == 4 * d * h * sum(kv)
    assert nbytes == 3 * h * d * (e + 4) + sum(kv) * kh * d * e * 2 + 4 * (1 + 5 + 1)


def test_mistral_flops_per_token():
    c = ref_config(files.load_json("configs", "mistral-7b"), 8)
    d, f, v = 4096, 14336, 32000
    layer = d * d * 2 + d * 1024 * 2 + 3 * d * f
    assert flops.layer_params(c) == layer == 218_103_808
    window, t = 4096, 16384
    mean_keys = (window * (window + 1) / 2 + (t - window) * window) / t
    hand = 6 * (8 * layer + d * v) + 3 * 4 * 32 * 128 * 8 * mean_keys
    assert flops.train_flops_per_token(c, t) == pytest.approx(hand, rel=1e-12)
    assert 12.6e9 < hand < 12.7e9


def test_mixtral_flops_per_token():
    c = ref_config(files.load_json("configs", "mixtral-8x7b"), 2)
    d, f, v = 4096, 14336, 32000
    layer = d * d * 2 + d * 1024 * 2 + 2 * 3 * d * f + d * 8
    assert flops.layer_params(c) == layer
    t = 4096
    hand = 6 * (2 * layer + d * v) + 3 * 4 * 32 * 128 * 2 * (t + 1) / 2
    assert flops.train_flops_per_token(c, t) == pytest.approx(hand, rel=1e-12)


def test_serve_flops():
    c = ref_config(files.load_json("configs", "mistral-7b"), 32)
    per = 2 * 32 * flops.layer_params(c)
    assert flops.serve_flops(c, 10, 2, 1) == per * 2 + 4 * 32 * 128 * 32 * 10 + 2 * 4096 * 32000
