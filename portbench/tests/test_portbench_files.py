"""Every file of the benchmark loads and agrees with BENCHMARK.json, and the
traffic generator repeats exactly for a seed."""

import json

import numpy as np
import pytest

from portbench.lib import files, gen
from portbench.reference.dense import ref_config, tree_shapes

BENCH = json.loads((files.ROOT.parent / "BENCHMARK.json").read_text())


def test_benchmark_names_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        body = json.loads((files.ROOT.parent / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["name"] == c["name"]
        assert set(c["reduced"]) == set(body.get("reduced", {}))
    for w in BENCH["workloads"]:
        cell = files.load_json("cells", w["name"])
        assert cell["config"] == w["config"] in configs
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] == 1
        assert cell["why"] == w["why"]
        files.load_json("traffic", w["traffic"])
        files.find("modes", cell["mode"], ".py")
        assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    for m in BENCH["per_layer"]:
        module = files.load_module("metrics", m["name"])
        assert (module.UNIT, module.BETTER, module.LAYER, module.MOVES, module.SOURCE) == (
            m["unit"], m["better"], m["layer"], m["moves"], m["source"])
    assert set(files.names("metrics", ".py")) == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("name", files.names("configs", ".json"))
def test_config_sizes(name):
    config = files.load_json("configs", name)
    pub, port = config["published"], config["port"]["fields"]
    ref = ref_config(config, pub["num_hidden_layers"])
    assert (port["d_model"], port["n_heads"], port["n_kv_heads"], port["d_ff"],
            port["vocab_size"]) == (ref.d_model, ref.n_heads, ref.n_kv_heads, ref.d_ff, ref.vocab)
    assert port["rope_theta"] == ref.rope_theta and port["norm_eps"] == ref.norm_eps
    assert port.get("attn_window", 0) == ref.window
    if ref.n_experts:
        assert (port["n_experts"], port["top_k"]) == (ref.n_experts, ref.top_k)
        assert port["aux_loss_weight"] == ref.aux_weight
        assert port["capacity_factor"] == ref.capacity_factor
        assert port["router_group"] == ref.router_group
    assert tree_shapes(ref)["wq"] == (pub["num_hidden_layers"], 4096, 4096)


@pytest.mark.parametrize("name", files.names("traffic", ".json"))
def test_generators_repeat(name):
    mix = files.load_json("traffic", name)
    if mix["kind"] == "train":
        a, b, c = (gen.train_batches(dict(mix, seq=64), s, 32000) for s in (2**31 + 7, 2**31 + 7, 5))
        for _ in range(3):
            (ta, ya), (tb, yb), (tc, _) = next(a), next(b), next(c)
            assert np.array_equal(ta, tb) and np.array_equal(ya, yb)
            assert not np.array_equal(ta, tc)
            assert np.array_equal(ta[:, 1:], ya[:, :-1])
        return
    one = gen.serve_requests(mix, 2**33 + 1, 32000, 20.0)
    again = gen.serve_requests(mix, 2**33 + 1, 32000, 20.0)
    other = gen.serve_requests(mix, 17, 32000, 20.0)
    assert [(q.due_s, q.prompt, q.max_new) for q in one] == \
        [(q.due_s, q.prompt, q.max_new) for q in again]
    # Another seed: the same sizes and gaps, in another order.
    assert sorted(len(q.prompt) for q in one) == sorted(len(q.prompt) for q in other)
    assert sorted(q.max_new for q in one) == sorted(q.max_new for q in other)
    assert [len(q.prompt) for q in one] != [len(q.prompt) for q in other]
    assert all(mix["prompt"]["min"] <= len(q.prompt) <= mix["prompt"]["max"] for q in one)
    assert all(0 <= q.due_s < 20.0 for q in one)
    assert max(len(q.prompt) + q.max_new for q in one) <= mix["prompt"]["max"] + mix["output"]["max"]
