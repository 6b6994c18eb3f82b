"""Tiny files for the CPU tests: configurations, traffic and cells of the
real kinds, at sizes a test run holds, written into a directory that the
harness searches beside its own files."""

from __future__ import annotations

import json
from pathlib import Path

DENSE = {
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 128,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 24,
}
# Serving applies no window: its traffic stays inside this one.
SERVE = dict(DENSE, sliding_window=64)
MOE = dict(DENSE, sliding_window=None, num_local_experts=4, num_experts_per_tok=2,
           router_aux_loss_coef=0.02)


def port_fields(pub: dict, **kw) -> dict:
    fields = dict(vocab_size=pub["vocab_size"], d_model=pub["hidden_size"],
                  n_layers=pub["num_hidden_layers"], n_heads=pub["num_attention_heads"],
                  n_kv_heads=pub["num_key_value_heads"], d_ff=pub["intermediate_size"],
                  max_seq_len=256, rope_theta=pub["rope_theta"], norm_eps=pub["rms_norm_eps"],
                  dtype="float32", param_dtype="float32", remat=True, remat_policy="full",
                  loss_chunk=16)
    fields.update(kw)
    return fields


TRAIN = {"grad_accum": 1, "mu_dtype": None, "lr": 3e-4, "weight_decay": 0.1, "b1": 0.9,
         "b2": 0.95, "grad_clip": 1.0, "reference_steps": 3}
# fp32 throughout at these sizes: the program and the reference agree to
# round-off, far under these limits; every planted fault reads far above.
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def write(root: Path) -> Path:
    files = {
        "configs/tiny-dense.json": {
            "published": DENSE,
            "port": {"class": "LlamaConfig",
                     "fields": port_fields(DENSE, attn_impl="splash", attn_window=24)}},
        "configs/tiny-serve.json": {
            "published": SERVE,
            "port": {"class": "LlamaConfig",
                     "fields": port_fields(SERVE, attn_impl="splash", attn_window=64)}},
        "configs/tiny-moe.json": {
            "published": MOE,
            "port": {"class": "MoeConfig",
                     "fields": port_fields(MOE, attn_impl="flash", n_experts=4, top_k=2,
                                           capacity_factor=1.25, router_group=16,
                                           aux_loss_weight=0.02)},
            "assumed_values": {"capacity_factor": 1.25, "router_group": 16}},
        "traffic/tiny-train.json": {"kind": "train", "batch": 2, "seq": 64, "tokens": "uniform"},
        "traffic/tiny-serve.json": {
            "kind": "serve", "loop": "open", "rate_per_s": 8.0,
            "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 40},
            "output": {"dist": "uniform", "min": 2, "max": 6}},
        "traffic/tiny-closed.json": {
            "kind": "serve", "loop": "closed", "clients": 3, "think_s": 0.05, "cap_per_s": 8.0,
            "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 40},
            "output": {"dist": "uniform", "min": 2, "max": 6}},
        "cells/tiny.train.json": {
            "config": "tiny-dense", "mode": "train", "traffic": "tiny-train", "chips": 1,
            "train": TRAIN, "limits": TRAIN_LIMITS},
        "cells/tiny.moe.json": {
            "config": "tiny-moe", "mode": "train", "traffic": "tiny-train", "chips": 1,
            "train": TRAIN, "limits": TRAIN_LIMITS},
        "cells/tiny.serve.json": {
            "config": "tiny-serve", "mode": "serve", "traffic": "tiny-serve", "chips": 1,
            "engine": {"max_batch": 4, "page_size": 4, "num_pages": 64, "max_seq": 64,
                       "prefill_chunk": 16, "decode_impl": "auto", "quant": "none"},
            "check_tokens": 100, "limits": {"logit_gap": 1e-3}},
    }
    files["cells/tiny.serve-closed.json"] = dict(files["cells/tiny.serve.json"],
                                                 traffic="tiny-closed")
    for rel, body in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(body))
    return root
