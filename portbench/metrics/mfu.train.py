"""Model FLOPs of the traced steps over the traced window, as a share of
the card's published bf16 dense peak (``lib/peaks.json``). Model FLOPs:
``lib/flops.train_flops_per_token``, recomputation not counted."""

from portbench.lib.flops import train_flops_per_token

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "higher", "train step", "train_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "train" or ctx.trace is None or ctx.peak is None:
        return None
    r = ctx.records
    flops = train_flops_per_token(ctx.ref, r["seq"]) * r["tokens_per_step"] * r["steps_traced"]
    return 100.0 * flops / ctx.trace.window_s / ctx.peak["bf16_flops"]
