"""Useful model FLOPs of the traced engine steps over the traced window,
as a share of the card's published bf16 dense peak: 2 x the layer weights
for every prompt token prefilled and every token decoded, attention over
each such token's held context, and the lm_head for every token emitted.
Padding rows and padded positions count nothing."""

from portbench.lib.flops import serve_flops

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "higher", "model step", "serve_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "serve" or ctx.trace is None or ctx.peak is None:
        return None
    tokens = contexts = 0
    for call in ctx.records["serve_calls"]:
        if call[0] == "chunk":
            for start, valid in zip(call[1], call[2]):
                if valid > 0:
                    tokens += int(valid)
                    contexts += (2 * int(start) + int(valid) + 1) * int(valid) // 2
        else:
            tokens += len(call[1])
            contexts += int(call[1].sum())
    if not tokens:
        return None
    flops = serve_flops(ctx.ref, contexts, tokens, ctx.records["logits_traced"])
    return 100.0 * flops / ctx.trace.window_s / ctx.peak["bf16_flops"]
