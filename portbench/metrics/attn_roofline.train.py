"""Attention kernels of training (the families under kernels/ used by this
metric: splash, flash): the sum of each launch's roofline bound over the
sum of their device time in the trace, in %."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "higher", "kernels", "train_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "train":
        return None
    shape = ctx.records["attn_shape"]
    return ctx.family_share("attn_roofline.train", {"fwd": [shape], "bwd": [shape]})
