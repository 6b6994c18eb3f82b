"""Share of the traced window in which no kernel ran on the card: 1 - the
union of kernel intervals over the window, in %."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "lower", "device", "train_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "train" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
