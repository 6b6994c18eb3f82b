"""Share of the traced window in which no kernel ran on the card, in %."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "lower", "device", "serve_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "serve" or ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
