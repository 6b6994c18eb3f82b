"""Mean host time of the engine's prefill stage over the window: the
difference of the ``dstack_tpu_serve_step_stage_seconds{stage="prefill"}``
histogram's sum over the difference of its count. The stage ends in a copy
to the host, which waits for the card."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "ms", "lower", "engine stages", "ttft_p90_ms", "program_span"


def read(ctx):
    return ctx.records.get("prefill_ms") if ctx.mode == "serve" else None
