"""Nearest-rank 90th percentile of the gaps between successive tokens of a
request, each token stamped at the return of the step that emitted it,
over the gaps that closed inside the window. A per-layer metric: the host
paces decode today."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "ms", "lower", "engine", "serve_tokens_per_s", "host_clock"


def read(ctx):
    return ctx.records.get("itl_p90_ms") if ctx.mode == "serve" else None
