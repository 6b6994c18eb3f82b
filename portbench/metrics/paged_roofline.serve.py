"""Paged attention kernels of serving (the chunk kernel, the split-KV
decode kernel and its combine): the sum of each call's roofline bound,
from what the slots held at that call, over their device time in the
trace, in %."""

UNIT, BETTER, LAYER, MOVES, SOURCE = "%", "higher", "kernels", "serve_tokens_per_s", "device_trace"


def read(ctx):
    if ctx.mode != "serve":
        return None
    ref, r = ctx.ref, ctx.records
    base = dict(h=ref.n_heads, kh=ref.n_kv_heads, d=ref.head_dim, in_bytes=2, page=r["page"],
                launches=r["layers"])
    calls = {"chunk": [], "decode": []}
    for call in r["serve_calls"]:
        if call[0] == "chunk":
            calls["chunk"].append(dict(base, starts=call[1].tolist(), valid=call[2].tolist()))
        else:
            calls["decode"].append(dict(base, kv=call[1].tolist()))
    return ctx.family_share("paged_roofline.serve", calls)
