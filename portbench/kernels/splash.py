"""FLOPs and bytes of one call of a training attention kernel, from its
shapes and its mask; flash is the band-less case (window 0).

A shape is ``b`` rows, ``h`` query heads, ``kh`` KV heads, ``t`` tokens,
``d`` head size, ``window`` (0: none), ``in_bytes`` per element of q, k, v
(bf16: 2). The work counts the (query, key) pairs the mask keeps, exactly
(``live_pairs``): the forward 4*d FLOPs a pair (q.k and p.v), the backward
10*d (the scores again, dV, dP, dQ, dK: FlashAttention-2's 2.5x), however
the kernels split it. Bytes count each input read once and each output
written once: forward q, k, v in, o (fp32) and lse out; backward q, k, v,
do (fp32), lse and delta in, dq, dk, dv (fp32) out.
"""

from portbench.lib.flops import live_pairs


def work(kind: str, s: dict):
    b, h, kh, t, d, e = s["b"], s["h"], s["kh"], s["t"], s["d"], s["in_bytes"]
    pairs = b * h * live_pairs(t, s.get("window", 0), s.get("causal", True))
    q = b * h * t * d
    kv = b * kh * t * d
    rows = b * h * t
    if kind == "fwd":
        return 4.0 * d * pairs, e * (q + 2 * kv) + 4 * q + 4 * rows
    if kind == "bwd":
        return 10.0 * d * pairs, e * (q + 2 * kv) + 4 * q + 8 * rows + 4 * (q + 2 * kv)
    raise ValueError(f"unknown call {kind!r}")
