"""FLOPs and bytes of one call of a paged attention kernel (one layer),
from what the slots held at that call.

A chunk call: ``starts`` and ``valid`` per row (rows with nothing valid are
padding and count nothing); each valid query at position p attends keys
0..p of its slot. A decode call: ``kv`` per active slot, the keys each
slot's one query attends (its own included). FLOPs are 4*d*heads a pair
(q.k and p.v). Bytes: q (``in_bytes`` each) read, the K and V of every
held position read once, the fp32 output written, and the page-table
entries the call reads (int32); split-KV partials are the kernel's own
traffic and do not count.
"""


def work(kind: str, s: dict):
    h, kh, d, e, page = s["h"], s["kh"], s["d"], s["in_bytes"], s["page"]
    if kind == "chunk":
        pairs = keys = queries = pages = 0
        for start, valid in zip(s["starts"], s["valid"]):
            if valid <= 0:
                continue
            end = start + valid
            pairs += (start + 1 + end) * valid // 2
            keys += end
            queries += valid
            pages += -(-end // page)
    elif kind == "decode":
        pairs = keys = sum(s["kv"])
        queries = len(s["kv"])
        pages = sum(-(-n // page) for n in s["kv"])
    else:
        raise ValueError(f"unknown call {kind!r}")
    flops = 4.0 * d * h * pairs
    nbytes = queries * h * d * (e + 4) + keys * kh * d * e * 2 + 4 * pages
    return flops, nbytes
