"""Model FLOPs, counted from the shapes and the mask.

A multiply-add is two FLOPs. Attention counts the (query, key) pairs the
mask keeps, exactly: causal, or causal within a band of ``window`` keys
(the query's own included). Recomputation is not counted, nor the
embedding lookup, norms and elementwise work.
"""

from __future__ import annotations

from portbench.reference.dense import RefConfig


def live_pairs(t: int, window: int = 0, causal: bool = True) -> int:
    """(query, key) pairs a [t, t] mask keeps."""
    if not causal:
        return t * t
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def layer_params(c: RefConfig) -> int:
    """Weights of one layer that each token's products touch (its top-k
    experts and the router for a sparse layer)."""
    d, hd = c.d_model, c.head_dim
    attn = d * c.n_heads * hd * 2 + d * c.n_kv_heads * hd * 2
    if c.n_experts:
        return attn + c.top_k * 3 * d * c.d_ff + d * c.n_experts
    return attn + 3 * d * c.d_ff


def attn_flops_per_key(c: RefConfig) -> int:
    """Forward FLOPs of one (query, key) pair over all heads of a layer:
    q.k and p.v."""
    return 4 * c.n_heads * c.head_dim


def train_flops_per_token(c: RefConfig, seq: int) -> float:
    """6 x the parameters a token touches (lm_head included) plus 3 x the
    forward attention over the pairs the mask keeps (forward and backward)."""
    dense = 6.0 * (c.n_layers * layer_params(c) + c.d_model * c.vocab)
    pairs = live_pairs(seq, c.window)
    return dense + 3.0 * attn_flops_per_key(c) * c.n_layers * pairs / seq


def serve_flops(c: RefConfig, token_contexts: float, tokens: int, logits: int) -> float:
    """FLOPs of ``tokens`` useful tokens whose held contexts (keys each
    attends, its own included) sum to ``token_contexts``, and ``logits``
    rows of the lm_head."""
    return (2.0 * c.n_layers * layer_params(c) * tokens
            + attn_flops_per_key(c) * c.n_layers * token_contexts
            + 2.0 * c.d_model * c.vocab * logits)
