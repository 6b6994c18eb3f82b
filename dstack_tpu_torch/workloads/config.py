"""Model configurations for the Llama-style workload.

The port's own copy of ``dstack_tpu/workloads/config.py``'s ``LlamaConfig``,
``PRESETS`` and ``get_config``: the same fields, defaults and presets, so a
preset name means the same model in both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # compute/activation dtype
    param_dtype: str = "float32"  # master weights
    remat: bool = True  # rematerialize each block on the backward pass
    # "full" recomputes everything; "dots" saves matmul outputs and
    # recomputes only elementwise ops.
    remat_policy: str = "full"
    # Attention core of the training forward; the serving engine ignores it
    # (prefill runs blockwise attention, decode the paged kernels).
    attn_impl: str = "blockwise"
    # Local-attention window in tokens (0 = full causal), attn_impl=splash.
    attn_window: int = 0
    # Matmul precision: "none" (bf16/fp32 per dtype), "int8", or "fp8".
    quant: str = "none"
    # Collective-matmul overlap for the tensor-parallel down-projections.
    tp_overlap: bool = False
    # Collective-matmul overlap for the FSDP all-gather of the up-projections.
    fsdp_overlap: bool = False
    # Cross-entropy: chunk the vocab projection over the sequence (0 = off).
    loss_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def num_params(self) -> int:
        """Parameter count (embeddings counted once; lm head untied)."""
        d, v = self.d_model, self.vocab_size
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        attn += self.n_heads * self.head_dim * d
        mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d  # + norms
        return v * d + self.n_layers * per_layer + d + d * v


# Presets. llama3_8b is the Llama-3-8B geometry the serving example deploys.
PRESETS = {
    "test": LlamaConfig(
        vocab_size=4096, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4, d_ff=688,
        max_seq_len=2048, param_dtype="float32",
    ),
    "llama3_1b": LlamaConfig(
        vocab_size=32000, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8, d_ff=5504,
        max_seq_len=8192,
    ),
    "llama3_8b": LlamaConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_seq_len=8192,
    ),
    "v5e_bench": LlamaConfig(
        vocab_size=32000, d_model=2048, n_layers=8, n_heads=16, n_kv_heads=16,
        d_ff=8192, max_seq_len=2048, remat=True, remat_policy="full",
        attn_impl="auto", loss_chunk=256,
    ),
    "gpt2_125m": LlamaConfig(
        vocab_size=50304, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
        d_ff=3072, max_seq_len=1024, loss_chunk=256,
    ),
}


def get_config(name: str, **overrides) -> LlamaConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
