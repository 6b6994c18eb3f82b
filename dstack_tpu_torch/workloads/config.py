"""Model configurations for the Llama-style workload.

The port's own copy of ``dstack_tpu/workloads/config.py``'s ``LlamaConfig``,
``PRESETS``, ``get_config``, ``ATTN_IMPLS`` and ``validate_config`` (with
the reference's mesh checks): the same fields, defaults and presets, so a
preset name means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


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

    def flops_per_token(self, seq_len: int, causal: bool = True) -> float:
        """Training FLOPs per token: 6*N plus attention score FLOPs,
        12*L*T*d per token (fwd+bwd) for the full window and half that under
        causal masking, which is what a flash kernel executes."""
        attn = 12.0 * self.n_layers * seq_len * self.d_model
        if causal:
            attn /= 2.0
        return 6.0 * self.num_params() + attn


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


ATTN_IMPLS = ("auto", "xla", "blockwise", "plain", "flash", "flash_tpu",
              "splash")


def validate_config(cfg: LlamaConfig, seq: Optional[int] = None, device=None, mesh=None,
                    batch: Optional[int] = None) -> None:
    """Loud CLI-time validation of the perf-dispatch flags.

    The model-side dispatch falls back silently where a combination merely
    degrades (flash on a ragged length runs blockwise); an explicitly
    requested invalid combination is a config error and fails here, before
    the first step. ``quant="fp8"`` needs fp8 tensor cores on a card
    (compute capability 8.9 or higher; the CPU runs the exact products
    upcast, as the reference allows off-TPU). ``mesh`` (a
    ``sharding.Mesh``) adds the reference's mesh checks and the port's own
    (``sharding.validate_mesh``); ``batch`` is the microbatch the
    tp_overlap ring splits. An MoE mesh (``sharding.make_moe_mesh``) counts
    dp x fsdp x ep as its data shards and takes the MoE checks
    (``sharding.validate_moe_mesh``)."""
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r}; expected one of {ATTN_IMPLS}"
        )
    if cfg.quant not in ("none", "int8", "fp8"):
        raise ValueError(f"unknown quant {cfg.quant!r}; expected none, int8 or fp8")
    if cfg.quant == "fp8" and device is not None:
        import torch

        from dstack_tpu_torch.workloads.quantize import supports_fp8

        device = torch.device(device)
        if not supports_fp8(device):
            cap = torch.cuda.get_device_capability(device)
            raise ValueError(
                f"quant=fp8 needs fp8 tensor cores (compute capability 8.9 or"
                f" higher); {torch.cuda.get_device_name(device)} is"
                f" sm_{cap[0]}{cap[1]} - use quant=int8 or none"
            )
    if cfg.attn_window:
        if cfg.attn_window < 0:
            raise ValueError(f"attn_window must be >= 0, got {cfg.attn_window}")
        if cfg.attn_impl != "splash":
            raise ValueError(
                f"attn_window={cfg.attn_window} only applies to attn_impl="
                f"splash (the block-sparse kernel that skips out-of-window "
                f"blocks); attn_impl={cfg.attn_impl!r} would silently ignore "
                f"the window"
            )
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    tp = mesh.shape.get("tp", 1) if mesh is not None else 1
    if cfg.attn_impl == "flash_tpu" and mesh is not None:
        raise ValueError(
            "attn_impl=flash_tpu only runs meshless (the public kernel has "
            "no sharding rule) and would silently fall back to blockwise "
            "under a device mesh; use attn_impl=flash (the in-repo sharded "
            "kernel) or attn_impl=auto"
        )
    if cfg.attn_impl in ("flash", "flash_tpu", "splash"):
        if sp > 1:
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} does not compose with sequence "
                f"parallelism (sp={sp} runs ring attention, whose rotating KV "
                f"chunks don't meet the kernel's block-divisibility contract);"
                f" use attn_impl=xla or sp=1"
            )
        if seq:
            # Each impl has its own block menu: the public kernel's contract
            # takes 512/256/128 only, the in-repo kernels' go down to 8.
            if cfg.attn_impl == "flash_tpu":
                from dstack_tpu_torch.workloads.attention import _flash_block as _pick
            else:
                from dstack_tpu_torch.workloads.kernels.flash import pick_flash_block as _pick

            if _pick(seq // sp) is None:
                raise ValueError(
                    f"attn_impl={cfg.attn_impl!r} needs a block-divisible "
                    f"sequence length; seq={seq} has no power-of-two block "
                    f"(pad the sequence or use attn_impl=xla)"
                )
        if cfg.attn_impl in ("flash", "splash") and tp > 1 and cfg.n_kv_heads % tp:
            raise ValueError(
                f"attn_impl={cfg.attn_impl} shards heads over tp={tp}, which "
                f"must divide n_kv_heads={cfg.n_kv_heads} (whole GQA groups "
                f"per shard); adjust the mesh or use attn_impl=xla"
            )
    if mesh is None:
        return
    from dstack_tpu_torch.workloads.kernels.collective import can_fsdp_overlap, can_overlap
    from dstack_tpu_torch.workloads.sharding import (
        MOE_MESH_AXES,
        data_axes,
        validate_mesh,
        validate_moe_mesh,
    )

    moe = mesh.axes == MOE_MESH_AXES
    if moe:
        validate_moe_mesh(cfg, mesh)

    if cfg.fsdp_overlap and not can_fsdp_overlap(mesh, cfg.d_model):
        data = mesh.shape.get("dp", 1) * mesh.shape.get("fsdp", 1)
        raise ValueError(
            f"fsdp_overlap rotates weight shards around the dp*fsdp="
            f"{data} ring, which needs dp*fsdp > 1 and d_model="
            f"{cfg.d_model} divisible by it; adjust the mesh or drop "
            f"--fsdp-overlap"
        )
    if cfg.tp_overlap and tp > 1 and batch and seq and not can_overlap(
            mesh, batch, seq, batch_axes=data_axes(mesh)):
        raise ValueError(
            f"tp_overlap needs the per-device row count (batch x seq "
            f"after dp/fsdp/sp sharding) to split into tp={tp} ring "
            f"chunks; batch={batch} seq={seq} mesh={dict(mesh.shape)} "
            f"doesn't — grow the batch or drop --tp-overlap"
        )
    if sp > 1 and seq and seq % sp:
        raise ValueError(f"seq={seq} does not split into sp={sp} equal chunks")
    if not moe:
        validate_mesh(cfg, mesh)
