"""One place that answers "where does this computation run?".

The port's counterpart of ``dstack_tpu.workloads.kernels.platform``: entry
points run on the CUDA card unless the caller names the CPU, and a caller
that names no device on a host without CUDA gets an error, never a silent
CPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain"
            " PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def chip_generation(device: DeviceLike = None) -> str:
    """The card's generation, ``sm<major><minor>`` ("sm90" on an H100), for a
    CUDA computation, and "cpu" for a CPU one; the autotune cache's key
    carries it (the counterpart of the JAX package's TPU generation). With
    no device: the card when one is available, else the CPU."""
    if device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"sm{major}{minor}"


def require_sm90(device: Optional[torch.device] = None) -> None:
    """The kernels are compiled for sm_90a, which only an sm_90 card runs."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        name = torch.cuda.get_device_name(device)
        raise RuntimeError(
            f"the CUDA kernels are built for sm_90a (H100/H200); {name} is"
            f" sm_{cap[0]}{cap[1]}"
        )


def set_reference_matmul_precision() -> None:
    """Full fp32 matmuls and fp32 reductions in bf16 matmuls on the card, as
    the JAX package's fp32-accumulating dots (PyTorch's defaults allow bf16
    split-K reductions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
