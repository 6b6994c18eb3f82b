"""Parameter trees from numpy into the port's dict of tensors, and the
dtype names a checkpoint's manifest uses.

``params_from_numpy`` takes a JAX parameter tree as numpy arrays
(``{k: np.asarray(v)}``): the ``init_params`` tree, the MoE decoder's
``init_moe_params`` tree (its ``router`` [L, D, E] and experts [L, E, D, F]
keep their names and layout, as every leaf does), or the weight-only serve
layout ``quantize_serve_params`` makes of it. Floating-point weights are
stored once in the serving dtype: the JAX step functions cast each weight to
the activation dtype on every use, so casting once at engine build gives the
same values, and keeps llama3_8b at its bf16 size on the card. Quantized
leaves keep their own dtype: ``*_q`` values stay int8 or fp8 (ml_dtypes'
fp8 through its bits, as bfloat16), and ``*_s`` scales stay fp32. The
draft head's tree (``model.init_draft_params``) converts the same way.

numpy alone has no bfloat16 or fp8: a checkpoint stores those leaves as
same-width unsigned integers and names the real dtype in its manifest
(``"bfloat16"``, ``"float8_e4m3fn"``). ``storage_dtype`` and
``tensor_from_host`` read such a name through the same bit views.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dstack_tpu_torch.workloads.model import Params
from dstack_tpu_torch.workloads.quantize import leaf_dtype

# ml_dtypes' names -> the torch dtype that reads the same bits.
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def storage_dtype(name: str):
    """The numpy dtype that holds a leaf named ``name`` on disk: the
    unsigned view for bfloat16 and fp8, None for numpy's own dtypes."""
    return np.dtype(_BIT_VIEWS[name][0]) if name in _BIT_VIEWS else None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name ("float32", "bfloat16")."""
    return _BIT_VIEWS[name][1] if name in _BIT_VIEWS else getattr(torch, name)


def tensor_from_host(a: np.ndarray, name: str) -> torch.Tensor:
    """A host array in its storage dtype as the tensor of dtype ``name``
    (bits reinterpreted for bfloat16 and fp8; no copy)."""
    if name in _BIT_VIEWS:
        bits, dtype = _BIT_VIEWS[name]
        return torch.from_numpy(a.view(bits)).view(dtype)
    return torch.from_numpy(a)


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name in _BIT_VIEWS:  # ml_dtypes' types: reinterpret their bits
        bits, dtype = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(bits)).view(dtype)
    return torch.from_numpy(a)


def params_from_numpy(
    tree: Mapping[str, np.ndarray], device: torch.device, dtype: torch.dtype
) -> Params:
    out = {}
    for k, v in tree.items():
        t = _tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=leaf_dtype(k, t, dtype))
    return out
