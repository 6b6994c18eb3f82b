"""Parameter trees from numpy into the port's dict of tensors.

``params_from_numpy`` takes the JAX ``init_params`` tree as numpy arrays
(``{k: np.asarray(v)}``) and stores every tensor once in the serving dtype.
The JAX step functions cast each weight to the activation dtype on every
use, so casting once at engine build gives the same values, and keeps
llama3_8b at its bf16 size on the card.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dstack_tpu_torch.workloads.model import Params


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays from JAX are read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(
    tree: Mapping[str, np.ndarray], device: torch.device, dtype: torch.dtype
) -> Params:
    return {k: _tensor(np.asarray(v)).to(device=device, dtype=dtype) for k, v in tree.items()}
