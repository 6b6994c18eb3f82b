"""Seeded weights, made on the device.

Each leaf is one draw from a generator of its own, seeded from ``--seed``
and the leaf's place in the tree, so a leaf can be drawn again alone (the
reference and the change of the parameters read them so). The recipe is
normal / sqrt(fan_in), fan_in the second-last dimension (d_model for the
embedding), norms at one: every product keeps its activations near unit
scale. The program and the reference both get these weights; neither makes
its own.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import torch


def leaf_seed(seed: int, index: int) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_leaf(name: str, shape: Tuple[int, ...], index: int, seed: int, d_model: int,
              device, dtype: torch.dtype) -> torch.Tensor:
    if name.endswith("norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    fan_in = d_model if name == "embed" else shape[-2]
    leaf = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return leaf.mul_(fan_in ** -0.5)


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, d_model: int, device,
         dtype: torch.dtype, only: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` (or those named in ``only``), in ``dtype``."""
    return {name: draw_leaf(name, shape, i, seed, d_model, device, dtype)
            for i, (name, shape) in enumerate(shapes.items()) if not only or name in only}
