"""The training mesh: axes, the parameter layout and the process group.

The port of ``dstack_tpu/workloads/sharding.py`` (its training half, lines
1-97 and 221-231), in ``torch.distributed`` with one process per card.
Axes, as the JAX package's:

- ``dp``   data parallel (the batch splits over it; so do the parameters,
           "zero-3 over the dp axis too", as PARAM_SPECS says);
- ``fsdp`` fully sharded data parallel (parameters and batch split over
           it; a weight is gathered on use and its gradient reduce-scattered);
- ``tp``   tensor parallel (attention heads, the MLP hidden and the vocab);
- ``sp``   sequence parallel (ring attention; not ported, ROADMAP item 6).

A ``Mesh`` is first a description: the shape and which global rank sits at
each coordinate, enough to cut a leaf's local slice (``local_slices``)
exactly as JAX's ``NamedSharding.devices_indices_map`` cuts it at the same
coordinate. ``Mesh.connect`` then builds the ``DeviceMesh`` over the process
group and its sub-groups: ``tp`` and the combined ``("dp", "fsdp")`` data
group that FSDP shards over. Every rank holds plain local shards of the
stacked-layer parameter dict; the collectives that join them are written
out in ``kernels/collective.py``.

The serve mesh (``make_serve_mesh``, the sharding.py:100-219 half) waits
with the tp-sharded engine (ROADMAP item 6).
"""

from __future__ import annotations

import datetime
import math
import os
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "tp", "sp")
DATA_AXES = ("dp", "fsdp")

# A spec has one entry a dimension: None (whole), an axis, or a tuple of
# axes split row-major, as a jax PartitionSpec; missing trailing entries are
# None. Layer-stacked tensors keep their leading L axis whole.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

PARAM_SPECS: Dict[str, Spec] = {
    "embed": ("tp", DATA_AXES),          # [V, D] vocab over tp
    "wq": (None, DATA_AXES, "tp"),       # [L, D, H*Dh]
    "wk": (None, DATA_AXES, "tp"),       # [L, D, Hkv*Dh]
    "wv": (None, DATA_AXES, "tp"),
    "wo": (None, "tp", DATA_AXES),       # [L, H*Dh, D]
    "w_gate": (None, DATA_AXES, "tp"),   # [L, D, F]
    "w_up": (None, DATA_AXES, "tp"),
    "w_down": (None, "tp", DATA_AXES),   # [L, F, D]
    "attn_norm": (None, None),           # [L, D]
    "mlp_norm": (None, None),
    "final_norm": (None,),               # [D]
    "lm_head": (DATA_AXES, "tp"),        # [D, V]
}

BATCH_SPEC: Spec = (DATA_AXES, "sp")          # tokens [B, T]
ACT_SPEC: Spec = (DATA_AXES, "sp", "tp")      # activations [B, T, D']

# torchrun's collective timeout is 10 minutes; a hung ring or a missing rank
# fails the step after this long instead.
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dimension over."""
    return tuple(a for entry in spec for a in _axes(entry))


class Mesh:
    """A (dp, fsdp, tp, sp) mesh of global ranks. ``ranks[i, j, k, l]`` is
    the rank at that coordinate (JAX's ``mesh.devices``). After ``connect``
    it also holds this process's rank, its device, the ``DeviceMesh`` and
    the process groups of its axes."""

    def __init__(self, shape: Dict[str, int], ranks: np.ndarray):
        self.shape = {a: int(shape[a]) for a in MESH_AXES}
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(tuple(self.shape.values()))
        self.rank: Optional[int] = None
        self.device: Optional[torch.device] = None
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        rank = self.rank if rank is None else rank
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {self.shape}")
        return dict(zip(MESH_AXES, (int(i) for i in where[0])))

    def index(self, axes, rank: Optional[int] = None) -> int:
        """The row-major index over ``axes`` of ``rank``'s coordinate (how
        JAX orders a dimension split over an axis tuple)."""
        coords = self.coords(rank)
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def members(self, axes, rank: Optional[int] = None) -> list:
        """The global ranks of ``rank``'s group over ``axes`` (given in
        MESH_AXES order), in the row-major order of their coordinates: the
        order a dimension split over those axes is cut in. A process group's
        own ranks run in global-rank order, which differs from this when
        --multislice reorders the ranks."""
        coords = self.coords(rank)
        axes = _axes(axes)
        return [int(r) for r in self.ranks[tuple(
            slice(None) if a in axes else coords[a] for a in MESH_AXES)].ravel()]

    def connect(self, device: torch.device) -> "Mesh":
        """Build the ``DeviceMesh`` over the initialized process group, and
        the flattened data group. Every rank calls it, in the same order."""
        from torch.distributed.device_mesh import DeviceMesh

        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(f"a mesh of {self.size} ranks needs a process group of as many")
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.device_mesh = DeviceMesh(self.device.type, torch.from_numpy(self.ranks),
                                      mesh_dim_names=MESH_AXES)
        for axis in MESH_AXES:
            self._groups[(axis,)] = self.device_mesh.get_group(axis)
        self._groups[DATA_AXES] = self.device_mesh[DATA_AXES]._flatten("data").get_group()
        self._groups[MESH_AXES] = dist.group.WORLD
        return self

    def group(self, axes):
        """The process group of ``axes`` (one axis, the data axes, or all)."""
        return self._groups[_axes(axes)]

    def describe(self) -> str:
        return "x".join(f"{a}{n}" for a, n in self.shape.items())


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1, sp: int = 1,
              world: Optional[int] = None, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (dp, fsdp, tp, sp) mesh over ``ranks`` (default: ranks 0..world-1,
    world defaulting to the process group's size, or 1 without one);
    fsdp=None absorbs the remaining ranks."""
    if ranks is None:
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = list(ranks)
    n = len(ranks)
    if fsdp is None:
        denom = dp * tp * sp
        if n % denom != 0:
            raise ValueError(f"{n} ranks not divisible by dp*tp*sp={denom}")
        fsdp = n // denom
    if dp * fsdp * tp * sp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{sp} != {n} ranks")
    return Mesh(dict(dp=dp, fsdp=fsdp, tp=tp, sp=sp), np.array(ranks))


def slice_id() -> int:
    """This process's slice: ``MEGASCALE_SLICE_ID``, else ``DSTACK_NODE_RANK``
    (one node a slice), else 0."""
    for name in ("MEGASCALE_SLICE_ID", "DSTACK_NODE_RANK"):
        raw = os.environ.get(name)
        if raw:
            return int(raw)
    return 0


def gather_slice_ids() -> list:
    """Every rank's ``slice_id()``, indexed by rank (a collective)."""
    ids = [None] * dist.get_world_size()
    dist.all_gather_object(ids, slice_id())
    return ids


def make_multislice_mesh(num_slices: int, slice_ids: Sequence[int], dp: int = 1,
                         fsdp: Optional[int] = None, tp: int = 1, sp: int = 1) -> Mesh:
    """Multislice mesh: the LEADING dp axis spans the slices, everything
    inside stays within one slice. Ranks are ordered slice-major by
    ``slice_ids[rank]`` (then by rank), as the JAX package orders devices by
    ``slice_index``, and dp absorbs the slice count, so only the data
    parallel gradient sums cross slices."""
    world = len(slice_ids)
    if world % num_slices != 0:
        raise ValueError(f"{world} ranks not divisible by {num_slices} slices")
    order = sorted(range(world), key=lambda r: (slice_ids[r], r))
    return make_mesh(dp=num_slices * dp, fsdp=fsdp, tp=tp, sp=sp, ranks=order)


def local_slices(spec: Spec, shape: Sequence[int], mesh: Mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The global index of ``rank``'s piece of a leaf of ``shape`` laid out
    by ``spec``: a dimension split over axes of total size n is cut into n
    equal blocks, block i going to the coordinate whose row-major index over
    those axes is i. The port shards whole blocks only."""
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, spec):
        n = mesh.axis_size(entry)
        if dim % n:
            raise ValueError(f"a dimension of {dim} does not split into {n} equal shards"
                             f" over {_axes(entry)}")
        block = dim // n
        i = mesh.index(entry, rank)
        out.append(slice(i * block, (i + 1) * block))
    return tuple(out)


def global_shape(spec: Spec, shape: Sequence[int], mesh: Mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from one rank's piece of ``shape``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(dim) * mesh.axis_size(entry) for dim, entry in zip(shape, spec))


def holds_first_copy(spec: Spec, mesh: Mesh, rank: Optional[int] = None) -> bool:
    """True on the first rank, in mesh order, that holds its piece: the one
    at coordinate 0 of every axis the spec does not split over. Sums over
    pieces (the grad norm) and checkpoint writes count each piece there
    only."""
    coords = mesh.coords(rank)
    used = spec_axes(spec)
    return all(coords[a] == 0 for a in MESH_AXES if a not in used)


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``rank``'s local piece of every leaf (views of the global tensors)."""
    return {k: v[local_slices(PARAM_SPECS[k], v.shape, mesh, rank)] for k, v in params.items()}


_PARAM_KEY = re.compile(r"\['(\w+)'\]$")


def spec_of_key(key: str) -> Spec:
    """The layout of a checkpoint leaf by its tree path: a parameter and
    its optimizer moments (``...['wq']``) take PARAM_SPECS; the rest (step
    counts) are whole on every rank."""
    m = _PARAM_KEY.search(key)
    return PARAM_SPECS.get(m.group(1), ()) if m else ()


def validate_mesh(cfg, mesh: Mesh) -> None:
    """The port's own conditions on a training mesh, beyond the JAX
    package's: every leaf splits into whole equal blocks (GSPMD would pad an
    uneven one), and tp splits whole attention heads, query and KV alike, so
    that each rank's heads are whole GQA groups."""
    tp, data = mesh.shape["tp"], mesh.axis_size(DATA_AXES)
    for name, dim, n in (("d_model", cfg.d_model, data), ("vocab_size", cfg.vocab_size, tp),
                         ("n_heads", cfg.n_heads, tp), ("n_kv_heads", cfg.n_kv_heads, tp),
                         ("d_ff", cfg.d_ff, tp)):
        if dim % n:
            raise ValueError(
                f"mesh {mesh.describe()}: {name}={dim} does not split into {n} equal"
                f" shards; the port shards whole blocks and whole heads"
            )


def init_distributed(device: torch.device) -> Optional[torch.device]:
    """Join the process group torchrun describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
    NCCL for a CUDA ``device``, whose index becomes ``LOCAL_RANK``, gloo for
    the CPU. Returns this rank's device, or None without ``WORLD_SIZE``. A
    group already initialized by the caller is used as it is."""
    device = torch.device(device)
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        return None
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=COLLECTIVE_TIMEOUT)
    return device


def pad_to_multiple(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
