"""The meshes: axes, the parameter layouts and the process group.

The port of ``dstack_tpu/workloads/sharding.py``, in ``torch.distributed``
with one process per card. The training mesh's axes, as the JAX package's:

- ``dp``   data parallel (the batch splits over it; so do the parameters,
           "zero-3 over the dp axis too", as PARAM_SPECS says);
- ``fsdp`` fully sharded data parallel (parameters and batch split over
           it; a weight is gathered on use and its gradient reduce-scattered);
- ``tp``   tensor parallel (attention heads, the MLP hidden and the vocab);
- ``sp``   sequence parallel (the tokens' sequence splits over it and ring
           attention rotates the KV chunks around it; the parameters are
           whole over it, so their gradients take one more sum over it).

The MoE mesh (``make_moe_mesh``, the JAX package's ``moe.py:90-132``) adds
``ep`` between them, (dp, fsdp, ep, tp, sp): the experts split over ``ep``
on their E axis, and outside the experts ``ep`` is one more data axis, so
the batch splits over (dp, fsdp, ep) (``MOE_DATA_AXES``) while the dense
weights keep their (dp, fsdp) shards and are whole over ``ep``
(``MOE_PARAM_SPECS``).

The pipeline mesh (``make_pp_mesh``, the JAX package's ``pipeline.py``) is
(dp, pp): the layer-stacked leaves split their L axis into contiguous
stages over ``pp`` and the rest is whole (``PP_PARAM_SPECS``); the batch
splits over ``dp``.

The serve mesh (``make_serve_mesh``) has two: ``dd``, replicas that hold
the same weights and run the same steps, and ``tp``, the Megatron split of
the projections, the attention heads and the KV pages
(``SERVE_PARAM_SPECS``, ``SERVE_PAGE_SPEC``).

A ``Mesh`` is first a description: its axes, the shape and which global
rank sits at each coordinate, enough to cut a leaf's local slice
(``local_slices``) exactly as JAX's ``NamedSharding.devices_indices_map``
cuts it at the same coordinate. ``Mesh.connect`` then builds the process
groups: for a training mesh the ``DeviceMesh`` and its sub-groups, ``tp``
and the combined ``("dp", "fsdp")`` data group that FSDP shards over; for a
serve mesh the ``tp`` groups and a gloo group over the world for the
host-side messages that keep the ranks' schedulers in step. Every rank
holds plain local shards of the stacked-layer parameter dict; the
collectives that join them are written out in ``kernels/collective.py``
(training) and ``serve.py`` (serving).
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

from dstack_tpu_torch.workloads import quantize as quant_lib

MESH_AXES = ("dp", "fsdp", "tp", "sp")
SERVE_MESH_AXES = ("dd", "tp")
MOE_MESH_AXES = ("dp", "fsdp", "ep", "tp", "sp")
PP_MESH_AXES = ("dp", "pp")
DATA_AXES = ("dp", "fsdp")
# The axes a dense training mesh splits the tokens over when sp > 1: the
# rows over the data axes, the sequence over sp.
TOKEN_AXES = DATA_AXES + ("sp",)
# The axes an MoE batch splits over (the JAX package's MOE_BATCH).
MOE_DATA_AXES = ("dp", "fsdp", "ep")

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
    """A mesh of global ranks over ``axes``: (dp, fsdp, tp, sp) for training,
    (dd, tp) for serving. ``ranks[i, j, ...]`` is the rank at that
    coordinate (JAX's ``mesh.devices``). After ``connect`` it also holds
    this process's rank, its device and the process groups of its axes."""

    def __init__(self, shape: Dict[str, int], ranks: np.ndarray,
                 axes: Tuple[str, ...] = MESH_AXES):
        self.axes = tuple(axes)
        self.shape = {a: int(shape[a]) for a in self.axes}
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
        return dict(zip(self.axes, (int(i) for i in where[0])))

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
        the mesh's order), in the row-major order of their coordinates: the
        order a dimension split over those axes is cut in. A process group's
        own ranks run in global-rank order, which differs from this when
        --multislice reorders the ranks."""
        coords = self.coords(rank)
        axes = _axes(axes)
        return [int(r) for r in self.ranks[tuple(
            slice(None) if a in axes else coords[a] for a in self.axes)].ravel()]

    def connect(self, device: torch.device) -> "Mesh":
        """Build the process groups of the mesh over the initialized process
        group. Every rank calls it, in the same order. A serve mesh of one
        rank needs no process group: it has no collective to run."""
        self.device = torch.device(device)
        if self.axes == SERVE_MESH_AXES and self.size == 1 and not dist.is_initialized():
            self.rank = 0
            return self
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(f"a mesh of {self.size} ranks needs a process group of as many")
        self.rank = dist.get_rank()
        if self.axes == SERVE_MESH_AXES:
            return self._connect_serve()
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh(self.device.type, torch.from_numpy(self.ranks),
                                      mesh_dim_names=self.axes)
        for axis in self.axes:
            self._groups[(axis,)] = self.device_mesh.get_group(axis)
        if self.axes != PP_MESH_AXES:
            self._groups[DATA_AXES] = self.device_mesh[DATA_AXES]._flatten("data").get_group()
        if self.axes == MOE_MESH_AXES:
            self._groups[MOE_DATA_AXES] = self.device_mesh[MOE_DATA_AXES]._flatten(
                "batch").get_group()
        if self.axes == MESH_AXES and self.shape["sp"] > 1:
            # (dp, fsdp, sp) is not a contiguous run of the mesh's axes,
            # which DeviceMesh flattens only: its groups are made directly.
            self._groups[TOKEN_AXES] = self._new_groups(TOKEN_AXES)
        if self.axes == MOE_MESH_AXES and self.shape["sp"] > 1:
            # The MoE token axes, and (ep, sp): the batch axes beyond the
            # data axes, over which a dense leaf's gradient is summed.
            for axes in (MOE_DATA_AXES + ("sp",), ("ep", "sp")):
                self._groups[axes] = self._new_groups(axes)
        self._groups[self.axes] = dist.group.WORLD
        return self

    def _new_groups(self, axes):
        """Every rank's group over ``axes``, made with ``dist.new_group``
        (collective: every rank makes every group, in the same order); this
        rank's is returned."""
        mine = None
        for rank in sorted({min(self.members(axes, int(r))) for r in self.ranks.ravel()}):
            members = self.members(axes, rank)
            group = dist.new_group(sorted(members))
            if self.rank in members:
                mine = group
        return mine

    def _connect_serve(self) -> "Mesh":
        """A serve mesh's groups: tp (``dist.new_group`` is collective, so
        every rank makes each dd row's tp group, in the same order, and
        keeps its own), the world, and a gloo group over the world for
        host-side messages (the world itself when it is gloo). The dd
        replicas run no collective with each other."""
        for row in self.ranks.tolist():
            group = dist.new_group(row)
            if self.rank in row:
                self._groups[("tp",)] = group
        self._groups[self.axes] = dist.group.WORLD
        self._groups["host"] = (dist.group.WORLD if dist.get_backend() == "gloo"
                                else dist.new_group(backend="gloo"))
        return self

    def group(self, axes):
        """The process group of ``axes`` (one axis, the data axes, on an MoE
        mesh the batch axes, under sp the token axes, or all)."""
        return self._groups[_axes(axes)]

    def host_group(self):
        """A serve mesh's gloo group over every rank, for messages between
        the ranks' hosts; None for one rank without a process group."""
        return self._groups.get("host")

    def describe(self) -> str:
        """``dp1xfsdp2xtp2xsp1``; a serve mesh ``dd1xtp4``, as the JAX
        engine's ``mesh_desc``."""
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
    return all(coords[a] == 0 for a in mesh.axes if a not in used)


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``rank``'s local piece of every leaf (views of the global tensors),
    cut by the mesh's own layout (``param_specs``)."""
    specs = param_specs(mesh)
    return {k: v[local_slices(specs[k], v.shape, mesh, rank)] for k, v in params.items()}


_PARAM_KEY = re.compile(r"\['(\w+)'\]$")


def spec_of_key(key: str, specs: Dict[str, Spec] = PARAM_SPECS) -> Spec:
    """The layout of a checkpoint leaf by its tree path: a parameter and
    its optimizer moments (``...['wq']``) take their entry of ``specs``;
    the rest (step counts) are whole on every rank."""
    m = _PARAM_KEY.search(key)
    return specs.get(m.group(1), ()) if m else ()


def param_specs(mesh: Optional[Mesh]) -> Dict[str, Spec]:
    """The parameter layout of a mesh: SERVE_PARAM_SPECS on a serve mesh,
    MOE_PARAM_SPECS on an MoE mesh, PP_PARAM_SPECS on a pipeline mesh,
    PARAM_SPECS on a training mesh (and without one)."""
    if mesh is not None and mesh.axes == SERVE_MESH_AXES:
        return SERVE_PARAM_SPECS
    if mesh is not None and mesh.axes == MOE_MESH_AXES:
        return MOE_PARAM_SPECS
    if mesh is not None and mesh.axes == PP_MESH_AXES:
        return PP_PARAM_SPECS
    return PARAM_SPECS


def data_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """The axes a training mesh splits the batch's rows over: (dp, fsdp, ep)
    on an MoE mesh, (dp, fsdp) otherwise."""
    return MOE_DATA_AXES if mesh is not None and mesh.axes == MOE_MESH_AXES else DATA_AXES


def token_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """The axes a training mesh splits the tokens over: its data axes, and
    sp on a dense or an MoE mesh with sp > 1 (the reference's BATCH_SPEC). A leaf
    whole over any of them has its gradient summed over it, and the loss
    is a mean over all of them."""
    if mesh is not None and mesh.axes in (MESH_AXES, MOE_MESH_AXES) and mesh.shape["sp"] > 1:
        return data_axes(mesh) + ("sp",)
    return data_axes(mesh)


def seq_chunk(seq: int, mesh: Optional[Mesh]) -> slice:
    """This rank's contiguous chunk of a sequence of ``seq`` positions: the
    whole of it unless the mesh splits it over sp."""
    sp = mesh.shape.get("sp", 1) if mesh is not None else 1
    if seq % sp:
        raise ValueError(f"seq={seq} does not split into sp={sp} equal chunks")
    n = seq // sp
    i = mesh.index("sp") if sp > 1 else 0
    return slice(i * n, (i + 1) * n)


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


# -- the MoE mesh (the JAX package's moe.py:90-132) ----------------------------
#
# Experts [L, E, D, F] split E over ep, D over (dp, fsdp) (gathered on
# use, as every dense weight) and F over tp (the Megatron split: gate and
# up column-parallel, w_down row-parallel). The router
# [L, D, E] is whole everywhere. The dense leaves keep PARAM_SPECS' layout,
# so they are whole over ep, which holds other rows of the batch.

MOE_PARAM_SPECS: Dict[str, Spec] = {
    **PARAM_SPECS,
    "router": (None, None, None),                # [L, D, E]
    "w_gate": (None, "ep", DATA_AXES, "tp"),     # [L, E, D, F]
    "w_up": (None, "ep", DATA_AXES, "tp"),
    "w_down": (None, "ep", "tp", DATA_AXES),     # [L, E, F, D]
}


def make_moe_mesh(dp: int = 1, fsdp: int = 1, ep: Optional[int] = None, tp: int = 1,
                  sp: int = 1, world: Optional[int] = None,
                  ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (dp, fsdp, ep, tp, sp) mesh over ``ranks`` (default: ranks
    0..world-1, world defaulting to the process group's size, or 1 without
    one); ep=None absorbs the remaining ranks. The errors are the JAX
    package's, a rank standing for a device."""
    if ranks is None:
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = list(ranks)
    n = len(ranks)
    if ep is None:
        denom = dp * fsdp * tp * sp
        if n % denom != 0:
            raise ValueError(f"{n} devices not divisible by dp*fsdp*tp*sp={denom}")
        ep = n // denom
    if dp * fsdp * ep * tp * sp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{ep}x{tp}x{sp} != {n} devices")
    return Mesh(dict(dp=dp, fsdp=fsdp, ep=ep, tp=tp, sp=sp), np.array(ranks), MOE_MESH_AXES)


def validate_moe_mesh(cfg, mesh: Mesh) -> None:
    """The port's conditions on an MoE mesh: the experts split into whole
    blocks over ep, and every dense leaf into whole blocks as on a training
    mesh; tp splits whole heads, the experts' hidden and the vocab. sp
    splits the sequence, as on a dense mesh (``moe.moe_mlp`` keeps the
    reference's routing groups of the global sequence)."""
    ep, data, tp = mesh.shape["ep"], mesh.axis_size(DATA_AXES), mesh.shape["tp"]
    for name, dim, n in (("n_experts", cfg.n_experts, ep), ("d_model", cfg.d_model, data),
                         ("d_ff", cfg.d_ff, tp), ("n_heads", cfg.n_heads, tp),
                         ("n_kv_heads", cfg.n_kv_heads, tp), ("vocab_size", cfg.vocab_size, tp)):
        if dim % n:
            raise ValueError(
                f"mesh {mesh.describe()}: {name}={dim} does not split into {n} equal"
                f" shards; the port shards whole blocks"
            )


# -- the pipeline mesh (the JAX package's pipeline.py:33-63) -------------------
#
# The layer-stacked leaves split their leading L axis into pp contiguous
# stages; the embed, the final norm and the lm_head are whole on every
# rank, and nothing splits over dp, which holds other rows of the batch.

PP_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm")

PP_PARAM_SPECS: Dict[str, Spec] = {
    **{k: ("pp",) for k in PP_LAYER_KEYS},
    "embed": (None, None),
    "final_norm": (None,),
    "lm_head": (None, None),
}


def make_pp_mesh(dp: int = 1, pp: Optional[int] = None, world: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (dp, pp) mesh over ``ranks`` (default: ranks 0..world-1, world
    defaulting to the process group's size, or 1 without one); pp=None
    absorbs the remaining ranks. The errors are the JAX package's, a rank
    standing for a device."""
    if ranks is None:
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = list(ranks)
    n = len(ranks)
    if pp is None:
        if n % dp != 0:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        pp = n // dp
    if dp * pp != n:
        raise ValueError(f"mesh {dp}x{pp} != {n} devices")
    return Mesh(dict(dp=dp, pp=pp), np.array(ranks), PP_MESH_AXES)


# -- the serve mesh (the JAX module's sharding.py:104-219) --------------------
#
# ``tp``: the Megatron layout, column-parallel q/k/v and gate/up,
# row-parallel wo and w_down with one all-reduce each, the attention heads
# and KV pages on the rank of their projections. ``dd``: replicas, which
# every spec below leaves out (the weights and the engine's batches are the
# same on each). The embed is whole on every rank (a gather on the decode
# path); lm_head splits its contraction, so one all-reduce gives every rank
# the whole fp32 logits and the greedy argmax needs no collective.

SERVE_PARAM_SPECS: Dict[str, Spec] = {
    "embed": (None, None),               # [V, D] whole (decode gather)
    "wq": (None, None, "tp"),            # [L, D, H*Dh] heads over tp
    "wk": (None, None, "tp"),            # [L, D, Hkv*Dh]
    "wv": (None, None, "tp"),
    "wo": (None, "tp", None),            # [L, H*Dh, D] row-parallel
    "w_gate": (None, None, "tp"),        # [L, D, F] hidden over tp
    "w_up": (None, None, "tp"),
    "w_down": (None, "tp", None),        # [L, F, D] row-parallel
    "attn_norm": (None, None),           # [L, D]
    "mlp_norm": (None, None),
    "final_norm": (None,),               # [D]
    "lm_head": ("tp", None),             # [D, V] contraction over tp
}

# KV page pools [L, pool, page, Kh, Dh]: the heads ride the tp split of the
# K/V projections that write them, so page writes and paged attention stay
# on the rank.
SERVE_PAGE_SPEC: Spec = (None, None, None, "tp", None)


def make_serve_mesh(tp: int = 1, dd: Optional[int] = None, world: Optional[int] = None,
                    ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A (dd, tp) serve mesh over ``ranks`` (default: ranks 0..world-1,
    world defaulting to the process group's size, or 1 without one);
    dd=None absorbs the remaining ranks. The errors are the JAX package's,
    a rank standing for a device."""
    if ranks is None:
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        ranks = range(world)
    ranks = list(ranks)
    n = len(ranks)
    if dd is None:
        if n % tp != 0:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dd = n // tp
    if dd * tp != n:
        raise ValueError(f"serve mesh {dd}x{tp} != {n} devices")
    return Mesh(dict(dd=dd, tp=tp), np.array(ranks), SERVE_MESH_AXES)


def serve_param_specs(quant: str = "none") -> Dict[str, Spec]:
    """SERVE_PARAM_SPECS in the layout the engine holds: the fp tree, or the
    ``quantize_serve_params`` layout (``<k>_q`` values take the fp weight's
    spec; ``<k>_s`` per-output-channel scales [..., 1, N] keep only the
    output axis's split, so a row-parallel weight's scales are whole on
    every rank)."""
    if not quant_lib.is_weight_only(quant):
        return dict(SERVE_PARAM_SPECS)
    specs = {k: SERVE_PARAM_SPECS[k] for k in ("embed", "final_norm", "attn_norm", "mlp_norm")}
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"):
        spec = SERVE_PARAM_SPECS[k]
        specs[k + "_q"] = spec
        specs[k + "_s"] = spec[:-2] + (None,) + spec[-1:]
    return specs


def validate_serve_mesh(cfg, mesh: Mesh) -> None:
    """The JAX package's checks of a serve mesh against the model, in its
    words: (dd, tp) axes only, and tp dividing the query heads, the KV
    heads (whole GQA groups), the MLP hidden and the lm_head contraction.
    Every dimension a serve spec splits is one of these four, so they are
    also the port's own condition that each rank holds whole blocks."""
    axes = dict(mesh.shape)
    unknown = set(axes) - {"dd", "tp"}
    if unknown:
        raise ValueError(
            f"serve mesh has unknown axes {sorted(unknown)}; expected (dd, tp)"
            f" — build it with sharding.make_serve_mesh"
        )
    tp = axes.get("tp", 1)
    if tp <= 1:
        return
    for name, dim in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                      ("d_ff", cfg.d_ff), ("d_model", cfg.d_model)):
        if dim % tp:
            raise ValueError(
                f"serve mesh tp={tp} must divide {name}={dim} (whole"
                f" heads/channels per shard); adjust the mesh or the config"
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
