"""The training mesh's collectives, written out as autograd functions.

The port of ``dstack_tpu/workloads/kernels/collective.py`` (46-242), where
``shard_map`` and ``ppermute`` become ``torch.distributed`` calls on each
rank's local tensors, plus the collectives that GSPMD inserts for the JAX
package on its own:

- ``gather_on_use``: FSDP. A weight's shard is all-gathered in the forward
  pass and its gradient reduce-scattered (summed over the data ranks) in the
  backward pass.
- ``reduce_forward`` (row-parallel): the partial products are all-reduced in
  the forward pass; the gradient of a result every rank holds alike passes
  through as it is.
- ``reduce_backward`` (column-parallel, and a leaf every data rank holds
  whole): identity forward; the gradient, which each rank has only for its
  own heads (or its own rows), is all-reduced in the backward pass.
- ``all_to_all`` (MoE, over ``ep``): the token-to-expert exchange GSPMD
  inserts between the dispatch einsum's token-sharded input and its
  expert-sharded output, and back; its backward is the same exchange of the
  gradient.
- ``ppermute`` (ring attention, over ``sp``): JAX's cyclic shift, each
  rank's tensor to the next rank around the axis; its backward is the
  reverse shift, JAX's transpose of ``ppermute``. ``send``/``recv`` are the
  same hop between two ranks, and ``broadcast`` one rank's tensor to its
  group, for the pipeline's explicit schedule.

Point-to-point hops and broadcasts of CUDA tensors over gloo (several
processes sharing a card) go through host copies, since gloo moves host
memory; the compute stays on the card, and NCCL moves device to device.

The loss every rank computes is the same number, and each rank
differentiates its own copy: with these three rules every gradient comes
out of the backward pass exactly once per element of the global gradient,
with no factor of tp or of the data size.

Two rings hide the transfers under the chunk products (the JAX module's
design, with ``dist.batch_isend_irecv`` to the neighbour for ``ppermute``;
on NCCL the transfer runs on its own stream beside the next chunk's product):

**TP reduce-scatter ring** (``collective_matmul``): the down-projections
(``wo``, ``w_down``) contract the tp-sharded axis. The local product splits
into tp row chunks; each chunk's accumulator rides the tp ring, gaining each
rank's partial, and lands complete on its owner after tp-1 hops; one
all-gather rebuilds the activation. Its backward needs no communication: the
gradient of the result is the same on every tp rank, so each computes its
own dx and dw from it.

**FSDP all-gather ring** (``allgather_matmul``): the up-projections (``wq``,
``wk``, ``wv``, ``w_gate``, ``w_up``) contract d_model, which is sharded over
the data ranks. Weight shards rotate around the data ring while each rank
multiplies the matching columns of its own activations; the gathered weight
never exists. Its backward rotates the shards again for dx and runs a
reduce-scatter ring for dw.

A ring's ``matmul`` is a ``quantize.Dot``: the product of one chunk and its
gradients. The default is the fp product with fp32 sums; ``quantize.INT8_DOT``
and ``FP8_DOT`` quantize each chunk with its own scales and pass straight-
through gradients, as the JAX rings' ``int8_matmul_ste`` / ``fp8_matmul_ste``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads.quantize import Dot, fp32_product
from dstack_tpu_torch.workloads.sharding import DATA_AXES

# Newer torch names the single-tensor collectives *_single; the older names
# stay as deprecated aliases with the same signatures.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# The fp chunk product is the JAX module's ``_default_matmul``: x's dtype,
# fp32 sums and an fp32 result.
FP_DOT = Dot(
    fp32_product,
    lambda g, w, dtype: g.to(dtype) @ w.to(dtype).t(),
    lambda x, g: (x.t() @ g.to(x.dtype)).float(),
)


# -- the GSPMD collectives ----------------------------------------------------
#
# Each takes the mesh and the axes it runs over. Blocks are ordered by the
# ranks' coordinates on the mesh (``Mesh.members``), which is how the
# parameters are cut; a process group orders its ranks by global rank, and
# the two differ when --multislice reorders the ranks, so gathered and
# scattered blocks are permuted where they do.


class _Axis:
    """The group over ``axes`` that this rank belongs to: the process group,
    its size, this rank's coordinate index, and for each group rank (the
    global-rank order the group's collectives use) the coordinate index of
    that rank."""

    def __init__(self, mesh, axes):
        members = mesh.members(axes)
        self.group = mesh.group(axes)
        self.size = len(members)
        self.index = members.index(mesh.rank)
        self.coord_of = [members.index(r) for r in sorted(members)]
        self.ordered = self.coord_of == list(range(self.size))
        self.members = members

    def neighbours(self):
        """(next, previous) global ranks around the ring in coordinate order."""
        return (self.members[(self.index + 1) % self.size],
                self.members[(self.index - 1) % self.size])


def _gather(x: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    """All-gather ``x`` over the axis, the ranks' blocks concatenated along
    ``dim`` in coordinate order."""
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=axis.group)
    blocks = out.view(axis.size, *x.shape)
    if not axis.ordered:
        blocks = blocks[[axis.coord_of.index(c) for c in range(axis.size)]]
    return blocks.movedim(0, dim).flatten(dim, dim + 1)


def _scatter_sum(g: torch.Tensor, dim: int, axis: _Axis) -> torch.Tensor:
    """Reduce-scatter ``g`` over the axis: the sum over the ranks of the
    block of ``dim`` at this rank's coordinate."""
    n = axis.size
    blocks = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0)
    blocks = blocks.contiguous() if axis.ordered else blocks[axis.coord_of]
    out = blocks.new_empty(blocks.shape[1:])
    _reduce_scatter(out, blocks.flatten(0, 1), group=axis.group)
    return out


class _GatherOnUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, axis, dtype):
        ctx.dim, ctx.axis, ctx.dtype = dim, axis, w.dtype
        return _gather(w.to(dtype or w.dtype), dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g.float(), ctx.dim, ctx.axis).to(ctx.dtype), None, None, None


def gather_on_use(w: torch.Tensor, dim: int, mesh, axes=DATA_AXES,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole weight from each rank's shard along ``dim`` over ``axes``
    (cast to ``dtype`` before the gather); the gradient is summed over the
    ranks in fp32 and scattered back to the shards, in ``w``'s dtype."""
    return _GatherOnUse.apply(w, dim, _Axis(mesh, axes), dtype)


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_forward(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of the ranks' partial ``x`` over ``axes`` (row-parallel); the
    gradient passes through as it is."""
    return _ReduceForward.apply(x, mesh.group(axes))


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_backward(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``axes`` (the input of a
    column-parallel product, or a leaf each rank of the group holds whole)."""
    return _ReduceBackward.apply(x, mesh.group(axes))


def _exchange(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """All-to-all over the axis along dim 0: block i of ``x`` (dim 0 cut
    into the axis' size, in coordinate order) goes to the rank at coordinate
    i, and block j of the result came from the rank at coordinate j."""
    n = axis.size
    blocks = x.unflatten(0, (n, x.shape[0] // n))
    blocks = (blocks if axis.ordered else blocks[axis.coord_of]).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=axis.group)
    if not axis.ordered:
        out = out[[axis.coord_of.index(c) for c in range(n)]]
    return out.flatten(0, 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        # The exchange is a permutation of blocks whose transpose is the
        # same exchange: rank i's block j went to rank j's block i.
        return _exchange(g, ctx.axis), None


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Exchange dim-0 blocks of ``x`` over ``axes`` (dim 0 a multiple of the
    axis size): this rank keeps from each rank of the axis the block at its
    own coordinate, in coordinate order. Differentiable: the gradient takes
    the way back."""
    return _AllToAll.apply(x, _Axis(mesh, axes))


def _staged(x: torch.Tensor, group) -> bool:
    """True when a hop of ``x`` over ``group`` goes through a host copy: a
    CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def send(x: torch.Tensor, dst: int, group):
    """Start sending ``x`` to global rank ``dst`` of ``group``; returns the
    work to wait on (which keeps the sent buffer alive)."""
    buf = x.detach().contiguous()
    if _staged(buf, group):
        buf = buf.cpu()
    return _Sent(dist.isend(buf, dst, group=group), buf)


class _Sent:
    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()


def recv(shape, dtype: torch.dtype, device: torch.device, src: int, group) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from global rank ``src``
    of ``group``, onto ``device``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    buf = out.cpu() if _staged(out, group) else out
    dist.recv(buf, src, group=group)
    return out.copy_(buf) if buf is not out else out


def broadcast(t: torch.Tensor, src: int, group) -> None:
    """``t`` from global rank ``src`` to every rank of ``group``, in place."""
    if dist.get_world_size(group) == 1:
        return
    if _staged(t, group):
        buf = t.cpu()
        dist.broadcast(buf, src, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, src, group=group)


def _permute(x: torch.Tensor, axis: "_Axis", shift: int) -> torch.Tensor:
    """``x`` of the rank ``shift`` places before this one around the axis
    (this rank's goes ``shift`` places on)."""
    n = axis.size
    if n == 1 or shift % n == 0:
        return x.clone()
    dst = axis.members[(axis.index + shift) % n]
    src = axis.members[(axis.index - shift) % n]
    out = torch.empty_like(x)
    buf, got = x.contiguous(), out
    if _staged(buf, axis.group):
        buf, got = buf.cpu(), torch.empty(out.shape, dtype=out.dtype)
    _wait(dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, dst, axis.group),
                                  dist.P2POp(dist.irecv, got, src, axis.group)]))
    return out.copy_(got) if got is not out else out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _permute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.axis, -ctx.shift), None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` with the cyclic permutation i -> i + shift over
    ``axis``: this rank sends ``x`` ``shift`` places on (in coordinate
    order) and returns what the rank ``shift`` places before it sent.
    Differentiable: the gradient takes the reverse shift."""
    return _Ppermute.apply(x, _Axis(mesh, axis), shift)


def max_over(mesh, axes):
    """An in-place max over ``axes``, for ``quantize``'s ``reduce``."""
    group = mesh.group(axes)

    def reduce(t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)

    return reduce


# -- the rings -----------------------------------------------------------------


class _HostHops:
    """The works of hops staged through host memory (CUDA tensors on a gloo
    group): waiting for them copies what arrived into the device buffers."""

    def __init__(self, works, sent, landed):
        self.works, self.sent, self.landed = works, sent, landed

    def wait(self) -> None:
        for work in self.works:
            work.wait()
        for device_buf, host_buf in self.landed:
            device_buf.copy_(host_buf)


def _shift(pairs, axis: _Axis):
    """Start sending each ``(send, recv)`` pair's ``send`` to the next rank
    around the axis and receiving its ``recv`` from the previous one;
    returns the works to wait on."""
    nxt, prv = axis.neighbours()
    staged = _staged(pairs[0][0], axis.group)
    ops, sent, landed = [], [], []
    for tag, (send, recv) in enumerate(pairs):
        if staged:
            send = send.cpu()
            host = torch.empty(recv.shape, dtype=recv.dtype)
            sent.append(send)
            landed.append((recv, host))
            recv = host
        ops += [dist.P2POp(dist.isend, send, nxt, axis.group, tag),
                dist.P2POp(dist.irecv, recv, prv, axis.group, tag)]
    works = dist.batch_isend_irecv(ops)
    return [_HostHops(works, sent, landed)] if staged else works


def _wait(works) -> None:
    for work in works:
        work.wait()


class _CollectiveMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, dot):
        ctx.save_for_backward(x, w)
        ctx.dot = dot
        tp, my = axis.size, axis.index
        b, t, k = x.shape
        chunk = b * t // tp
        xf = x.reshape(b * t, k)

        def partial(c):
            return dot.forward(xf[c * chunk:(c + 1) * chunk], w)

        # Chunk c's accumulator starts on rank c+1 and gains each rank's
        # partial on its way; after tp-1 hops it lands complete on rank c.
        acc = partial((my - 1) % tp)
        for s in range(1, tp):
            recv = torch.empty_like(acc)
            works = _shift([(acc, recv)], axis)
            p = partial((my - s - 1) % tp)
            _wait(works)
            acc = recv + p
        return _gather(acc, 0, axis).view(b, t, -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1]).float()
        dx = ctx.dot.dx(gf, w, x.dtype).view(x.shape)
        dw = ctx.dot.dw(x.reshape(-1, x.shape[-1]), gf).to(w.dtype)
        return dx, dw, None, None


def can_overlap(mesh, batch: int, seq: int, axis: str = "tp",
                batch_axes: Tuple[str, ...] = DATA_AXES) -> bool:
    """True when the reduce-scatter ring applies: tp > 1 and the LOCAL row
    count (batch and sequence after the data axes and sp) splits into tp
    chunks."""
    if mesh is None:
        return False
    tp = mesh.shape.get(axis, 1)
    if tp <= 1:
        return False
    data = 1
    for a in batch_axes:
        data *= mesh.shape.get(a, 1)
    sp = mesh.shape.get("sp", 1)
    if batch % data or seq % sp:
        return False
    return (batch // data) * (seq // sp) % tp == 0


def collective_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *, axis: str = "tp",
                      matmul: Optional[Dot] = None) -> torch.Tensor:
    """``y = x @ w`` with the contraction split over ``axis``: ``x`` is this
    rank's [B, T, K/tp] (its heads or its slice of the MLP hidden), ``w``
    its [K/tp, N] rows, already gathered over the data axes. Returns fp32
    [B, T, N], the same on every rank of ``axis``.

    Caller contract: ``can_overlap`` (the local rows divide into tp chunks)."""
    return _CollectiveMatmul.apply(x, w, _Axis(mesh, axis), matmul or FP_DOT)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, dot, dtype):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.dot, ctx.dtype = axis, dot, dtype
        n, my = axis.size, axis.index
        b, t, k = x.shape
        kn = k // n
        xf = x.reshape(b * t, k)
        # After s hops this rank holds shard (my - s) % n, rows
        # [(my-s)*kn, (my-s+1)*kn) of the whole weight, and multiplies the
        # same columns of its activations; the next shard is in flight.
        acc, w_cur = None, w.to(dtype).contiguous()
        for s in range(n):
            works = []
            if s + 1 < n:
                w_next = torch.empty_like(w_cur)
                works = _shift([(w_cur, w_next)], axis)
            c = (my - s) % n
            p = dot.forward(xf[:, c * kn:(c + 1) * kn], w_cur)
            acc = p if acc is None else acc + p
            _wait(works)
            if s + 1 < n:
                w_cur = w_next
        return acc.view(b, t, -1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        axis, dot = ctx.axis, ctx.dot
        n, my = axis.size, axis.index
        k = x.shape[-1]
        kn = k // n
        xf = x.reshape(-1, k)
        gf = g.reshape(-1, g.shape[-1]).float()

        def cols(c):
            return xf[:, c * kn:(c + 1) * kn]

        dx = torch.empty(xf.shape, dtype=x.dtype, device=x.device)
        # dx walks the weight shards again; dw rides a reduce-scatter ring
        # over the same hops: chunk c's sum starts on rank c+1 and lands
        # complete on rank c, the owner of shard c.
        w_cur = w.to(ctx.dtype).contiguous()
        dw = dot.dw(cols((my - 1) % n), gf)
        for s in range(n):
            works = []
            if s + 1 < n:
                w_next, dw_recv = torch.empty_like(w_cur), torch.empty_like(dw)
                works = _shift([(w_cur, w_next), (dw, dw_recv)], axis)
            c = (my - s) % n
            dx[:, c * kn:(c + 1) * kn] = dot.dx(gf, w_cur, x.dtype)
            if s + 1 < n:
                p = dot.dw(cols((my - s - 2) % n), gf)
            _wait(works)
            if s + 1 < n:
                w_cur, dw = w_next, dw_recv + p
        return dx.view(x.shape), dw.to(w.dtype), None, None, None


def can_fsdp_overlap(mesh, k_dim: int, batch_axes: Tuple[str, ...] = DATA_AXES) -> bool:
    """True when the all-gather ring applies to a weight with contraction
    dim ``k_dim``: more than one rank on the data axes, and ``k_dim``
    splitting into whole shards over them."""
    if mesh is None:
        return False
    data = 1
    for a in batch_axes:
        data *= mesh.shape.get(a, 1)
    return data > 1 and k_dim % data == 0


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, *,
                     batch_axes: Tuple[str, ...] = DATA_AXES,
                     matmul: Optional[Dot] = None,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ w`` for an FSDP column-parallel weight: ``x`` is this rank's
    [B/data, T, K] rows (K whole), ``w`` its [K/data, N_loc] shard (N split
    over tp). The shards travel in ``dtype`` (default w's); dw comes back in
    w's dtype, summed over the ranks in fp32. Returns fp32 [B/data, T,
    N_loc]. Peak weight memory is two shards (the one in use and the one in
    flight), not the gathered weight.

    Caller contract: ``can_fsdp_overlap(mesh, K)``."""
    return _AllGatherMatmul.apply(x, w, _Axis(mesh, batch_axes), matmul or FP_DOT,
                                  dtype or w.dtype)
