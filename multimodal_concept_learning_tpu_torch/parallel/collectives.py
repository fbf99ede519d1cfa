"""Collectives over the axes of a device mesh, and the differentiable
operators that tensor, fully-sharded, pipeline and sequence parallelism
are built from.

The JAX package runs one program over a mesh and GSPMD inserts these
collectives; the port runs one process per device, each holding its local
shard as a plain tensor, and calls them explicitly:

- ``AxisGroup``: the ranks that differ only along some mesh axes, in the
  axes' row-major order (a JAX ``PartitionSpec`` entry ``("model",
  "data")`` is model-major).  ``mesh_group(mesh, axes)`` makes them (a
  collective call: every rank makes every group of the partition, in one
  order).
- Primitives (no gradient): ``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``broadcast``, ``all_reduce_max`` and point-to-point
  ``send`` / ``recv``.  A Gloo group takes CUDA tensors only for
  ``all_reduce`` and ``broadcast`` (the two-ranks-one-card mode), so the
  other primitives stage a CUDA tensor through a host copy when the
  group's backend is Gloo; bf16 travels as float32 on Gloo (exact).
- Autograd operators (Megatron's f and g and their relatives):
  ``copy_to`` (identity forward, all-reduce backward: a replicated value
  entering rank-specific work), ``reduce_from`` (all-reduce forward,
  identity backward: the partial sums of a row-parallel product),
  ``gather_from`` (all-gather forward, this rank's chunk backward),
  ``scatter_to`` (this rank's chunk forward, all-gather backward),
  ``gather_sum_grad`` (all-gather forward, reduce-scatter backward: an
  FSDP-sharded parameter used by ranks that hold different data), and
  ``ring_shift`` (send to the next rank of the ring, receive from the
  previous; backward the other way round).

``COUNTS`` counts the primitives' calls by name, as the kernel wrappers
count launches.  A group of one rank made by ``mesh_group`` has no
process group, and every collective over it is the identity (counted as
nothing); a one-rank ``AxisGroup`` given a process group runs them.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()

# (id(mesh), axes) -> (mesh, AxisGroup); groups live as long as the process group
_GROUPS: Dict[tuple, tuple] = {}


def reset_counts() -> None:
    COUNTS.clear()


class AxisGroup:
    """This rank's group along ``axes`` of a mesh: ``ranks`` (global ranks
    in the axes' row-major order), ``index`` (this rank's place in it) and
    ``size``.  A group of one rank has no process group and every
    collective over it is the identity."""

    def __init__(self, axes: Tuple[str, ...], ranks: Sequence[int], pg=None):
        self.axes = tuple(axes)
        self.ranks = [int(r) for r in ranks]
        self.size = len(self.ranks)
        self.pg = pg
        me = dist.get_rank() if dist.is_initialized() else 0
        self.index = self.ranks.index(me) if me in self.ranks else 0
        # dist returns gathered lists in ascending global-rank order
        order = sorted(self.ranks)
        self._from_sorted = [order.index(r) for r in self.ranks]
        self.gloo = pg is not None and dist.get_backend(pg) == "gloo"

    def __repr__(self) -> str:
        return f"AxisGroup(axes={self.axes}, ranks={self.ranks}, index={self.index})"

    def global_rank(self, index: int) -> int:
        return self.ranks[index % self.size]


def mesh_group(mesh, axes) -> AxisGroup:
    """This rank's ``AxisGroup`` along ``axes`` (a name or a tuple of names)
    of a ``DeviceMesh``; made once per (mesh, axes), by every rank."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    key = (id(mesh), axes)
    if key in _GROUPS and _GROUPS[key][0] is mesh:
        return _GROUPS[key][1]
    names = list(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh {tuple(names)} has no axis {a!r}")
    ranks = mesh.mesh.reshape(mesh.shape)
    # move the group's axes last, in the group's order: each row is one group
    others = [names.index(a) for a in names if a not in axes]
    inner = [names.index(a) for a in axes]
    size = 1
    for i in inner:
        size *= ranks.shape[i]
    rows = ranks.permute(*others, *inner).reshape(-1, size)
    me = dist.get_rank()
    mine = None
    for row in rows.tolist():
        pg = dist.new_group(sorted(row)) if len(row) > 1 else None
        if me in row:
            mine = AxisGroup(axes, row, pg)
    if mine is None:
        raise ValueError(f"rank {me} is not in the mesh")
    _GROUPS[key] = (mesh, mine)  # the mesh stays alive, so its id is not reused
    return mine


def clear_groups() -> None:
    """Forget the cached groups (before the process group goes down)."""
    _GROUPS.clear()


# -- primitives ---------------------------------------------------------------------


def _wire(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``t`` as the group's backend takes it for gather-type collectives
    and point-to-point: a contiguous host copy on Gloo (bf16 as float32)."""
    if group.gloo:
        t = t.detach().to("cpu", torch.float32 if t.dtype == torch.bfloat16 else t.dtype)
    return t.contiguous()


def _wire_reduce(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """A clone to reduce or broadcast in place (Gloo: CUDA allowed, bf16 as float32)."""
    if group.gloo and t.dtype == torch.bfloat16:
        return t.detach().float().contiguous()
    return t.detach().clone().contiguous()


def all_reduce(t: torch.Tensor, group: AxisGroup, op=None) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the group, a new tensor."""
    if group.pg is None:
        return t
    COUNTS["all_reduce"] += 1
    buf = _wire_reduce(t, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op, group=group.pg)
    return buf.to(t.dtype)


def all_reduce_max(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    return all_reduce(t, group, dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, group: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in the group's order."""
    if group.pg is None:
        return t
    COUNTS["all_gather"] += 1
    buf = _wire(t, group)
    parts = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(parts, buf, group=group.pg)
    parts = [parts[i] for i in group._from_sorted]
    return torch.cat(parts, dim=dim).to(t.device, t.dtype)


def reduce_scatter(t: torch.Tensor, group: AxisGroup, dim: int = 0) -> torch.Tensor:
    """This rank's chunk (along ``dim``, in the group's order) of the sum
    of ``t`` over the group.  Gloo has no reduce-scatter: an all-reduce,
    then the chunk."""
    if group.pg is None:
        return t
    COUNTS["reduce_scatter"] += 1
    if group.gloo:
        buf = _wire_reduce(t, group)
        dist.all_reduce(buf, group=group.pg)
        return buf.chunk(group.size, dim=dim)[group.index].to(t.dtype).contiguous()
    chunks = t.detach().chunk(group.size, dim=dim)
    by_pg = [chunks[group._from_sorted.index(p)] for p in range(group.size)]
    src = torch.cat([c.movedim(dim, 0).contiguous() for c in by_pg], dim=0)
    out = torch.empty_like(by_pg[0].movedim(dim, 0).contiguous())
    dist.reduce_scatter_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, group: AxisGroup, src_index: int = 0) -> torch.Tensor:
    """``t`` of the group's ``src_index``-th rank, on every rank (a new
    tensor of ``t``'s shape and type)."""
    if group.pg is None:
        return t
    COUNTS["broadcast"] += 1
    buf = _wire_reduce(t, group)
    dist.broadcast(buf, src=group.global_rank(src_index), group=group.pg)
    return buf.to(t.dtype)


def send(t: torch.Tensor, group: AxisGroup, dst_index: int):
    """Start sending ``t`` to the group's ``dst_index``-th rank; returns a
    handle whose ``wait()`` ends the send (the host copy stays alive in it)."""
    COUNTS["send"] += 1
    buf = _wire(t, group)
    work = dist.isend(buf, dst=group.global_rank(dst_index), group=group.pg)
    return _Sent(work, buf)


class _Sent:
    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self):
        self.work.wait()


def recv(like: torch.Tensor, group: AxisGroup, src_index: int) -> torch.Tensor:
    """A tensor shaped and typed as ``like``, received from the group's
    ``src_index``-th rank, on ``like``'s device."""
    COUNTS["recv"] += 1
    buf = _wire(torch.empty_like(like), group)
    dist.recv(buf, src=group.global_rank(src_index), group=group.pg)
    return buf.to(like.device, like.dtype)


def chunk_of(t: torch.Tensor, group: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (no communication)."""
    if group.size == 1:
        return t
    if t.shape[dim] % group.size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide over "
                         f"{group.size} ranks of {group.axes}")
    return t.chunk(group.size, dim=dim)[group.index]


# -- differentiable operators -------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim, sum_grad):
        ctx.group, ctx.dim, ctx.sum_grad = group, dim, sum_grad
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grad:
            return reduce_scatter(grad.contiguous(), ctx.group, ctx.dim), None, None, None
        return chunk_of(grad, ctx.group, ctx.dim).contiguous(), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk_of(t, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.group, ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, +1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad.contiguous(), ctx.group, -1), None


def _shift(t: torch.Tensor, group: AxisGroup, step: int) -> torch.Tensor:
    """Send ``t`` ``step`` places along the ring, receive from ``-step``."""
    if group.size == 1:
        return t
    handle = send(t, group, group.index + step)
    out = recv(t, group, group.index - step)
    handle.wait()
    return out


def copy_to(t: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron's f)."""
    if group is None or group.pg is None:
        return t
    return _CopyTo.apply(t, group)


def reduce_from(t: torch.Tensor, group: Optional[AxisGroup]) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron's g)."""
    if group is None or group.pg is None:
        return t
    return _ReduceFrom.apply(t, group)


def gather_from(t: torch.Tensor, group: Optional[AxisGroup], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward this rank's chunk of the
    (replicated) gradient."""
    if group is None or group.pg is None:
        return t
    return _GatherFrom.apply(t, group, dim % t.dim(), False)


def gather_sum_grad(t: torch.Tensor, group: Optional[AxisGroup], dim: int) -> torch.Tensor:
    """All-gather along ``dim`` forward; backward the reduce-scatter of the
    ranks' gradients (their sum, this rank's chunk)."""
    if group is None or group.pg is None:
        return t
    return _GatherFrom.apply(t, group, dim % t.dim(), True)


def scatter_to(t: torch.Tensor, group: Optional[AxisGroup], dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` forward; backward the all-gather."""
    if group is None or group.pg is None:
        return t
    return _ScatterTo.apply(t, group, dim % t.dim())


def ring_shift(t: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``t`` of the previous rank of the ring (differentiable)."""
    if group.size == 1:
        return t
    return _RingShift.apply(t, group)


def combined_index(coords: Dict[str, int], sizes: Dict[str, int], axes) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dimension sharded over
    ``axes`` (a name or a tuple, the first the most significant)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    index, count = 0, 1
    for a in axes:
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


__all__ = ["AxisGroup", "COUNTS", "all_gather", "all_reduce", "all_reduce_max", "broadcast",
           "chunk_of", "clear_groups", "combined_index", "copy_to", "gather_from",
           "gather_sum_grad", "mesh_group", "recv", "reduce_from", "reduce_scatter",
           "reset_counts", "ring_shift", "scatter_to", "send"]
