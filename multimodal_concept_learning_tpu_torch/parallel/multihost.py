"""Data parallelism over ``torch.distributed`` and the hybrid mesh
(counterpart of multimodal_concept_learning_tpu/parallel/multihost.py).

One process per card, launched by ``torchrun`` (one process per rank over
Gloo on the CPU).  The JAX trainers run one global batch sharded over a
mesh, and XLA inserts the gradient psum; here each rank runs its stripe of
the global batch and the collectives below make every number the global
batch's:

- ``init_distributed`` joins the process group that torchrun's environment
  (or explicit arguments) describes: NCCL for CUDA, Gloo for the CPU, never
  a fallback from one to the other; each rank takes ``cuda:LOCAL_RANK``.
  It returns False in a plain single process.  ``backend="gloo"`` with
  ``device_type="cuda"`` is taken only when asked for: several ranks
  sharing one card (``device_index``), which NCCL refuses.
- ``reduce_gradients`` sums the ranks' gradients (once a micro-step: the
  accumulator's mean is linear, so clipping and AdamW see the global
  gradient), so every rank applies the same update and the parameters stay
  bitwise equal.  Each train step therefore builds a per-rank loss whose
  gradients SUM to the global loss's: a sum over the rank's rows divided
  by the global count (``all_reduce_sum``), the global loss divided by the
  world size where the loss is computed from gathered rows
  (``gather_rows``), and a product of global sums through
  ``sum_over_ranks`` (the MoE aux, ``global_routing_sums``).
- ``any_rank`` agrees on a host flag (SIGTERM preemption), ``broadcast``
  sends rank 0's value (the resume step) to every rank.
- ``host_fetchable`` all-gathers every sharded parameter of a model (or
  tensor of a dict) back to its full shape, so rank 0 can save it.
- ``make_hybrid_mesh`` / ``dp_axes``: the (replica, *in-node axes) mesh
  of a multi-node run and its data-parallel axes.  Under a sharded model
  (``parallel/sharding_rules.py``) the data-parallel collectives run over
  the model's data axes (``data_group``), not the world.

On one card the path runs at world size 1 over NCCL: the same collectives,
each a copy.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from multimodal_concept_learning_tpu_torch.parallel import collectives, sharding_rules


def is_distributed() -> bool:
    """True once a process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def local_rank() -> int:
    """This process's card on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def is_main_process() -> bool:
    """True on the process that owns logging and every file written."""
    return rank() == 0


def process_device(device_type: str) -> torch.device:
    """The device this rank runs on: the card ``init_distributed`` set
    (``cuda:LOCAL_RANK`` by default), or the CPU."""
    if device_type == "cuda":
        if is_distributed():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda", local_rank())
    return torch.device(device_type)


def init_distributed(device_type: str = "cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 600.0, backend: Optional[str] = None,
                     device_index: Optional[int] = None) -> bool:
    """Join the process group, if this process is one of several.

    Without arguments the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); with none
    of it this is a plain single process and the call returns False.  With
    explicit arguments (``init_method`` such as ``tcp://localhost:PORT``,
    ``world_size``, ``rank``) or torchrun's environment any failure raises:
    ranks that silently fall back to independent single processes would
    overwrite each other's files.  The backend follows ``device_type``:
    NCCL for "cuda" (each rank on ``cuda:LOCAL_RANK``, or on
    ``cuda:device_index``), Gloo for "cpu"; ``backend="gloo"`` with "cuda"
    is the explicit choice of ranks that share a card (never taken in
    NCCL's place otherwise).  Returns True once the group is up (also
    when it already was)."""
    if is_distributed():
        return True
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda') without a CUDA device")
        backend = backend or "nccl"
        torch.cuda.set_device(local_rank() if device_index is None else device_index)
    elif device_type == "cpu":
        if backend == "nccl":
            raise ValueError("the NCCL backend needs device_type='cuda'")
        backend = "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if world_size is not None and rank is not None and not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} not in [0, {world_size})")
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  timeout=datetime.timedelta(seconds=timeout_s))
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if backend == "nccl":  # binds the communicator to this rank's card up front
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kwargs)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_distributed():
        collectives.clear_groups()
        dist.destroy_process_group()


def host_fetchable(tree):
    """A parameter tree safe to read (and save) on every rank: a sharded
    model's full state dict (``sharding_rules.full_state_dict``), a dict
    whose sharded tensors are all-gathered to their full shapes, and
    anything replicated as it is.  A collective call under a sharded
    model: every rank calls it."""
    if isinstance(tree, nn.Module):
        if sharding_rules.layout_of(tree) is None:
            return tree
        return sharding_rules.full_state_dict(tree)
    if isinstance(tree, dict):
        return {k: host_fetchable(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and hasattr(tree, "_mcl_shard"):
        return sharding_rules.gather_full(tree)
    return tree


def hybrid_mesh_shape(ici_shape: Sequence[int], axis_names: Sequence[str],
                      num_slices: Optional[int], replica_axis: str,
                      world: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the hybrid mesh over ``world`` ranks (the
    checks of JAX ``make_hybrid_mesh``)."""
    per_slice = math.prod(ici_shape)
    if num_slices is None:
        num_slices = world // per_slice
    want = num_slices * per_slice
    if world < want:
        raise ValueError(f"hybrid mesh needs {num_slices}x{per_slice}={want} devices, "
                         f"have {world}")
    if world != want:
        raise ValueError(f"hybrid mesh of {want} devices over a world of {world}: "
                         "every rank must be in the mesh")
    if len(axis_names) != len(ici_shape):
        raise ValueError(f"axis_names {tuple(axis_names)} vs ici_shape {tuple(ici_shape)}")
    return (num_slices, *tuple(ici_shape)), (replica_axis, *tuple(axis_names))


def make_hybrid_mesh(ici_shape: Sequence[int], axis_names: Sequence[str] = ("data", "model"),
                     num_slices: Optional[int] = None, replica_axis: str = "replica",
                     device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``(num_slices, *ici_shape)`` with axes
    ``(replica_axis, *axis_names)``.  A slice is a node: torchrun numbers a
    node's ranks consecutively (``LOCAL_WORLD_SIZE`` of them), so each
    mesh row is one node's ranks; without a node count the ranks are
    grouped contiguously, as JAX groups virtual devices.  ``replica_axis``
    strides across nodes (data parallelism only); the other axes tile a
    node."""
    from multimodal_concept_learning_tpu_torch.parallel.mesh import make_mesh

    shape, names = hybrid_mesh_shape(ici_shape, axis_names, num_slices, replica_axis,
                                     world_size())
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) not in (0, math.prod(ici_shape)) and shape[0] > 1:
        raise ValueError(f"a node holds {local} ranks; the in-node mesh "
                         f"{tuple(ici_shape)} needs {math.prod(ici_shape)}")
    return make_mesh(device_type, axis_names=names, shape=shape)


def dp_axes(mesh, replica_axis: str = "replica", data_axis: str = "data") -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh``: the replica axis (when the mesh
    has one) plus the in-node data axis."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in (replica_axis, data_axis) if a in names)
    if not axes:
        raise ValueError(f"mesh {names} has no data-parallel axis")
    return axes


def dp_stripe(mesh, axes=None) -> Tuple[int, int]:
    """(this rank's stripe, number of stripes) of a batch striped over the
    data-parallel ``axes`` of ``mesh`` (default ``dp_axes``): the ranks
    that differ only along the other axes hold the same stripe."""
    group = collectives.mesh_group(mesh, dp_axes(mesh) if axes is None else axes)
    return group.index, group.size


def data_group(model):
    """The ``AxisGroup`` of a sharded model's data axes, or None (the
    world) for a model that is not sharded."""
    layout = getattr(model, "_mcl_layout", None)
    return None if layout is None else layout.data_group()


def group_size(group=None) -> int:
    """The size of ``group`` (an ``AxisGroup``; None: the world)."""
    return world_size() if group is None else group.size


def _comm_device() -> torch.device:
    """Where a host value's tensor must live for the group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (an ``AxisGroup``;
    None: the world) -- a new tensor, no gradient; ``t`` itself without a
    process group."""
    if not is_distributed():
        return t
    if group is not None:
        return collectives.all_reduce(t.detach(), group)
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the identity, because
    the ranks' gradients are summed afterwards (``reduce_gradients``), so a
    function of the global sum gets its exact global gradient."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (None: the world),
    differentiable (see ``_SumOverRanks``)."""
    return _SumOverRanks.apply(t, group) if is_distributed() else t


def global_routing_sums(frac_sum: torch.Tensor, prob_sum: torch.Tensor, n: int, group=None):
    """``ops.moe.MoEAux.reduce`` for a data-parallel step: the routing sums
    over the global batch (the ranks of ``group``, None: the world), so the
    aux is the product of global means."""
    both = sum_over_ranks(torch.stack([frac_sum, prob_sum]), group)
    return both[0], both[1], n * group_size(group)


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, concatenated in rank order.  Backward:
    this rank's rows of the gradient summed over the ranks (each rank's
    loss then holds a 1/world share of the global loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        if group is not None:
            return collectives.all_gather(t, group, 0)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_sum(grad.contiguous(), ctx.group)
        start = (dist.get_rank() if ctx.group is None else ctx.group.index) * ctx.rows
        return grad[start:start + ctx.rows], None


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The global batch's rows of ``t`` (equal row counts on every rank of
    ``group``, None: the world), differentiable; ``t`` without a process
    group."""
    return _GatherRows.apply(t, group) if is_distributed() else t


def reduce_gradients(grads: Iterable[torch.Tensor], params: Iterable[torch.Tensor] = None) -> None:
    """Sum each gradient over the ranks, in place: over the world, or for a
    parameter of a sharded model over its ``reduce_axes`` (the data axes
    its FSDP gather has not already summed)."""
    if not is_distributed():
        return
    params = [None] * len(grads) if params is None else list(params)
    for g, p in zip(grads, params):
        info = getattr(p, "_mcl_shard", None)
        if info is None:
            dist.all_reduce(g)
        elif info.reduce_axes:
            g.copy_(collectives.all_reduce(g, info.layout.group(info.reduce_axes)))


def global_sq_norm(grads: Iterable[torch.Tensor], params: Iterable[torch.Tensor]) -> torch.Tensor:
    """The squared global norm of a sharded model's gradients: each
    sharded parameter's squared local norm summed over its shard axes,
    the replicated ones counted once (a plain sum without a sharded
    parameter)."""
    buckets: Dict[tuple, torch.Tensor] = {}
    layout = None
    for g, p in zip(grads, params):
        info = getattr(p, "_mcl_shard", None)
        key = () if info is None else tuple(sorted(info.shard_axes()))
        layout = layout or (info.layout if info is not None else None)
        sq = torch.sum(g.float() * g.float())
        buckets[key] = buckets[key] + sq if key in buckets else sq
    total = None
    for axes in sorted(buckets):  # the same groups in the same order on every rank
        sq = buckets[axes]
        if axes:
            sq = collectives.all_reduce(sq, layout.group(axes))
        total = sq if total is None else total + sq
    return total


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any (an all-reduce MAX)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast(value, src: int = 0):
    """Rank ``src``'s picklable ``value`` on every rank."""
    if not is_distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, device=_comm_device())
    return box[0]


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def _stripe_rows(batch: Dict[str, np.ndarray]) -> int:
    """The row count of a stripe: its ``valid`` mask's, else the largest
    leading dimension."""
    if "valid" in batch:
        return len(batch["valid"])
    return max(np.shape(v)[0] for v in batch.values() if np.ndim(v))


def global_batch_from_local(local_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """This rank's stripe of a global batch as tensors on ``device``.  The
    leaves that are not batch-shaped (leading dimension other than the
    stripe's rows: the uint8 pipeline's ``norm_mean`` / ``norm_std``) must
    be equal on every rank: ValueError otherwise (the JAX function
    replicates them).  With one process per rank every leaf's global rows
    divide over the ranks, so the rows, not the JAX divisibility policy
    (``mesh.is_batch_leaf``), tell a batch leaf.  On an N-D mesh the
    stripe is this rank's over the data-parallel axes (``dp_stripe``: the
    ranks that differ only along the model axis load the same rows)."""
    from multimodal_concept_learning_tpu_torch.parallel.mesh import shard_batch

    rows = _stripe_rows(local_batch)
    shared = {k: np.asarray(v) for k, v in local_batch.items()
              if not (np.ndim(v) and np.shape(v)[0] == rows)}
    if shared and is_distributed():
        mine = {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in shared.items()}
        everyone = [None] * world_size()
        dist.all_gather_object(everyone, mine)
        differ = sorted(k for k in mine if any(o.get(k) != mine[k] for o in everyone))
        if differ:
            raise ValueError(f"non-batch leaves differ across ranks: {differ}")
    return shard_batch(local_batch, device)


__all__ = ["all_reduce_sum", "any_rank", "barrier", "broadcast", "data_group", "dp_axes",
           "dp_stripe", "gather_rows", "global_batch_from_local", "global_routing_sums",
           "global_sq_norm", "group_size", "host_fetchable", "hybrid_mesh_shape",
           "init_distributed", "is_distributed", "is_main_process", "local_rank",
           "make_hybrid_mesh", "process_device", "rank", "reduce_gradients", "shutdown",
           "sum_over_ranks", "world_size"]
