"""Data parallelism over ``torch.distributed`` (counterpart of
multimodal_concept_learning_tpu/parallel/multihost.py:37-71, :160-231).

One process per card, launched by ``torchrun`` (one process per rank over
Gloo on the CPU).  The JAX trainers run one global batch sharded over a
mesh, and XLA inserts the gradient psum; here each rank runs its stripe of
the global batch and the collectives below make every number the global
batch's:

- ``init_distributed`` joins the process group that torchrun's environment
  (or explicit arguments) describes: NCCL for CUDA, Gloo for the CPU, never
  a fallback from one to the other; each rank takes ``cuda:LOCAL_RANK``.
  It returns False in a plain single process.
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
- ``host_fetchable`` is the identity while the parameters are replicated.

On one card the path runs at world size 1 over NCCL: the same collectives,
each a copy.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


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
    """The device this rank runs on: ``cuda:LOCAL_RANK`` or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank())
    return torch.device(device_type)


def init_distributed(device_type: str = "cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the process group, if this process is one of several.

    Without arguments the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); with none
    of it this is a plain single process and the call returns False.  With
    explicit arguments (``init_method`` such as ``tcp://localhost:PORT``,
    ``world_size``, ``rank``) or torchrun's environment any failure raises:
    ranks that silently fall back to independent single processes would
    overwrite each other's files.  The backend follows ``device_type``:
    NCCL for "cuda" (each rank on ``cuda:LOCAL_RANK``), Gloo for "cpu".
    Returns True once the group is up (also when it already was)."""
    if is_distributed():
        return True
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device_type='cuda') without a CUDA device")
        backend = "nccl"
        torch.cuda.set_device(local_rank())
    elif device_type == "cpu":
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
        kwargs["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(**kwargs)
    return True


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if is_distributed():
        dist.destroy_process_group()


def host_fetchable(tree):
    """A parameter tree safe to read on every rank: the identity, since
    data parallelism replicates every parameter."""
    return tree


def _comm_device() -> torch.device:
    """Where a host value's tensor must live for the group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor, no gradient; ``t``
    itself without a process group)."""
    if not is_distributed():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over the ranks.  Backward: the identity, because
    the ranks' gradients are summed afterwards (``reduce_gradients``), so a
    function of the global sum gets its exact global gradient."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable (see ``_SumOverRanks``)."""
    return _SumOverRanks.apply(t) if is_distributed() else t


def global_routing_sums(frac_sum: torch.Tensor, prob_sum: torch.Tensor, n: int):
    """``ops.moe.MoEAux.reduce`` for a data-parallel step: the routing sums
    over the global batch, so the aux is the product of global means."""
    both = sum_over_ranks(torch.stack([frac_sum, prob_sum]))
    return both[0], both[1], n * world_size()


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, concatenated in rank order.  Backward:
    this rank's rows of the gradient summed over the ranks (each rank's
    loss then holds a 1/world share of the global loss)."""

    @staticmethod
    def forward(ctx, t):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        ctx.rows = t.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``t`` (equal row counts on every rank),
    differentiable; ``t`` without a process group."""
    return _GatherRows.apply(t) if is_distributed() else t


def reduce_gradients(grads: Iterable[torch.Tensor]) -> None:
    """Sum each gradient over the ranks, in place."""
    if not is_distributed():
        return
    for g in grads:
        dist.all_reduce(g)


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
    (``mesh.is_batch_leaf``), tell a batch leaf."""
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


__all__ = ["all_reduce_sum", "any_rank", "barrier", "broadcast", "gather_rows",
           "global_batch_from_local", "global_routing_sums", "host_fetchable",
           "init_distributed", "is_distributed", "is_main_process", "local_rank",
           "process_device", "rank", "reduce_gradients", "shutdown", "sum_over_ranks",
           "world_size"]
