"""Device mesh and batch placement (counterpart of
multimodal_concept_learning_tpu/parallel/mesh.py).

The JAX package shards one global batch over a mesh of the process's
chips.  Here each rank is one process on one card, so the mesh is an N-D
``DeviceMesh`` over the world (a 1-D ``("data",)`` one by default; ranks
in the row-major order of JAX's ``np.reshape`` of the device list) and
"sharding" a batch is each rank holding its own stripe of it
(``data/pipeline.BatchLoader``'s ``process_shard``) on its card.
``batch_sharding`` / ``replicated_sharding`` are the placements: a
``Placement`` names the mesh axes a batch's leading dimension is striped
over (none: replicated) and takes this rank's rows of a global array.  ``is_batch_leaf`` / ``leaf_sharding``
keep the JAX shard-or-replicate policy: a leaf is a batch leaf when its
global leading dimension divides over the shards, and is replicated (the
same on every rank) otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.parallel import multihost


def make_mesh(device_type: Optional[str] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` over every rank (the process group must be up:
    ``multihost.init_distributed``): 1-D ``("data",)`` unless a ``shape``
    is given (e.g. ``shape=(4, 2), axis_names=("data", "model")``).
    ``device_type`` defaults to the card under NCCL, else the CPU (a Gloo
    group of ranks sharing a card passes "cuda")."""
    from torch.distributed.device_mesh import init_device_mesh

    if not multihost.is_distributed():
        raise RuntimeError("make_mesh needs a process group (init_distributed)")
    if device_type is None:
        device_type = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    world = multihost.world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"axis_names {tuple(axis_names)} vs shape {shape}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, have {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Placement:
    """A batch's placement on ``mesh``: its leading dimension striped over
    ``axes`` (empty: replicated on every rank)."""

    mesh: object
    axes: Tuple[str, ...]

    def stripe(self) -> Tuple[int, int]:
        """(this rank's stripe, number of stripes)."""
        if not self.axes:
            return 0, 1
        return multihost.dp_stripe(self.mesh, self.axes)

    def local(self, x):
        """This rank's rows of the global array ``x``."""
        index, count = self.stripe()
        rows = x.shape[0]
        if rows % count:
            raise ValueError(f"the batch of {rows} rows does not divide over {count} stripes "
                             f"of {self.axes}")
        return x[index * rows // count:(index + 1) * rows // count]


def batch_sharding(mesh, axis="data") -> Placement:
    """The leading (batch) dimension striped over ``axis`` (a name or a
    tuple of names, e.g. ``multihost.dp_axes(mesh)``)."""
    return Placement(mesh, (axis,) if isinstance(axis, str) else tuple(axis))


def replicated_sharding(mesh) -> Placement:
    return Placement(mesh, ())


def is_batch_leaf(leaf, shards: int, global_rows_factor: int = 1) -> bool:
    """The JAX policy: a leaf takes the batch sharding iff its global
    leading dimension (local rows x ``global_rows_factor``) divides by the
    shard count."""
    rows = getattr(leaf, "shape", ())[:1]
    return (getattr(leaf, "ndim", 0) >= 1 and rows[0] > 0
            and (rows[0] * global_rows_factor) % shards == 0)


def leaf_sharding(leaf, shards: int) -> str:
    """"shard" for a batch leaf of a host batch, "replicate" otherwise."""
    return "shard" if is_batch_leaf(leaf, shards) else "replicate"


def shard_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """This rank's stripe (a host batch) as tensors on its device; the
    replicated leaves go along unchanged (``data.pipeline.to_device``)."""
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device

    return to_device({k: np.asarray(v) for k, v in batch.items()}, device)


__all__ = ["Placement", "batch_sharding", "is_batch_leaf", "leaf_sharding", "make_mesh",
           "replicated_sharding", "shard_batch"]
