"""Device mesh and batch placement (counterpart of
multimodal_concept_learning_tpu/parallel/mesh.py).

The JAX package shards one global batch over a 1-D ``("data",)`` mesh of
the process's chips.  Here each rank is one process on one card, so the
mesh is a 1-D ``DeviceMesh`` over the world and "sharding" a batch is each
rank holding its own stripe of it (``data/pipeline.BatchLoader``'s
``process_shard``) on its card.  ``is_batch_leaf`` / ``leaf_sharding``
keep the JAX shard-or-replicate policy: a leaf is a batch leaf when its
global leading dimension divides over the shards, and is replicated (the
same on every rank) otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.parallel import multihost


def make_mesh(device_type: Optional[str] = None):
    """A 1-D ``DeviceMesh`` named ``("data",)`` over every rank (the
    process group must be up: ``multihost.init_distributed``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not multihost.is_distributed():
        raise RuntimeError("make_mesh needs a process group (init_distributed)")
    if device_type is None:
        device_type = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (multihost.world_size(),), mesh_dim_names=("data",))


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


__all__ = ["is_batch_leaf", "leaf_sharding", "make_mesh", "shard_batch"]
