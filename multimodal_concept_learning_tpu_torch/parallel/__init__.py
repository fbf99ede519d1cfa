"""Training loop pieces and parallelism: the optimizer, the train and
eval steps (``train_step.py``), the process group, its collectives and
the hybrid mesh (``multihost.py``, ``collectives.py``), the N-D mesh
(``mesh.py``), the sharding rules (``sharding_rules.py``), sharded
serving (``serving.py``), pipeline (``pipeline.py``) and sequence
(``ring_attention.py``) parallelism."""

from multimodal_concept_learning_tpu_torch.parallel.mesh import (
    batch_sharding,
    is_batch_leaf,
    leaf_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from multimodal_concept_learning_tpu_torch.parallel.multihost import (
    dp_axes,
    global_batch_from_local,
    host_fetchable,
    init_distributed,
    is_main_process,
    make_hybrid_mesh,
)
from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
    build_optimizer,
    cosine_epoch_schedule,
)

__all__ = ["batch_sharding", "build_optimizer", "cosine_epoch_schedule", "dp_axes",
           "global_batch_from_local", "host_fetchable", "init_distributed", "is_batch_leaf",
           "is_main_process", "leaf_sharding", "make_hybrid_mesh", "make_mesh",
           "replicated_sharding", "shard_batch"]
