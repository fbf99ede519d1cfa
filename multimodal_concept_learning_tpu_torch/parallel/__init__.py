"""Training loop pieces and data parallelism: the optimizer, the train and
eval steps (``train_step.py``), the process group and its collectives
(``multihost.py``) and the 1-D data mesh (``mesh.py``)."""

from multimodal_concept_learning_tpu_torch.parallel.mesh import (
    is_batch_leaf,
    leaf_sharding,
    make_mesh,
    shard_batch,
)
from multimodal_concept_learning_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    host_fetchable,
    init_distributed,
    is_main_process,
)
from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
    build_optimizer,
    cosine_epoch_schedule,
)

__all__ = ["build_optimizer", "cosine_epoch_schedule", "global_batch_from_local",
           "host_fetchable", "init_distributed", "is_batch_leaf", "is_main_process",
           "leaf_sharding", "make_mesh", "shard_batch"]
