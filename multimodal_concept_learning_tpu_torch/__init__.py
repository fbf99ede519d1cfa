"""PyTorch/CUDA port of multimodal_concept_learning_tpu.

A second package beside the JAX one, mirroring its layout (``ops/``,
``models/``, ``parallel/``, ``data/``, ``train/``, ``serve/``).  It imports
torch and numpy, never jax, flax or optax.  Plain tensor code is PyTorch;
each Pallas TPU kernel on a ported path is a CUDA kernel written for Hopper
(``csrc/``, built on first use by ``ops/_build.py``).  The JAX package
stays the reference: tests run both on the same seeded inputs.

Ported so far: the paged serving path (``serve/server.py --paged``) and
multimodal concept-learning training (``train/multimodal_training.py``),
with the K1 forward and backward (fused attention) and K3 (paged decode
attention) kernels.
"""

__version__ = "0.1.0"
