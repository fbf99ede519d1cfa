"""Device and dtype policy of the port.

- Every entry point takes an explicit device.  ``resolve_device("cuda")``
  raises when no CUDA device is present: the port never continues on the
  CPU in its place.
- Reference numerics: float32 matrix products and convolutions run in full
  float32 (TF32 off for both cuBLAS and cuDNN), so a float32 run on the
  card can be held to the CPU's results.
- Compute dtype: linear (and patch-projection) weights are cast to the
  compute dtype, bf16 on the card.  Norm parameters, the token-embedding
  table (declared float32 in the JAX LM) and the ViT CLS/position
  parameters stay float32; the models cast them where they are used, as
  the JAX modules do.
"""

from __future__ import annotations

import torch
from torch import nn


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names a CUDA device
    this process cannot use."""
    if device is None:
        raise ValueError("an explicit device is required (e.g. 'cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    return dev


def set_reference_numerics() -> None:
    """Full-float32 products on the card (no TF32 anywhere)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_for_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the weights of every ``nn.Linear`` / ``nn.Conv2d`` in ``module``
    to ``dtype`` in place; all other parameters keep their dtype."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.to(dtype)
    return module


__all__ = ["cast_for_compute", "resolve_device", "set_reference_numerics"]
