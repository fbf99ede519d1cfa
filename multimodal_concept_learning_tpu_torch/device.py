"""Device and dtype policy of the port.

- Every entry point takes an explicit device.  ``resolve_device("cuda")``
  raises when no CUDA device is present: the port never continues on the
  CPU in its place.
- Reference numerics: float32 matrix products and convolutions run in full
  float32 (TF32 off for both cuBLAS and cuDNN), so a float32 run on the
  card can be held to the CPU's results.
- Compute dtype: the models cast every parameter where they use it, as
  flax modules with ``dtype=bf16`` over float32 parameters do: linear and
  patch-projection weights to the compute dtype (``linear``), norm
  parameters to float32.  So a model computes the same numbers whether a
  weight is stored in float32 or already in the compute dtype.
- ``cast_for_compute`` stores linear weights in the compute dtype once.
  Serving casts every one of them.  Training keeps the parameters it
  trains in float32 (AdamW updates float32 values, as the JAX trainer's
  float32 ``param_dtype`` does) and casts only the frozen ones
  (``only_frozen=True``): casting once or at every use gives the same
  numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


def cast_for_compute(module: nn.Module, dtype: torch.dtype,
                     only_frozen: bool = False) -> nn.Module:
    """Store the weights and biases of every ``nn.Linear`` / ``nn.Conv2d``
    in ``module`` in ``dtype``, in place (with ``only_frozen``: those with
    ``requires_grad=False``); all other parameters keep their dtype."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            for p in m.parameters(recurse=False):
                if not (only_frozen and p.requires_grad):
                    p.data = p.data.to(dtype)
    return module


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` in the compute dtype: input, weight and bias cast to
    ``dtype`` at use (a no-op for a weight already stored in it)."""
    bias = layer.bias
    return F.linear(x.to(dtype), layer.weight.to(dtype), None if bias is None else bias.to(dtype))


__all__ = ["cast_for_compute", "linear", "resolve_device", "set_reference_numerics"]
