"""Image inputs of a batch (counterpart of
multimodal_concept_learning_tpu/ops/preprocess.py).

Two batch contracts: float32 NCHW ``images`` (the collator's), or uint8
NHWC ``images_u8`` with ``norm_mean`` / ``norm_std`` (the
``device_normalize`` pipeline: the host ships 4x fewer bytes, and the device
computes ``(x / 255 - mean) / std``).  The port's ViT takes NCHW, so the
uint8 path is normalised and transposed on the device.
"""

from __future__ import annotations

import torch


def device_preprocess(images_u8: torch.Tensor, mean: torch.Tensor,
                      std: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> normalised float32 [B, 3, H, W]."""
    x = images_u8.float() * (1.0 / 255.0)
    x = (x - mean.float().reshape(1, 1, 1, 3)) / std.float().reshape(1, 1, 1, 3)
    return x.permute(0, 3, 1, 2)


def images_from_batch(batch) -> torch.Tensor:
    """The model's NCHW float images from either contract."""
    if "images_u8" in batch:
        return device_preprocess(batch["images_u8"], batch["norm_mean"], batch["norm_std"])
    return batch["images"]


def batch_channels_last(batch) -> bool:
    """True when the batch rides the uint8 NHWC path."""
    return "images_u8" in batch


__all__ = ["batch_channels_last", "device_preprocess", "images_from_batch"]
