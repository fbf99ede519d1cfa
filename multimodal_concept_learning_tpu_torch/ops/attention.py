"""Multi-head attention (counterpart of multimodal_concept_learning_tpu/ops/attention.py).

``multi_head_attention`` keeps the JAX function's contract: [B, T, H, D]
tensors, GQA by grouping (kv heads fewer than q heads, never repeated), an
additive bias broadcastable to [B, H, Tq, Tk] and an optional scale
(default ``head_dim ** -0.5``).  It also takes the kernel's mask
descriptors (``kv_lens``, ``causal``, ``window``), which the models use in
place of a materialised bias.

Dispatch: a CUDA tensor runs the K1 forward kernel
(ops/flash_attention.py) at any shape it supports; a CPU tensor runs the
plain version.  There is no shape or length gate and no dropout (the port
serves; dropout belongs to the training slice).
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.ops.flash_attention import (
    _NEG,
    flash_attention,
    key_mask,
)


def multi_head_attention(q, k, v, bias=None, *, scale: Optional[float] = None,
                         kv_lens=None, causal: bool = False,
                         window: Optional[int] = None) -> torch.Tensor:
    """Scaled dot-product attention; q [B, Tq, Hq, D], k/v [B, Tk, Hk, D]."""
    return flash_attention(q, k, v, bias, scale=scale, kv_lens=kv_lens,
                           causal=causal, window=window)


def make_attention_bias(attention_mask: Optional[torch.Tensor], causal: bool,
                        q_len: int, k_len: int, dtype=torch.float32,
                        window: Optional[int] = None, device=None) -> Optional[torch.Tensor]:
    """Additive bias from a [B, Tk] 1/0 key mask, causality (offset
    ``k_len - q_len``) and a sliding window (``qi - ki < window``), with the
    JAX package's finite -1e30 for masked entries."""
    if attention_mask is not None:
        device = attention_mask.device
    bias = None
    if attention_mask is not None:
        pad = (1.0 - attention_mask.to(dtype)) * _NEG
        bias = pad[:, None, None, :]
    if causal or window is not None:
        ok = key_mask(1, q_len, k_len, causal=causal, window=window, device=device)
        mask_bias = torch.where(ok, 0.0, _NEG).to(dtype)
        bias = mask_bias if bias is None else bias + mask_bias
    return bias


__all__ = ["make_attention_bias", "multi_head_attention"]
