"""Multi-head attention (counterpart of multimodal_concept_learning_tpu/ops/attention.py).

``multi_head_attention`` keeps the JAX function's contract: [B, T, H, D]
tensors, GQA by grouping (kv heads fewer than q heads, never repeated), an
additive bias broadcastable to [B, H, Tq, Tk] and an optional scale
(default ``head_dim ** -0.5``).  It also takes the kernel's mask
descriptors (``kv_lens``, ``causal``, ``window``), which the models use in
place of a materialised bias.

Dispatch: a CUDA tensor runs the K1 kernels (ops/flash_attention.py:
forward, and the dQ and dK/dV kernels when a gradient flows) at any shape
they support; a CPU tensor runs the plain versions.  There is no shape or
length gate.  Only a call with ``dropout_rate > 0`` and not
``deterministic`` takes the JAX function's dense branch instead
(``multimodal_concept_learning_tpu/ops/attention.py:62-89``): float32
logits and softmax, the probabilities cast to the compute dtype, a
bernoulli keep mask drawn from the caller's ``torch.Generator``, then the
value product.  K1 computes no dropout, and the JAX package computes this
branch outside any Pallas kernel, so the dense branch is the ported
function itself and not a plain version standing in for a kernel.  Its
masks match JAX's only in distribution: the random streams differ.
``dropout`` is flax ``nn.Dropout`` on the same generator.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.ops.flash_attention import (
    _NEG,
    _grouped_logits,
    flash_attention,
    key_mask,
)
from multimodal_concept_learning_tpu_torch.utils.profiling import span


def _keep_mask(shape, rate: float, generator: Optional[torch.Generator], device):
    """Bool keep mask, each entry True with probability ``1 - rate``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def _keep_prob(rate: float, dtype: torch.dtype) -> float:
    """``1 - rate`` rounded to ``dtype`` on the host, as JAX rounds a Python
    scalar to the array's dtype before dividing by it."""
    return torch.tensor(1.0 - rate, dtype=dtype).item()


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(keep, x / keep_prob, 0)`` in x's dtype,
    keep drawn from ``generator``.  At rate 0, or when deterministic, ``x``
    itself, and nothing is drawn."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / _keep_prob(rate, x.dtype), 0.0)


def _dense_dropout_attention(q, k, v, bias, scale, kv_lens, causal, window, rate, generator):
    """The JAX function's dense branch with dropout on the probabilities;
    mask descriptors become the additive -1e30 bias (JAX's
    ``make_attention_bias``)."""
    b, tq, hq, d = q.shape
    logits, ok = _grouped_logits(q, k, bias, scale, kv_lens, causal, window)
    if ok is not None:
        logits = logits + torch.where(ok, 0.0, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    keep = _keep_mask(probs.shape, rate, generator, probs.device)
    probs = probs * keep / _keep_prob(rate, probs.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(b, tq, hq, d)


def multi_head_attention(q, k, v, bias=None, *, scale: Optional[float] = None,
                         kv_lens=None, causal: bool = False, window: Optional[int] = None,
                         dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None,
                         deterministic: bool = True) -> torch.Tensor:
    """Scaled dot-product attention; q [B, Tq, Hq, D], k/v [B, Tk, Hk, D].
    K1 (or its plain version on the CPU) unless ``dropout_rate > 0`` and not
    ``deterministic``, which takes the dense dropout branch.  An
    ``attention`` span (``utils/profiling.py``): the dense branch's own, or
    ``flash_attention``'s."""
    if dropout_rate > 0.0 and not deterministic:
        with span("attention"):
            return _dense_dropout_attention(q, k, v, bias, q.shape[-1] ** -0.5 if scale is None
                                            else scale, kv_lens, causal, window, dropout_rate,
                                            generator)
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


__all__ = ["dropout", "make_attention_bias", "multi_head_attention"]
