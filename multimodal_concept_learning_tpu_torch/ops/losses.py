"""Losses (counterpart of multimodal_concept_learning_tpu/ops/losses.py).

``sparse_answer_cross_entropy`` gathers the first A supervised positions of
each row (a stable sort, as the JAX ``argsort(stable=True)`` does, so the
same positions are picked), computes logits only there and gives the mean
loss of the dense causal-LM cross entropy over those positions.  Rows with
fewer than A supervised tokens pad with their first unsupervised positions
(as the JAX sort does), masked by ``valid``.
All log-softmaxes run in float32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

IGNORE_INDEX = -100


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       valid: Optional[torch.Tensor] = None,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax CE of [B, C] logits against [B] int labels, optionally
    label-smoothed; ``valid`` [B] bool excludes padded samples; ``count``
    (with ``valid``) divides the sum in place of the valid count (a
    data-parallel step's global count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    if valid is None:
        return nll.mean()
    validf = valid.float()
    return (nll * validf).sum() / (validf.sum() if count is None else count).clamp(min=1.0)


def shift_labels(labels: torch.Tensor) -> torch.Tensor:
    """HF causal-LM shift: position t is supervised by labels[t + 1]."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)], dim=1)


def gather_supervised_positions(labels: torch.Tensor,
                                max_positions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions [B, A], valid [B, A]): the first A indices with labels !=
    IGNORE_INDEX, ascending; rows with fewer pad with the first unsupervised
    positions (masked out by ``valid``)."""
    mask = labels != IGNORE_INDEX
    order = torch.sort((~mask).to(torch.int32), dim=1, stable=True).indices
    positions = order[:, :max_positions]
    return positions, torch.gather(mask, 1, positions)


def sparse_answer_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                                lm_head_fn: Callable, max_positions: int,
                                logits_softcap: Optional[float] = None,
                                row_valid: Optional[torch.Tensor] = None,
                                count: Optional[torch.Tensor] = None):
    """Causal-LM CE computed only at supervised positions.

    hidden [B, T, H]; labels [B, T] pre-shift (hidden[t] predicts
    labels[t + 1]).  Returns (mean loss, logits [B, A, V], positions [B, A],
    valid [B, A]); ``count`` divides the sum in place of the valid count."""
    shifted = shift_labels(labels)
    positions, valid = gather_supervised_positions(shifted, max_positions)
    if row_valid is not None:
        valid = valid & row_valid.bool()[:, None]
    idx = positions[:, :, None].expand(-1, -1, hidden.shape[-1])
    logits = lm_head_fn(torch.gather(hidden, 1, idx))
    if logits_softcap is not None:
        logits = torch.tanh(logits / logits_softcap) * logits_softcap
    target = torch.where(valid, torch.gather(shifted, 1, positions), 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    validf = valid.float()
    loss = (nll * validf).sum() / (validf.sum() if count is None else count).clamp(min=1.0)
    return loss, logits, positions, valid


def answer_count(labels: torch.Tensor, max_positions: int,
                 row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The count of positions ``sparse_answer_cross_entropy`` averages over
    (float32 0-d), from the labels alone."""
    valid = gather_supervised_positions(shift_labels(labels), max_positions)[1]
    if row_valid is not None:
        valid = valid & row_valid.bool()[:, None]
    return valid.float().sum()


def dense_causal_lm_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                                  lm_head_fn: Callable) -> torch.Tensor:
    """The reference-semantics dense loss over full [B, T, V] logits."""
    logits = lm_head_fn(hidden)
    shifted = shift_labels(labels)
    mask = shifted != IGNORE_INDEX
    target = torch.where(mask, shifted, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
    maskf = mask.float()
    return (nll * maskf).sum() / maskf.sum().clamp(min=1.0)


__all__ = [
    "IGNORE_INDEX",
    "answer_count",
    "cross_entropy_loss",
    "dense_causal_lm_cross_entropy",
    "gather_supervised_positions",
    "shift_labels",
    "sparse_answer_cross_entropy",
]
