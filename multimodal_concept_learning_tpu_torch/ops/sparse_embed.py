"""Vocabulary-partitioned embedding (counterpart of
multimodal_concept_learning_tpu/ops/sparse_embed.py).

A text tower whose captions come from an enumerable corpus (one template x
the class names) only ever gathers a few hundred rows of its [V, H] table.
``PartitionedEmbed`` splits the table into

- ``weight``: the full [V, H] table, frozen (``requires_grad=False``), so
  ``build_optimizer`` never gets it and it adds nothing to the clipping
  norm (the JAX ``partitioned_embed_mask`` under optax);
- ``active``: the trainable [A, H] subtable of the corpus's rows, a copy of
  those rows of ``weight`` at init, so the forward is bitwise the dense
  one there.

Under AdamW a row that no id ever reaches moves only by weight decay,
``p *= 1 - lr_s * wd`` each update; ``inactive_decay`` gives that product
in closed form and ``merged_embedding`` folds it into the dense table at
export.  The trained result is that of dense AdamW over the full table
(``tests/test_torch_sparse_embed.py``).  Plain tensor code: the JAX module
has no Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def check_active_rows(active_rows: Sequence[int], vocab_size: int) -> Tuple[int, ...]:
    """``active_rows`` as a tuple of ints, checked as the JAX module asserts
    it: non-empty, sorted unique, within [0, vocab_size).  The port raises
    ``ValueError`` where JAX raises ``AssertionError``."""
    idx = np.asarray(tuple(active_rows), np.int64)
    if idx.ndim != 1 or len(idx) == 0:
        raise ValueError("active_rows must be non-empty")
    if not (np.diff(idx) > 0).all():
        raise ValueError("active_rows must be sorted unique")
    if idx[0] < 0 or idx[-1] >= vocab_size:
        raise ValueError("active_rows out of vocab range")
    return tuple(int(i) for i in idx)


class PartitionedEmbed(nn.Module):
    """Embedding with a trainable active-row subtable and a frozen full
    table (parameters ``weight`` [V, H], the dense name, and ``active``
    [A, H]; JAX names them ``embedding`` and ``active``).

    ``active_rows`` must cover every id the corpus can produce, padding
    included (``active_rows_from_corpus``); ids outside it still resolve,
    to the frozen row, but do not train.  Bad rows raise ``ValueError``
    (``check_active_rows``)."""

    def __init__(self, vocab_size: int, features: int, active_rows: Sequence[int]):
        super().__init__()
        self.active_rows = check_active_rows(active_rows, vocab_size)
        rows = torch.tensor(self.active_rows, dtype=torch.long)
        slot = torch.full((vocab_size,), -1, dtype=torch.long)
        slot[rows] = torch.arange(len(rows))
        self.weight = nn.Parameter(torch.zeros(vocab_size, features), requires_grad=False)
        self.active = nn.Parameter(torch.zeros(len(rows), features))
        self.register_buffer("rows", rows, persistent=False)
        self.register_buffer("slot", slot, persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> None:
        """normal(std) table from ``generator`` (the draws of an
        ``nn.Embedding`` of the same shape), the subtable its rows."""
        self.weight.normal_(0.0, std, generator=generator)
        self.active.copy_(self.weight[self.rows])

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        ids = input_ids.long()
        slot = self.slot[ids]
        x_act = F.embedding(slot.clamp(min=0), self.active)
        x_frz = F.embedding(ids, self.weight)
        return torch.where((slot >= 0)[..., None], x_act, x_frz)


def active_rows_from_corpus(ids_arrays: Sequence) -> Tuple[int, ...]:
    """Sorted unique token ids over every ids array (numpy or CPU tensor)
    the corpus can emit, padding included."""
    uniq = np.unique(np.concatenate([np.asarray(a).ravel() for a in ids_arrays]))
    return tuple(int(i) for i in uniq)


def inactive_decay(learning_rates, weight_decay: float) -> float:
    """Closed-form AdamW drift of never-touched rows: prod(1 - lr_s * wd),
    in float64 over the per-update learning rates actually applied."""
    d = 1.0
    for lr in np.asarray(list(learning_rates), np.float64).ravel():
        d *= 1.0 - float(lr) * weight_decay
    return float(d)


def _tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def merged_embedding(emb, active, active_rows: Sequence[int], decay: float = 1.0) -> torch.Tensor:
    """The dense [V, H] table of a partitioned pair (tensors or numpy
    arrays): the inactive rows times ``decay``, the active rows the
    subtable's.  Returns float32 on ``emb``'s device, computed as the JAX
    function computes it (``emb`` in float32 times ``decay`` rounded to
    float32, which is what numpy gives for a float32 or an ml_dtypes bf16
    array); the caller casts it to the table's dtype."""
    emb, active = _tensor(emb), _tensor(active)
    out = emb.float() * torch.tensor(decay, dtype=torch.float32, device=emb.device)
    rows = torch.tensor(tuple(active_rows), dtype=torch.long, device=emb.device)
    out[rows] = active.to(emb.device).float()
    return out


__all__ = ["PartitionedEmbed", "active_rows_from_corpus", "check_active_rows",
           "inactive_decay", "merged_embedding"]
