"""Token sampling for the serving path (counterpart of
multimodal_concept_learning_tpu/ops/sampling.py).

Greedy (``temperature == 0``) is an argmax (first index on ties, as
``jnp.argmax``) and draws nothing.  Otherwise top-k, then nucleus over the
survivors, then a temperature-scaled categorical draw from a
``torch.Generator`` the caller owns.  The draws differ from
``jax.random``'s for the same seed; the filters are identical.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row (ties at the k-th value all kept)."""
    if k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, _NEG))


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest probability-sorted prefix whose mass
    reaches ``p`` (the token crossing the threshold included)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    n_keep = keep_sorted.sum(dim=-1, keepdim=True)  # >= 1 always
    kth = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits >= kth, logits, torch.full_like(logits, _NEG))


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """One int32 token id per row of ``logits [..., V]``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    logits = logits.float()
    if top_k is not None:
        logits = top_k_mask(logits, top_k)
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    probs = torch.softmax(logits / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


__all__ = ["sample_logits", "top_k_mask", "top_p_mask"]
