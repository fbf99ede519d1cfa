"""Beam search over dense KV caches (counterpart of
multimodal_concept_learning_tpu/models/beam.py).

Prefill once at batch B, tile the per-layer caches to B*K rows (the beams
of row b are rows b*K .. b*K+K-1), then each step:

1. embeds every beam's last token and advances all B*K rows one
   ``CausalLM.decode_step`` (K1 in each layer on the card);
2. scores the K*V continuations of each row (float32 log-softmax; a
   finished beam may only continue with ``pad_id`` at zero cost);
3. keeps the top K by total log-probability, the lower index first among
   equal scores (``jax.lax.top_k``'s order: ``_top_k``), and reorders the
   beam state (token history, scores, done flags, lengths, cache mask and
   every layer's cache) with one row gather (``index_select``).

Deterministic: no sampling.  Width 1 is greedy decoding.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache
from multimodal_concept_learning_tpu_torch.ops.flash_attention import _NEG


def _log_softmax(lm, hidden: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(lm.lm_head(hidden).float(), dim=-1)


def _top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values of the last axis and their indices, the
    lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` leaves ties in no set order).  Tied logits are
    common here: ``copy_init_ood_rows`` copies embedding rows and the LM
    head is tied to the embedding."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_generate(model, images, input_ids, attention_mask, max_new_tokens: int,
                  num_beams: int, eos_id: Optional[int] = None, pad_id: int = 0,
                  length_penalty: float = 0.0, return_scores: bool = False):
    """Width-``num_beams`` beam search; returns int32 tokens [B,
    max_new_tokens] (the best beam of each row; after ``eos_id`` the
    positions hold ``pad_id``).  ``length_penalty`` alpha divides each
    beam's final log-probability by ``len ** alpha`` (tokens up to and
    including eos).  ``return_scores`` also returns the chosen beam's
    unpenalized total log-probability [B].  Prompts are right-padded;
    inputs go to the model's device."""
    dev = next(model.parameters()).device
    images, input_ids, attention_mask = (x.to(dev) for x in (images, input_ids, attention_mask))
    lm = model.language_model
    k = num_beams
    b, t = input_ids.shape
    rows = torch.arange(b, device=dev)
    caches = init_kv_cache(lm.cfg, b, t + max_new_tokens, dev)
    seq_lens = attention_mask.sum(dim=1).to(torch.int32)
    hidden = model.prefill(images, input_ids, attention_mask, caches, kv_lens=seq_lens)
    logprobs0 = _log_softmax(lm, hidden[rows, seq_lens.long() - 1])  # [B, V]
    v = logprobs0.shape[-1]
    if k > v:
        raise ValueError("beam width cannot exceed the vocabulary")

    scores, first = _top_k(logprobs0, k)  # [B, K] both
    first = first.to(torch.int32)
    done = (torch.zeros((b, k), dtype=torch.bool, device=dev) if eos_id is None
            else first == eos_id)
    history = torch.full((b, k, max_new_tokens), pad_id, dtype=torch.int32, device=dev)
    history[:, :, 0] = first

    caches = tuple({part: c.repeat_interleave(k, dim=0) for part, c in layer.items()}
                   for layer in caches)
    cache_mask = torch.nn.functional.pad(attention_mask.to(torch.int32),
                                         (0, max_new_tokens)).repeat_interleave(k, dim=0)
    seq_lens_bk = seq_lens.repeat_interleave(k)  # [B*K]
    rows_bk = torch.arange(b * k, device=dev)
    base = (rows * k)[:, None]  # [B, 1]
    # a done beam's only continuation: pad_id at zero additional cost
    done_row = torch.full((v,), _NEG, device=dev)
    done_row[pad_id] = 0.0

    for step in range(1, max_new_tokens):
        last = history[:, :, step - 1].reshape(b * k)
        cache_mask[rows_bk, seq_lens_bk.long()] = 1
        h = lm.decode_step(lm.embed(last[:, None]), caches, seq_lens_bk, cache_mask)
        lp = _log_softmax(lm, h[:, 0]).reshape(b, k, v)
        lp = torch.where(done[:, :, None], done_row, lp)
        cand = scores[:, :, None] + lp  # [B, K, V]
        scores, flat_idx = _top_k(cand.reshape(b, k * v), k)
        parent = flat_idx // v  # [B, K]
        token = (flat_idx % v).to(torch.int32)
        gather = (base + parent).reshape(b * k)  # rows to keep
        caches = tuple({part: c.index_select(0, gather) for part, c in layer.items()}
                       for layer in caches)
        cache_mask = cache_mask.index_select(0, gather)
        seq_lens_bk = seq_lens_bk.index_select(0, gather) + 1
        done = torch.gather(done, 1, parent)
        history = torch.gather(history, 1, parent[:, :, None].expand(b, k, max_new_tokens))
        history[:, :, step] = torch.where(done, torch.full_like(token, pad_id), token)
        if eos_id is not None:
            done = done | (token == eos_id)

    if eos_id is None:
        gen_lens = torch.full((b, k), max_new_tokens, device=dev)
    else:
        hit = history == eos_id
        gen_lens = torch.where(hit.any(dim=-1), hit.int().argmax(dim=-1) + 1, max_new_tokens)
    penalized = scores / gen_lens.clamp(min=1).float() ** length_penalty
    best = torch.argmax(penalized, dim=1)  # [B]
    out = history[rows, best]  # [B, max_new_tokens]
    if return_scores:
        return out, scores[rows, best]
    return out


__all__ = ["beam_generate"]
