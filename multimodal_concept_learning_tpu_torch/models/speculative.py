"""Self-speculative decoding: an early-exit draft verified by the full model
(counterpart of multimodal_concept_learning_tpu/models/speculative.py).

The draft is the same network's first ``draft_layers`` blocks with the
shared final norm and head, so it costs no memory and its K/V in those
blocks are the full model's.  Each iteration the draft proposes
``draft_len - 1`` tokens one at a time (``decode_chunk(num_layers=...)``),
then ONE full-model ``decode_chunk`` over ``[last_tok, d_1 .. d_{g-1}]``
gives the greedy successor of every prefix: the longest agreeing prefix
plus the first corrected token commit (1..g tokens an iteration).  The
tokens are greedy decoding's; speculation changes only how many
full-model calls it takes.

No rollback: ``decode_chunk`` attends only the committed prefix (the
caller's cache mask) plus the chunk's own causally ordered slots, so
rejected K/V stay masked and the next chunk overwrites them.  Nothing is
compiled, so unlike the JAX module there is no table of built functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache


def _greedy(lm, hidden: torch.Tensor) -> torch.Tensor:
    return torch.argmax(lm.lm_head(hidden), dim=-1).to(torch.int32)


@torch.inference_mode()
def speculative_generate(model, images, input_ids, attention_mask, max_new_tokens: int,
                         draft_layers: int, draft_len: int = 4, eos_id: Optional[int] = None,
                         pad_id: int = 0, return_stats: bool = False):
    """Greedy generation by self-speculation; int32 tokens [B,
    max_new_tokens] equal to ``greedy_generate``'s (``pad_id`` after a
    row's ``eos_id``).  ``draft_layers``: the draft's depth (1..num_layers);
    ``draft_len`` g: g-1 proposals per full-model call.  ``return_stats``
    also returns {"iterations", "full_model_calls", "tokens_per_full_call"}.
    Prompts are right-padded; inputs go to the model's device."""
    lm = model.language_model
    if not 1 <= draft_layers <= lm.cfg.num_layers:
        raise ValueError(f"draft_layers must be in [1, {lm.cfg.num_layers}], got {draft_layers}")
    if draft_len < 2:
        raise ValueError(f"draft_len must be >= 2, got {draft_len}")
    dev = next(model.parameters()).device
    images, input_ids, attention_mask = (x.to(dev) for x in (images, input_ids, attention_mask))
    b, t = input_ids.shape
    g = draft_len
    cache_len = t + max_new_tokens + g + 1
    caches = init_kv_cache(lm.cfg, b, cache_len, dev)
    dev_rows = torch.arange(b, device=dev)

    seq = attention_mask.sum(dim=1).to(torch.int32)
    hidden = model.prefill(images, input_ids, attention_mask, caches, kv_lens=seq)
    first = _greedy(lm, hidden[dev_rows, seq.long() - 1]).cpu().numpy()

    out = [[int(first[i])] for i in range(b)]
    done = np.asarray([eos_id is not None and int(first[i]) == eos_id for i in range(b)])
    last_tok = first.astype(np.int32)
    committed = seq.cpu().numpy().astype(np.int64)  # KV-cached tokens a row (the prompt)
    cache_mask = np.zeros((b, cache_len), np.int32)
    cache_mask[:, :t] = attention_mask.cpu().numpy()
    iters = full_calls = 0

    while not all(done[i] or len(out[i]) >= max_new_tokens for i in range(b)):
        iters += 1
        start = torch.from_numpy(committed.astype(np.int32)).to(dev)
        mask_dev = torch.from_numpy(cache_mask).to(dev)
        # draft: g-1 proposals from the first draft_layers blocks, one token a call
        tok = torch.from_numpy(last_tok).to(dev)
        pos, spec_mask, proposals = start.clone(), mask_dev.clone(), []
        for _ in range(g - 1):
            h = lm.decode_chunk(lm.embed(tok[:, None]), caches, pos, spec_mask,
                                num_layers=draft_layers)
            tok = _greedy(lm, h[:, 0])
            spec_mask[dev_rows, pos.long()] = 1
            pos = pos + 1
            proposals.append(tok)
        chunk = torch.stack([torch.from_numpy(last_tok).to(dev), *proposals], dim=1)  # [B, g]
        # verify: one full-model chunk forward
        tfull = _greedy(lm, lm.decode_chunk(lm.embed(chunk), caches, start, mask_dev))
        full_calls += 1
        tfull_np, chunk_np = tfull.cpu().numpy(), chunk.cpu().numpy()
        # accept and commit, row by row
        for i in range(b):
            if done[i] or len(out[i]) >= max_new_tokens:
                continue
            m = 0
            while m < g - 1 and chunk_np[i, m + 1] == tfull_np[i, m]:
                m += 1
            c = m + 1  # committed tokens t_1..t_c
            for j in range(c):
                if len(out[i]) >= max_new_tokens or done[i]:
                    c = j
                    break
                tok_j = int(tfull_np[i, j])
                out[i].append(tok_j)
                if eos_id is not None and tok_j == eos_id:
                    done[i] = True
            if c == 0:
                continue
            cache_mask[i, committed[i]:committed[i] + c] = 1
            committed[i] += c
            last_tok[i] = tfull_np[i, c - 1]

    tokens = np.full((b, max_new_tokens), pad_id, np.int32)
    for i in range(b):
        row = out[i][:max_new_tokens]
        tokens[i, :len(row)] = row
        if eos_id is not None and eos_id in row:
            tokens[i, row.index(eos_id) + 1:] = pad_id
    tokens = torch.from_numpy(tokens)
    if return_stats:
        total = sum(len(o) for o in out)
        return tokens, {"iterations": iters, "full_model_calls": full_calls,
                        "tokens_per_full_call": total / max(1, full_calls)}
    return tokens


__all__ = ["speculative_generate"]
