"""Embedding-row remapping across tokenizer vocabularies (the port's own
copy of multimodal_concept_learning_tpu/checkpoint/vocab_remap.py).

Checkpoint tensors map name for name against reference checkpoints, but
embedding rows mean the same token only when both sides used the same
tokenizer ids.  The offline ``ConceptTokenizer`` assigns other ids than
Gemma's SentencePiece, so a reference checkpoint (a 262,144-row table) is
remapped by token string first: for every token in both vocabularies the
source row is copied into the destination id's slot; tokens only the
destination has keep the template's row.  Tables may be numpy arrays or
tensors; the result has the template's type.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

EMBED_KEY = "language_model.model.embed_tokens.weight"


def remap_embedding_rows(src_matrix, src_vocab: Dict[str, int], dst_vocab: Dict[str, int],
                         dst_template) -> Tuple[object, int]:
    """Copy rows of ``src_matrix`` into a ``dst_template``-shaped table by
    matching token strings.  Returns (new table, rows copied); ids out of
    range on either side are skipped."""
    if isinstance(dst_template, torch.Tensor):
        out = dst_template.detach().clone()
        src = torch.as_tensor(src_matrix).to(out.device)
    else:
        out = np.array(dst_template, copy=True)
        src = src_matrix.detach().cpu().numpy() if isinstance(src_matrix, torch.Tensor) \
            else np.asarray(src_matrix)
    copied = 0
    for token, dst_id in dst_vocab.items():
        src_id = src_vocab.get(token)
        if src_id is None:
            continue
        if 0 <= src_id < src.shape[0] and 0 <= dst_id < out.shape[0]:
            out[dst_id] = src[src_id]
            copied += 1
    return out, copied


def remap_state_dict_vocab(state_dict: Dict[str, object], src_vocab: Dict[str, int],
                           dst_vocab: Dict[str, int], dst_template,
                           embed_key: str = EMBED_KEY) -> Tuple[Dict[str, object], int]:
    """Remap the embedding table inside a reference-named state dict; every
    other entry passes through (Gemma ties the LM head to the embedding).
    Returns (new state dict, rows copied); ``KeyError`` when the state dict
    has no table under ``embed_key``."""
    if embed_key not in state_dict:
        raise KeyError(f"state dict has no embedding table under {embed_key!r}")
    out = dict(state_dict)
    out[embed_key], copied = remap_embedding_rows(state_dict[embed_key], src_vocab, dst_vocab,
                                                  dst_template)
    return out, copied


__all__ = ["EMBED_KEY", "remap_embedding_rows", "remap_state_dict_vocab"]
