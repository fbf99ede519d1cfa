"""MLLM: ViT tower + linear projector + causal LM (counterpart of
multimodal_concept_learning_tpu/models/mllm.py, serving surface only).

The vision tower's last hidden state is projected to the LM width and
spliced in front of the text embeddings by concatenation (the first
``num_vision_tokens`` ids are placeholders and are never embedded).
``paged_generate`` is the JAX function's greedy paged decode as a plain
loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.models.lm import CausalLM, LMConfig
from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTEncoder
from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
    init_paged_kv_cache,
    pages_needed,
)


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    vision: ViTConfig
    lm: LMConfig
    num_vision_tokens: int = 197
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def create(cls, vocab_size: int, vision_preset: str = "vit-b-16",
               lm_preset: str = "gemma3-1b", num_vision_tokens: int = 197,
               image_size: int = 224, dtype: torch.dtype = torch.bfloat16) -> "MLLMConfig":
        vision = dataclasses.replace(ViTConfig.preset(vision_preset), image_size=image_size,
                                     dtype=dtype)
        lm = dataclasses.replace(LMConfig.preset(lm_preset, vocab_size=vocab_size), dtype=dtype)
        return cls(vision=vision, lm=lm, num_vision_tokens=num_vision_tokens, dtype=dtype)


class MLLM(nn.Module):
    def __init__(self, cfg: MLLMConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = ViTEncoder(cfg.vision)
        self.projector = nn.Linear(cfg.vision.hidden_size, cfg.lm.hidden_size)
        self.language_model = CausalLM(cfg.lm)

    def prompt_embeds(self, images: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """Vision tower + splice: the [B, T, H] prompt embeddings."""
        nvt = self.cfg.num_vision_tokens
        image_embeds = self.vision_model(images)
        if image_embeds.shape[1] != nvt:
            raise ValueError(f"vision tower produced {image_embeds.shape[1]} tokens, "
                             f"config expects num_vision_tokens={nvt}")
        projected = self.projector(image_embeds.to(self.cfg.dtype))
        text = self.language_model.embed(input_ids[:, nvt:])
        return torch.cat([projected.to(text.dtype), text], dim=1)

    def prefill_paged(self, images, input_ids, attention_mask, pools, page_table):
        """Vision tower + splice + paged LM prefill (pools updated in place).
        Returns hidden [B, T, H]."""
        return self.language_model.prefill_paged(
            self.prompt_embeds(images, input_ids), attention_mask, pools, page_table)


@torch.inference_mode()
def paged_generate(model: MLLM, images, input_ids, attention_mask, max_new_tokens: int,
                   page_size: int, eos_id: Optional[int] = None,
                   pad_id: int = 0) -> torch.Tensor:
    """Greedy decoding over a paged KV cache; tokens [B, max_new_tokens]
    int32, ``pad_id`` after a row's ``eos_id``.  Each row gets one
    consecutive run of ``pages_needed(T + max_new_tokens)`` pages from a
    pool built for this call.  Inputs go to the model's device."""
    dev = next(model.parameters()).device
    images, input_ids, attention_mask = (x.to(dev) for x in (images, input_ids, attention_mask))
    lm = model.language_model
    b, t = input_ids.shape
    rows = torch.arange(b, device=dev)
    np_max = pages_needed(t + max_new_tokens, page_size)
    pools = init_paged_kv_cache(lm.cfg, 1 + b * np_max, page_size, device=dev)
    pt = torch.arange(1, 1 + b * np_max, dtype=torch.int32, device=dev).reshape(b, np_max)

    hidden = model.prefill_paged(images, input_ids, attention_mask, pools, pt)
    seq_lens = attention_mask.sum(dim=1).to(torch.int32)
    tok = torch.argmax(lm.lm_head(hidden[rows, seq_lens.long() - 1]), dim=-1).to(torch.int32)
    done = (torch.zeros(b, dtype=torch.bool, device=dev) if eos_id is None else tok == eos_id)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        h = lm.decode_step_paged(lm.embed(tok[:, None]), pools, pt, seq_lens)
        nxt = torch.argmax(lm.lm_head(h[:, 0]), dim=-1).to(torch.int32)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        if eos_id is not None:
            done = done | (nxt == eos_id)
        seq_lens = seq_lens + 1
        tok = nxt
        out.append(nxt)
    return torch.stack(out, dim=1)


__all__ = ["MLLM", "MLLMConfig", "paged_generate"]
