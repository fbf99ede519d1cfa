"""MLLM: ViT tower + linear projector + causal LM (counterpart of
multimodal_concept_learning_tpu/models/mllm.py).

The vision tower's last hidden state is projected to the LM width and
spliced in front of the text embeddings by concatenation (the first
``num_vision_tokens`` ids are placeholders and are never embedded).
``forward`` is the training/eval forward with the sparse answer loss;
``paged_generate`` is the JAX function's greedy paged decode as a plain
loop.  ``trainable_mask`` sets ``requires_grad`` by state-dict name (the
JAX optax mask); when no vision parameter trains, the tower runs under
``torch.no_grad()``, so it costs no backward (XLA drops the frozen tower's
backward in the JAX trainer).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.device import linear
from multimodal_concept_learning_tpu_torch.models.lm import CausalLM, LMConfig
from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTEncoder
from multimodal_concept_learning_tpu_torch.ops.losses import (
    dense_causal_lm_cross_entropy,
    sparse_answer_cross_entropy,
)
from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
    init_paged_kv_cache,
    pages_needed,
)

TRAINABLE_SETTINGS = ("vision_only", "language_only", "language_embed_only", "language_lora")


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    vision: ViTConfig
    lm: LMConfig
    num_vision_tokens: int = 197
    max_answer_tokens: int = 8  # static bound A of the sparse answer loss
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def create(cls, vocab_size: int, vision_preset: str = "vit-b-16",
               lm_preset: str = "gemma3-1b", num_vision_tokens: int = 197,
               image_size: int = 224, max_answer_tokens: int = 8,
               dtype: torch.dtype = torch.bfloat16) -> "MLLMConfig":
        vision = dataclasses.replace(ViTConfig.preset(vision_preset), image_size=image_size,
                                     dtype=dtype)
        lm = dataclasses.replace(LMConfig.preset(lm_preset, vocab_size=vocab_size), dtype=dtype)
        return cls(vision=vision, lm=lm, num_vision_tokens=num_vision_tokens,
                   max_answer_tokens=max_answer_tokens, dtype=dtype)


class MLLM(nn.Module):
    def __init__(self, cfg: MLLMConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = ViTEncoder(cfg.vision)
        self.projector = nn.Linear(cfg.vision.hidden_size, cfg.lm.hidden_size)
        self.language_model = CausalLM(cfg.lm)

    def _vision(self, images: torch.Tensor) -> torch.Tensor:
        nvt = self.cfg.num_vision_tokens
        frozen = not any(p.requires_grad for p in self.vision_model.parameters())
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            image_embeds = self.vision_model(images)
        if image_embeds.shape[1] != nvt:
            raise ValueError(f"vision tower produced {image_embeds.shape[1]} tokens, "
                             f"config expects num_vision_tokens={nvt}")
        return image_embeds

    def prompt_embeds(self, images: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """Vision tower + splice: the [B, T, H] prompt embeddings."""
        projected = linear(self.projector, self._vision(images), self.cfg.dtype)
        text = self.language_model.embed(input_ids[:, self.cfg.num_vision_tokens:])
        return torch.cat([projected.to(text.dtype), text], dim=1)

    def forward(self, images, input_ids, attention_mask, labels=None,
                dense_loss: bool = False, row_valid=None,
                kv_lens=None) -> Dict[str, torch.Tensor]:
        """The JAX ``MLLM.__call__``: {"hidden_states"} without labels;
        {"loss", "hidden_states"} with ``dense_loss``; otherwise the sparse
        answer loss with its {"logits" [B, A, V], "positions", "valid"}.
        ``kv_lens``: the mask's row lengths when it is right-padded (see
        ``CausalLM.hidden_states``)."""
        lm = self.language_model
        hidden = lm.hidden_states(self.prompt_embeds(images, input_ids), attention_mask, kv_lens)
        if labels is None:
            return {"hidden_states": hidden}
        if dense_loss:
            return {"loss": dense_causal_lm_cross_entropy(hidden, labels, lm.lm_head),
                    "hidden_states": hidden}
        loss, logits, positions, valid = sparse_answer_cross_entropy(
            hidden, labels, lm.lm_head, max_positions=self.cfg.max_answer_tokens,
            row_valid=row_valid)
        return {"loss": loss, "logits": logits, "positions": positions, "valid": valid,
                "hidden_states": hidden}

    def prefill_paged(self, images, input_ids, attention_mask, pools, page_table):
        """Vision tower + splice + paged LM prefill (pools updated in place).
        Returns hidden [B, T, H]."""
        return self.language_model.prefill_paged(
            self.prompt_embeds(images, input_ids), attention_mask, pools, page_table)


def _is_trainable(name: str, setting: str) -> bool:
    """The JAX ``trainable_mask`` rule on a state-dict name."""
    tower = name.split(".", 1)[0]
    if tower == "projector":
        return True
    if setting == "vision_only":
        return tower == "vision_model"
    if setting == "language_only":
        return tower == "language_model"
    return tower == "language_model" and ".embed_tokens." in name  # language_embed_only


def trainable_mask(model: nn.Module, setting: str) -> Dict[str, bool]:
    """Set ``requires_grad`` by state-dict name (the projector always, plus
    one tower or the LM embedding) and return {name: trainable}."""
    if setting not in TRAINABLE_SETTINGS:
        raise ValueError(f"Unknown trainable_params_setting: {setting}")
    if setting == "language_lora":
        raise NotImplementedError(
            "language_lora needs the LoRA adapters, not ported yet (ROADMAP.md, queue A)")
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = _is_trainable(name, setting)
        p.requires_grad_(mask[name])
    return mask


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def print_trainable_summary(model: nn.Module, setting: str) -> None:
    """The three lines of the JAX ``print_trainable_summary``."""
    total = count_params(model)
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"Trainable params setting: {setting}")
    print(f"Total parameters: {total:,}")
    print(f"Trainable parameters: {trainable:,} ({100 * trainable / total:.2f}%)")


@torch.no_grad()
def copy_init_ood_rows(model: MLLM, num_ood: int) -> MLLM:
    """Initialise the last ``num_ood`` embedding rows with rows 0..k-1."""
    if num_ood > 0:
        emb = model.language_model.model.embed_tokens.weight
        emb[-num_ood:] = emb[:num_ood].clone()
    return model


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


__all__ = ["MLLM", "MLLMConfig", "TRAINABLE_SETTINGS", "copy_init_ood_rows", "count_params",
           "paged_generate", "print_trainable_summary", "trainable_mask"]
