"""Load a results directory into a servable MLLM (counterpart of
multimodal_concept_learning_tpu/serve/loader.py).

Reads the reference layout ``results_dir/models/{training_config.json,
<checkpoint>.pt}``, rebuilds the tokenizer as the trainer does (the
configured tokenizer plus the ``<ood ...>`` tokens of the labels mapping)
and loads the weights strictly into the port's ``MLLM`` on ``device``.
Int8/int4 weights and LoRA banks are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import torch

from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, load_state_dict
from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu_torch.device import resolve_device
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig
from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer


class LoadedMLLM(NamedTuple):
    model: MLLM
    tokenizer: object
    config: MultimodalTrainingConfig
    labels_mapping: Optional[dict]
    device: torch.device


def resolve_vision_preset(name: str) -> str:
    """Map reference model names (HF/timm ids) to ViT presets."""
    lowered = name.lower()
    if lowered in ("vit-t-8", "vit-s-16", "vit-b-16", "vit-b-32", "vit-l-14"):
        return lowered
    if "large" in lowered:
        return "vit-l-14"
    if "small" in lowered:
        return "vit-s-16"
    if "patch32" in lowered or "b-32" in lowered or "b32" in lowered:
        return "vit-b-32"
    return "vit-b-16"  # google/vit-base-patch16-224-in21k, timm vit_base_*


def resolve_lm_preset(name: str) -> str:
    lowered = name.lower()
    if lowered in ("nano", "small"):
        return lowered
    return "gemma3-1b"  # google/gemma-3-1b-it


def training_config(params: dict) -> MultimodalTrainingConfig:
    """A ``training_config.json`` dict as the trainer's config; ``vision_path``
    is cleared, since served weights come from the checkpoint."""
    return MultimodalTrainingConfig.from_params(dict(params, vision_path=""))


def build_tokenizer(config: MultimodalTrainingConfig):
    """(tokenizer with the OOD concept tokens added, labels mapping or None)."""
    labels_mapping = None
    ood_tokens = []
    if config.labels_mapping_path and os.path.exists(config.labels_mapping_path):
        with open(config.labels_mapping_path) as f:
            labels_mapping = json.load(f)
        ood_tokens = [v for v in labels_mapping.values() if v.startswith("<ood")]
    tokenizer = load_tokenizer(config.language_model_name)
    if ood_tokens:
        tokenizer.add_tokens(ood_tokens)
    return tokenizer, labels_mapping


def model_config(config: MultimodalTrainingConfig, vocab_size: int,
                 dtype: torch.dtype) -> MLLMConfig:
    for field in ("lm_lora_rank", "lm_moe_experts"):
        if getattr(config, field, 0):
            raise NotImplementedError(
                f"{field} > 0 is not ported yet (ROADMAP.md, queue A)")
    return MLLMConfig.create(
        vocab_size=vocab_size,
        vision_preset=resolve_vision_preset(config.vision_model_name),
        lm_preset=resolve_lm_preset(config.language_model_name),
        num_vision_tokens=config.num_vision_tokens,
        image_size=config.image_size,
        dtype=dtype,
    )


def load_trained_mllm(results_dir: str, checkpoint: str = "best_model.pt", *, device,
                      dtype: torch.dtype = torch.bfloat16, verbose: bool = True) -> LoadedMLLM:
    dev = resolve_device(device)
    models_dir = os.path.join(results_dir, "models")
    with open(os.path.join(models_dir, "training_config.json")) as f:
        config = training_config(json.load(f))
    tokenizer, labels_mapping = build_tokenizer(config)

    ckpt_path = os.path.join(models_dir, checkpoint)
    sd = load_state_dict(ckpt_path)
    rows = sd["language_model.model.embed_tokens.weight"].shape[0]
    if rows != len(tokenizer):
        raise ValueError(f"{ckpt_path} has {rows} embedding rows but the rebuilt tokenizer "
                         f"has {len(tokenizer)} entries (labels mapping "
                         f"{config.labels_mapping_path!r} missing or changed?)")
    model = build_mllm(model_config(config, len(tokenizer), dtype), sd, dev)
    if verbose:
        print(f"Loaded checkpoint {ckpt_path} on {dev} ({dtype})")
    return LoadedMLLM(model, tokenizer, config, labels_mapping, dev)


__all__ = ["LoadedMLLM", "build_tokenizer", "load_trained_mllm", "model_config",
           "resolve_lm_preset", "resolve_vision_preset", "training_config"]
