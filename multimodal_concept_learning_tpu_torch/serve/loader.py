"""Load a results directory into a servable MLLM (counterpart of
multimodal_concept_learning_tpu/serve/loader.py).

Reads the reference layout ``results_dir/models/{training_config.json,
<checkpoint>.pt}``, rebuilds the tokenizer as the trainer does (the
configured tokenizer plus the ``<ood ...>`` tokens of the labels mapping)
and loads the weights strictly into the port's ``MLLM`` on ``device``.
``int8`` / ``int4`` quantize the LM's projections and ``int8_vision`` the
ViT's for serving, on the device after the float weights are loaded
(``_quantize_for_serving``).  LoRA banks are not ported yet (ROADMAP.md).
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


def _quantize_for_serving(state_dict, cfg: MLLMConfig, int8: bool, int8_vision: bool,
                          verbose: bool, label: str = "", int4: bool = False):
    """Quantize a float serving state dict (the JAX loader's function of
    the same name): ``int8`` or ``int4`` the LM's projections (exclusive),
    ``int8_vision`` the ViT's; projector, embeddings and norms stay float.
    Runs where the tensors lie.  Returns (state dict, config)."""
    from multimodal_concept_learning_tpu_torch.ops.int4 import quantize_mllm_lm_params_int4
    from multimodal_concept_learning_tpu_torch.ops.quant import quantize_mllm_params

    cfg = cfg.quantized(int8=int8, int8_vision=int8_vision, int4=int4)  # int8 + int4 raises
    state_dict = quantize_mllm_params(state_dict, vision=int8_vision, lm=int8)
    if int4:
        state_dict = quantize_mllm_lm_params_int4(state_dict)
    if verbose:
        what = " + ".join((["LM-int8"] if int8 else []) + (["LM-int4"] if int4 else [])
                          + (["vision-tower-int8"] if int8_vision else []))
        print(f"Quantized {label}{what} weights (serving mode)")
    return state_dict, cfg


def load_trained_mllm(results_dir: str, checkpoint: str = "best_model.pt", int8: bool = False,
                      int8_vision: bool = False, int4: bool = False, *, device,
                      dtype: torch.dtype = torch.bfloat16, verbose: bool = True) -> LoadedMLLM:
    if int8 and int4:
        raise ValueError("--int8 and --int4 are mutually exclusive")
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
    cfg = model_config(config, len(tokenizer), dtype)
    if int8 or int8_vision or int4:
        sd = {k: v.to(dev) for k, v in sd.items()}
        sd, cfg = _quantize_for_serving(sd, cfg, int8, int8_vision, verbose, int4=int4)
    model = build_mllm(cfg, sd, dev)
    if verbose:
        print(f"Loaded checkpoint {ckpt_path} on {dev} ({dtype})")
    return LoadedMLLM(model, tokenizer, config, labels_mapping, dev)


__all__ = ["LoadedMLLM", "build_tokenizer", "load_trained_mllm", "model_config",
           "resolve_lm_preset", "resolve_vision_preset", "training_config"]
