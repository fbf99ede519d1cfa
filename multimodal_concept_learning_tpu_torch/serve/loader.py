"""Load a results directory into a servable MLLM (counterpart of
multimodal_concept_learning_tpu/serve/loader.py).

Reads the reference layout ``results_dir/models/{training_config.json,
<checkpoint>.pt}``, rebuilds the tokenizer as the trainer does (the
configured tokenizer plus the ``<ood ...>`` tokens of the labels mapping)
and loads the weights strictly into the port's ``MLLM`` on ``device``.
``int8`` / ``int4`` quantize the LM's projections and ``int8_vision`` the
ViT's for serving, on the device after the float weights are loaded
(``_quantize_for_serving``).  A ``language_lora`` run is served with its
factors merged into the base weights by default (``merge_lora``), so the
quantizers see merged float weights.  ``load_adapter_bank`` loads a
multi-LoRA bank (``ops/multi_lora.py``): the shared base in the model, the
stacked adapter surface beside it in ``LoadedMLLM.bank``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from multimodal_concept_learning_tpu_torch.checkpoint import (
    build_mllm,
    load_state_dict,
    mllm_state_dict_from_torch,
)
from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu_torch.device import resolve_device
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig
from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params
from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer


class LoadedMLLM(NamedTuple):
    model: MLLM
    tokenizer: object
    config: MultimodalTrainingConfig
    labels_mapping: Optional[dict]
    device: torch.device
    # multi-LoRA bank (load_adapter_bank): the adapter surface's entries
    # stacked [num_adapters, ...] on ``device``; the model holds entry 0
    bank: Optional[Dict[str, torch.Tensor]] = None
    num_adapters: int = 0


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
    return MLLMConfig.create(
        vocab_size=vocab_size,
        vision_preset=resolve_vision_preset(config.vision_model_name),
        lm_preset=resolve_lm_preset(config.language_model_name),
        num_vision_tokens=config.num_vision_tokens,
        image_size=config.image_size,
        lm_lora_rank=getattr(config, "lm_lora_rank", 0),
        lm_lora_alpha=getattr(config, "lm_lora_alpha", 16.0),
        lm_moe_experts=getattr(config, "lm_moe_experts", 0),
        lm_moe_top_k=getattr(config, "lm_moe_top_k", 2),
        lm_moe_dispatch=getattr(config, "lm_moe_dispatch", "dense"),
        lm_moe_capacity_factor=getattr(config, "lm_moe_capacity_factor", 1.25),
        dtype=dtype,
    )


def _quantize_for_serving(state_dict, cfg: MLLMConfig, int8: bool, int8_vision: bool,
                          verbose: bool, label: str = "", int4: bool = False):
    """Quantize a float serving state dict (the JAX loader's function of
    the same name): ``int8`` or ``int4`` the LM's projections (exclusive),
    ``int8_vision`` the ViT's; projector, LoRA factors, embeddings and norms
    stay float (a bank's stacked entries keep their bank axis).  Runs where
    the tensors lie.  Returns (state dict, config)."""
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


def _read_results_dir(results_dir: str, checkpoint: str, dtype: torch.dtype):
    """(config, tokenizer, labels mapping, float32 CPU state dict in the
    port's names, model config, checkpoint path) of a results dir."""
    models_dir = os.path.join(results_dir, "models")
    with open(os.path.join(models_dir, "training_config.json")) as f:
        config = training_config(json.load(f))
    tokenizer, labels_mapping = build_tokenizer(config)
    ckpt_path = os.path.join(models_dir, checkpoint)
    sd = mllm_state_dict_from_torch(load_state_dict(ckpt_path))
    rows = sd["language_model.model.embed_tokens.weight"].shape[0]
    if rows != len(tokenizer):
        raise ValueError(f"{ckpt_path} has {rows} embedding rows but the rebuilt tokenizer "
                         f"has {len(tokenizer)} entries (labels mapping "
                         f"{config.labels_mapping_path!r} missing or changed?)")
    return config, tokenizer, labels_mapping, sd, model_config(config, len(tokenizer), dtype), \
        ckpt_path


def load_trained_mllm(results_dir: str, checkpoint: str = "best_model.pt", int8: bool = False,
                      int8_vision: bool = False, int4: bool = False, merge_lora: bool = True, *,
                      device, dtype: torch.dtype = torch.bfloat16,
                      verbose: bool = True) -> LoadedMLLM:
    if int8 and int4:
        raise ValueError("--int8 and --int4 are mutually exclusive")
    dev = resolve_device(device)
    config, tokenizer, labels_mapping, sd, cfg, ckpt_path = _read_results_dir(
        results_dir, checkpoint, dtype)
    if merge_lora and cfg.lm.lora_rank > 0:
        # serve the effective weights adapter-free; the quantizers below
        # then see the merged float weights
        sd = merge_lora_params(sd, alpha=cfg.lm.lora_alpha)
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, lora_rank=0))
        if verbose:
            print(f"Merged LoRA adapters (rank {config.lm_lora_rank}) into base weights")
    if int8 or int8_vision or int4:
        sd = {k: v.to(dev) for k, v in sd.items()}
        sd, cfg = _quantize_for_serving(sd, cfg, int8, int8_vision, verbose, int4=int4)
    model = build_mllm(cfg, sd, dev)
    if verbose:
        print(f"Loaded checkpoint {ckpt_path} on {dev} ({dtype})")
    return LoadedMLLM(model, tokenizer, config, labels_mapping, dev)


def load_adapter_bank(results_dir: str, adapter_dirs: Sequence[str],
                      checkpoint: str = "best_model.pt", int8: bool = False,
                      int8_vision: bool = False, *, device, dtype: torch.dtype = torch.bfloat16,
                      verbose: bool = True) -> LoadedMLLM:
    """A multi-LoRA serving bank (the JAX ``load_adapter_bank``).

    ``results_dir`` gives the shared base weights, tokenizer and config (a
    ``language_lora`` run, lm_lora_rank > 0); each of ``adapter_dirs`` is
    another results dir fine-tuned from the same base.  Adapter 0 is the
    raw base (zeroed factors, the base's projector), adapters 1..k are
    ``adapter_dirs`` in order (include ``results_dir`` there to serve its
    own adapter too).  ``int8`` / ``int8_vision`` quantize the shared base
    only: the stacked factors and projectors stay float, so a bank row
    computes int8(base) + its float adapter."""
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        identity_adapter_params,
        is_adapter_name,
        stack_adapter_params,
    )

    dev = resolve_device(device)
    config, tokenizer, labels_mapping, base_sd, cfg, _ = _read_results_dir(
        results_dir, checkpoint, dtype)
    if cfg.lm.lora_rank <= 0:
        raise ValueError("multi-LoRA serving needs a language_lora base "
                         f"(lm_lora_rank > 0), got {results_dir}")
    if verbose:
        print(f"Loaded checkpoint {os.path.join(results_dir, 'models', checkpoint)}")
    shapes = {k: v.shape for k, v in base_sd.items()}
    state_dicts = [identity_adapter_params(base_sd)]
    for d in adapter_dirs:
        other = _read_results_dir(d, checkpoint, dtype)[3]
        if {k: v.shape for k, v in other.items()} != shapes:
            raise ValueError(
                f"adapter {d} has a different parameter structure than the "
                "base (check lm_lora_rank / model presets match)")
        state_dicts.append(other)
    bank = {k: v.to(dev) for k, v in stack_adapter_params(state_dicts).items()}
    if int8 or int8_vision:
        # the quantizers convert only the base projections' weights; the
        # stacked adapter entries pass through with their bank axis
        bank, cfg = _quantize_for_serving(bank, cfg, int8, int8_vision, verbose,
                                          label="shared-base ")
    base = {k: v[0].clone() if is_adapter_name(k) else v for k, v in bank.items()}
    model = build_mllm(cfg, base, dev)
    surface = {k: v for k, v in bank.items() if is_adapter_name(k)}
    if verbose:
        names = [os.path.basename(os.path.normpath(d)) for d in adapter_dirs]
        print(f"Stacked multi-LoRA bank: {len(state_dicts)} adapters (0 = raw base, "
              f"1..{len(state_dicts) - 1} = {names})")
    return LoadedMLLM(model, tokenizer, config, labels_mapping, dev, bank=surface,
                      num_adapters=len(state_dicts))


__all__ = ["LoadedMLLM", "build_tokenizer", "load_adapter_bank", "load_trained_mllm",
           "model_config", "resolve_lm_preset", "resolve_vision_preset", "training_config"]
