"""Weights across packages, and the reference results-dir layout.

- ``state_dict_from_jax``: a JAX ``MLLM`` param tree (nested dicts of
  numpy arrays) -> the port's state dict, with exactly the names and
  layouts ``checkpoint/torch_interop.mllm_params_to_torch`` writes.  It
  reuses that module's numpy-only per-leaf converters and never imports
  jax (``mllm_params_to_torch`` itself fetches leaves through jax).
- ``build_mllm``: an ``MLLM`` on a device from a state dict
  (``load_state_dict(strict=True)``), cast by the device policy.
- ``init_random_weights_``: seeded random init (the JAX initialisers:
  normal(0.02) kernels and embeddings, zero biases, unit LayerNorm scales,
  zero RMSNorm weights).
- ``save_results_dir`` / ``load_state_dict``: the reference layout
  ``models/{training_config.json, best_model.pt, tokenizer/}``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
    _lm_entry_to_torch,
    _vit_export,
)
from multimodal_concept_learning_tpu_torch.device import cast_for_compute, resolve_device
from multimodal_concept_learning_tpu_torch.models.lm import RMSNorm
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            flat.update(_flatten(node, path + "/"))
        else:
            flat[path] = np.asarray(node, dtype=np.float32)
    return flat


def state_dict_from_jax(params, patch_size: int) -> Dict[str, torch.Tensor]:
    """JAX MLLM params (numpy leaves, optionally under "params") -> the
    port's state dict of float32 tensors."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params).items():
        tower, rel = key.split("/", 1)
        if tower == "vision_model":
            pairs = [(f"vision_model.{n}", t) for n, t in _vit_export(rel, arr, patch_size)]
        elif tower == "projector":
            pairs = [("projector.weight", arr.T) if rel == "kernel" else ("projector.bias", arr)]
        elif tower == "language_model":
            name, t = _lm_entry_to_torch(rel, arr)
            pairs = [(f"language_model.{name}", t)]
        else:
            raise KeyError(f"Unknown MLLM tower: {tower}")
        for name, t in pairs:
            sd[name] = torch.from_numpy(np.ascontiguousarray(t, dtype=np.float32))
    return sd


def build_mllm(cfg: MLLMConfig, state_dict: Dict[str, torch.Tensor], device) -> MLLM:
    """An MLLM on ``device`` holding ``state_dict`` (strict), linear weights
    in ``cfg.dtype``.  Built on the meta device first, so no memory is spent
    on a throwaway initialisation."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MLLM(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    model = model.float().to(dev)
    cast_for_compute(model, cfg.dtype)
    return model.eval()


@torch.no_grad()
def init_random_weights_(model: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded in-place init with the JAX package's initialisers."""
    for mod in model.modules():
        if isinstance(mod, RMSNorm):
            mod.weight.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Embedding)):
            mod.weight.normal_(0.0, std, generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("cls_token", "position_embeddings")):
            p.normal_(0.0, std, generator=generator)
    return model


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pt`` (a flat dict of tensors) as float32 tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def save_results_dir(results_dir: str, model: MLLM, tokenizer, training_config: dict,
                     checkpoint: str = "best_model.pt") -> str:
    """Write ``models/{training_config.json, <checkpoint>, tokenizer/}`` with
    float32 weights (the layout both packages read).  Returns the models dir."""
    models_dir = os.path.join(results_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    with open(os.path.join(models_dir, "training_config.json"), "w") as f:
        json.dump(training_config, f, indent=2)
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
               os.path.join(models_dir, checkpoint))
    tokenizer.save_pretrained(os.path.join(models_dir, "tokenizer"))
    return models_dir


__all__ = [
    "build_mllm",
    "init_random_weights_",
    "load_state_dict",
    "save_results_dir",
    "state_dict_from_jax",
]
