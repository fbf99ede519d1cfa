"""Weights across packages, and the reference results-dir layout.

- ``state_dict_from_jax``: a JAX ``MLLM`` param tree (nested dicts of
  numpy arrays) -> the port's state dict, with exactly the names and
  layouts ``checkpoint/torch_interop.mllm_params_to_torch`` writes, from
  this module's numpy copies of that module's per-leaf converters.  Trees
  of quantized serving models convert too: int8 ``{"kernel", "scale"}``
  and int4 ``{"packed", "scale"}`` leaves keep their JAX layout and types
  under the same names (``ops/quant.py``, ``ops/int4.py``);
  ``clip_state_dict_from_jax`` the same for a JAX ``CLIPModel`` tree, and
  ``vit_classifier_state_dict_from_jax`` for a JAX
  ``ViTForImageClassification`` tree (the names
  ``vit_classifier_params_to_torch`` writes: ``vit.*``, ``classifier.*``).
- ``build_mllm``: an ``MLLM`` on a device from a state dict
  (``load_state_dict(strict=True)``), cast by the device policy.
- ``init_random_weights_``: seeded random init (the JAX initialisers:
  normal(0.02) kernels, embeddings and LoRA ``a`` factors, zero biases and
  LoRA ``b`` factors, unit LayerNorm scales, zero RMSNorm weights; for
  CLIP also normal(0.01) text positions and
  ``logit_scale`` = log(1/0.07); a partitioned text embedding draws its
  table as the dense one does and copies the active rows), for the MLLM
  and ``CLIPModel``.
- ``save_results_dir`` / ``load_state_dict``: the reference layout
  ``models/{training_config.json, best_model.pt, tokenizer/}``.
- ``host_state_dict`` / ``save_state_dict``: the trainer's checkpoints, a
  flat dict of float32 CPU tensors; frozen parameters come from a host copy
  taken before training, so they are bitwise the values of
  ``initial_model.pt`` even when the card stores them in bf16.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.device import cast_for_compute, resolve_device
from multimodal_concept_learning_tpu_torch.models.lm import RMSNorm
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig
from multimodal_concept_learning_tpu_torch.ops.lora import LoRAAdapter
from multimodal_concept_learning_tpu_torch.ops.moe import MoEMLP
from multimodal_concept_learning_tpu_torch.ops.sparse_embed import PartitionedEmbed


def _vit_export(rel: str, arr: np.ndarray, patch_size: int):
    """One flax ViT param (path relative to the tower) as [(HF ViTModel
    name, array)] (``checkpoint/torch_interop.py:_vit_export`` of the JAX
    package, without its fused-qkv case, which no JAX module writes)."""
    parts = rel.split("/")
    if rel == "cls_token":
        return [("embeddings.cls_token", arr)]
    if rel == "position_embeddings":
        return [("embeddings.position_embeddings", arr)]
    if parts[0] == "patch_embed":
        if parts[1] == "kernel":
            in_dim, hidden = arr.shape
            c = in_dim // (patch_size * patch_size)
            w = arr.reshape(patch_size, patch_size, c, hidden).transpose(3, 2, 0, 1)
            return [("embeddings.patch_embeddings.projection.weight", w)]
        return [("embeddings.patch_embeddings.projection.bias", arr)]
    if parts[0] == "layernorm":
        return [(f"layernorm.{'weight' if parts[1] == 'scale' else 'bias'}", arr)]
    if parts[0].startswith("layer_"):
        base = f"encoder.layer.{parts[0].split('_')[1]}"
        if parts[1] in ("layernorm_before", "layernorm_after"):
            return [(f"{base}.{parts[1]}.{'weight' if parts[2] == 'scale' else 'bias'}", arr)]
        if _quantized_leaf(parts[-1], arr):  # int8 {"kernel", "scale"}: JAX [in, out] layout
            owner = ".".join(parts[1:-1])
            owner = {"attention.output": "attention.output.dense",
                     "intermediate": "intermediate.dense", "output": "output.dense"}.get(
                         owner, owner.replace("attention.", "attention.attention.", 1))
            return [(f"{base}.{owner}.{parts[-1]}", arr)]
        if parts[1] == "attention":
            proj = parts[2]
            if proj in ("query", "key", "value"):
                if parts[3] == "kernel":  # (H, heads, hd)
                    return [(f"{base}.attention.attention.{proj}.weight",
                             arr.reshape(arr.shape[0], -1).T)]
                return [(f"{base}.attention.attention.{proj}.bias", arr.reshape(-1))]
            if proj == "output":
                if parts[3] == "kernel":  # (heads, hd, H)
                    return [(f"{base}.attention.output.dense.weight",
                             arr.reshape(-1, arr.shape[-1]).T)]
                return [(f"{base}.attention.output.dense.bias", arr)]
        if parts[1] in ("intermediate", "output"):
            if parts[2] == "kernel":
                return [(f"{base}.{parts[1]}.dense.weight", arr.T)]
            return [(f"{base}.{parts[1]}.dense.bias", arr)]
    raise KeyError(f"Unmapped ViT param: {rel}")


def _quantized_leaf(leaf: str, arr: np.ndarray) -> bool:
    """A leaf of an int8 or int4 projection, kept in its JAX layout."""
    return leaf in ("packed", "scale") or (leaf == "kernel" and arr.dtype == np.int8)


_LM_NORMS = ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
             "post_feedforward_layernorm")


def _lm_entry_to_torch(rel: str, arr: np.ndarray):
    """One flax Gemma-style LM param as (HF Gemma name, array)
    (``checkpoint/torch_interop.py:_lm_entry_to_torch`` of the JAX package).
    LoRA factors keep their JAX layout under ``<proj>_lora.{a,b}``; an MoE
    layer's router kernel is transposed, its stacked expert tensors kept
    verbatim."""
    parts = rel.split("/")
    if rel == "embed_tokens/embedding":
        return "model.embed_tokens.weight", arr
    if rel == "norm/weight":
        return "model.norm.weight", arr
    if parts[0].startswith("layer_"):
        base = f"model.layers.{parts[0].split('_')[1]}"
        if _quantized_leaf(parts[-1], arr):  # int8 / int4 leaves: JAX layout, same leaf name
            owner = "self_attn." + parts[2] if parts[1] == "self_attn" else "mlp." + parts[1]
            return f"{base}.{owner}.{parts[-1]}", arr
        if parts[1] == "self_attn":
            sub = parts[2]
            if sub.endswith("_lora"):  # [in, r] / [r, out], verbatim
                return f"{base}.self_attn.{sub}.{parts[3]}", arr
            if sub in ("q_norm", "k_norm"):  # (head_dim,) RMSNorm weights
                return f"{base}.self_attn.{sub}.weight", arr
            if sub == "o_proj":  # (heads, hd, H)
                return f"{base}.self_attn.o_proj.weight", arr.reshape(-1, arr.shape[-1]).T
            if sub in ("q_proj", "k_proj", "v_proj"):  # (H, heads, hd)
                return f"{base}.self_attn.{sub}.weight", arr.reshape(arr.shape[0], -1).T
        if parts[1] in ("gate_proj", "up_proj", "down_proj"):
            return f"{base}.mlp.{parts[1]}.weight", arr.T
        if parts[1].endswith("_lora"):  # the MLP's LoRA factors, verbatim
            return f"{base}.mlp.{parts[1]}.{parts[2]}", arr
        if parts[1] == "moe":  # router/kernel [H, E]; experts_* [E, ...]
            if parts[2] == "router":
                return f"{base}.moe.router.weight", arr.T
            return f"{base}.moe.{parts[2]}", arr
        if parts[1] in _LM_NORMS:
            return f"{base}.{parts[1]}.weight", arr
    raise KeyError(f"Unmapped LM param: {rel}")


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            flat.update(_flatten(node, path + "/"))
        else:
            flat[path] = np.asarray(node)
    return flat


def _tensor(name: str, arr: np.ndarray) -> torch.Tensor:
    """A converted leaf as a tensor: int8 stays int8, a quantization
    ``scale`` keeps its type (bf16 for int4, float32 for int8), every
    other leaf becomes float32."""
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    if name.endswith(".scale") and arr.dtype.name == "bfloat16":
        return t.to(torch.bfloat16)  # exact: the values are bf16
    return t


def _lm_entries(rel: str, arr: np.ndarray):
    """[(HF Gemma name, array)] of one flax LM leaf; a scanned stack's leaf
    (``layers_scan/block/<sub>``, ``LMConfig.scan_layers``) splits on its
    leading layer axis into ``layer_{i}/<sub>`` (JAX
    ``checkpoint/torch_interop.py:459-467``)."""
    if rel.startswith("layers_scan/block/"):
        sub = rel[len("layers_scan/block/"):]
        return [_lm_entry_to_torch(f"layer_{i}/{sub}", arr[i]) for i in range(arr.shape[0])]
    return [_lm_entry_to_torch(rel, arr)]


def lm_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A bare JAX ``CausalLM`` tree (scanned or not) -> the port's
    ``CausalLM`` state dict (``model.*``; JAX ``lm_params_to_torch``)."""
    params = params.get("params", params)
    return {name: _tensor(name, t) for key, arr in _flatten(params).items()
            for name, t in _lm_entries(key, arr)}


def state_dict_from_jax(params, patch_size: int) -> Dict[str, torch.Tensor]:
    """JAX MLLM params (numpy leaves, optionally under "params") -> the
    port's state dict: float32 tensors, and the quantized leaves in their
    own types.  A scanned LM stack unstacks into per-layer names."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params).items():
        tower, rel = key.split("/", 1)
        if tower == "vision_model":
            pairs = [(f"vision_model.{n}", t) for n, t in _vit_export(rel, arr, patch_size)]
        elif tower == "projector":
            pairs = [("projector.weight", arr.T) if rel == "kernel" else ("projector.bias", arr)]
        elif tower == "language_model":
            pairs = [(f"language_model.{name}", t) for name, t in _lm_entries(rel, arr)]
        else:
            raise KeyError(f"Unknown MLLM tower: {tower}")
        for name, t in pairs:
            sd[name] = _tensor(name, t)
    return sd


def _text_entry(rel: str, arr: np.ndarray):
    """One flax CLIP text-tower param as (port name under ``text.``, array)."""
    parts = rel.split("/")
    if rel == "token_embedding/embedding":  # the dense table, or a partitioned one's full table
        return "token_embedding.weight", arr
    if rel == "token_embedding/active":  # a partitioned table's trainable subtable
        return "token_embedding.active", arr
    if rel == "positional_embedding":
        return "positional_embedding", arr
    leaf = {"scale": "weight", "bias": "bias", "kernel": "weight"}[parts[-1]]
    if parts[0] == "ln_final":
        return f"ln_final.{leaf}", arr
    if parts[0].startswith("block_"):
        name = f"blocks.{parts[0].split('_')[1]}.{parts[1]}.{leaf}"
        if parts[2] == "kernel":
            if parts[1] in ("q", "k", "v"):  # (W, heads, hd)
                arr = arr.reshape(arr.shape[0], -1).T
            elif parts[1] == "out":  # (heads, hd, W)
                arr = arr.reshape(-1, arr.shape[-1]).T
            else:  # mlp_fc / mlp_proj (in, out)
                arr = arr.T
        elif parts[1] in ("q", "k", "v"):  # bias (heads, hd)
            arr = arr.reshape(-1)
        return name, arr
    raise KeyError(f"Unmapped CLIP text param: {rel}")


def clip_state_dict_from_jax(params, patch_size: int) -> Dict[str, torch.Tensor]:
    """JAX ``CLIPModel`` params (numpy leaves, optionally under "params")
    -> the port's ``CLIPModel`` state dict of float32 tensors (load it with
    ``strict=True``).  A partitioned tree's ``text/token_embedding/
    {embedding, active}`` become ``text.token_embedding.{weight, active}``."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params).items():
        top, _, rel = key.partition("/")
        if top == "visual":
            pairs = [(f"visual.{n}", t) for n, t in _vit_export(rel, arr, patch_size)]
        elif top in ("visual_projection", "text_projection"):
            pairs = [(f"{top}.weight", arr.T)]
        elif top == "logit_scale":
            pairs = [("logit_scale", arr)]
        elif top == "text":
            name, t = _text_entry(rel, arr)
            pairs = [(f"text.{name}", t)]
        else:
            raise KeyError(f"Unknown CLIP param: {key}")
        for name, t in pairs:
            sd[name] = torch.from_numpy(np.array(t, dtype=np.float32))
    return sd


def vit_classifier_state_dict_from_jax(params, patch_size: int) -> Dict[str, torch.Tensor]:
    """JAX ``ViTForImageClassification`` params (numpy leaves, optionally
    under "params") -> the port's classifier state dict of float32 tensors
    (load it with ``strict=True``)."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params).items():
        head, rel = key.split("/", 1)
        if head == "vit":
            pairs = [(f"vit.{n}", t) for n, t in _vit_export(rel, arr, patch_size)]
        elif head == "classifier":
            pairs = [("classifier.weight", arr.T) if rel == "kernel" else ("classifier.bias", arr)]
        else:
            raise KeyError(f"Unknown classifier component: {head}")
        for name, t in pairs:
            sd[name] = torch.from_numpy(np.array(t, dtype=np.float32))
    return sd


def build_mllm(cfg: MLLMConfig, state_dict: Dict[str, torch.Tensor], device) -> MLLM:
    """An MLLM on ``device`` holding ``state_dict`` (strict), linear weights
    in ``cfg.dtype``.  Built on the meta device first, so no memory is spent
    on a throwaway initialisation."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = MLLM(cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    for p in model.parameters():  # quantized buffers keep their int8 / bf16 types
        p.data = p.data.float()
    model = model.to(dev)
    cast_for_compute(model, cfg.dtype)
    return model.eval()


@torch.no_grad()
def init_random_weights_(model: nn.Module, generator: torch.Generator, std: float = 0.02):
    """Seeded in-place init with the JAX package's initialisers."""
    for mod in model.modules():
        if isinstance(mod, RMSNorm):
            mod.weight.zero_()
        elif isinstance(mod, (LoRAAdapter, PartitionedEmbed, MoEMLP)):
            mod.reset_parameters(generator, std)
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
        elif name == "text.positional_embedding":  # CLIP's text positions: normal(0.01)
            p.normal_(0.0, 0.01, generator=generator)
        elif name == "logit_scale":  # CLIP's temperature: log(1 / 0.07)
            p.fill_(math.log(1.0 / 0.07))
    return model


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout ``.pt`` (a flat dict of tensors) as float32 tensors."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items()}


def host_state_dict(model: nn.Module, frozen: Dict[str, torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict as float32 CPU tensors; with ``frozen``, every
    parameter that does not require grad is taken from it instead."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in model.state_dict().items():
        p = params.get(name)
        if frozen is not None and p is not None and not p.requires_grad:
            out[name] = frozen[name]
        else:
            out[name] = t.detach().float().cpu()
    return out


def changed_frozen(model: nn.Module, reference: Dict[str, torch.Tensor]) -> List[str]:
    """Names of ``model``'s frozen parameters that are not bitwise
    ``reference[name]`` (host float32) cast to their storage dtype."""
    return [name for name, p in model.named_parameters() if not p.requires_grad
            and not torch.equal(p.detach(), reference[name].to(p.device, p.dtype))]


def save_state_dict(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    """Write a reference-layout ``.pt`` (a flat dict of float32 tensors)."""
    torch.save({k: v.detach().float().cpu().contiguous() for k, v in state_dict.items()}, path)


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
    "changed_frozen",
    "clip_state_dict_from_jax",
    "host_state_dict",
    "init_random_weights_",
    "lm_state_dict_from_jax",
    "load_state_dict",
    "save_results_dir",
    "save_state_dict",
    "state_dict_from_jax",
    "vit_classifier_state_dict_from_jax",
]
