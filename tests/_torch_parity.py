"""Helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds a tiny float32 JAX ``MLLM`` with seeded, perturbed parameters (so
zero-initialised norms and biases are exercised too), exports it with the
port's ``state_dict_from_jax`` and loads it into the port on the CPU.
Inputs come from numpy with a seed and go to both sides as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

# a small Gemma-3-shaped LM: qk-norm, sandwich norms, 1 kv head, window
# below the prompt length, query_pre_attn_scalar != head_dim
GEMMA_SMALL = dict(hidden_size=64, intermediate_size=96, num_layers=3, num_heads=4,
                   num_kv_heads=1, head_dim=32, rope_theta=1_000_000.0,
                   rope_local_theta=10_000.0, use_qk_norm=True, sandwich_norms=True,
                   sliding_window=8, sliding_window_pattern=3, query_pre_attn_scalar=48.0)


def jax_config(lm_overrides=None, vocab: int = 64, image_size: int = 32):
    """Float32 JAX MLLMConfig: vit-t-8 tower + nano LM (with overrides)."""
    from multimodal_concept_learning_tpu.models.mllm import MLLMConfig

    cfg = MLLMConfig.create(vocab_size=vocab, vision_preset="vit-t-8", lm_preset="nano",
                            num_vision_tokens=(image_size // 8) ** 2 + 1,
                            image_size=image_size)
    lm = dataclasses.replace(cfg.lm, dtype=jnp.float32, **(lm_overrides or {}))
    return dataclasses.replace(cfg, dtype=jnp.float32, lm=lm,
                               vision=dataclasses.replace(cfg.vision, dtype=jnp.float32))


def port_config(jcfg):
    """The port's float32 MLLMConfig with the same fields as ``jcfg``."""
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig

    def same(cls, src):
        names = [f.name for f in dataclasses.fields(cls) if f.name != "dtype"]
        return cls(**{n: getattr(src, n) for n in names}, dtype=torch.float32)

    return MLLMConfig(vision=same(ViTConfig, jcfg.vision), lm=same(LMConfig, jcfg.lm),
                      num_vision_tokens=jcfg.num_vision_tokens, dtype=torch.float32)


def make_pair(lm_overrides=None, seed: int = 0, vocab: int = 64, jcfg=None):
    """(jax MLLM module, numpy params, port MLLM on the CPU) with equal
    weights; ``jcfg`` (a float32 JAX MLLMConfig) replaces ``jax_config``."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax

    jcfg = jax_config(lm_overrides, vocab=vocab) if jcfg is None else jcfg
    model = JaxMLLM(jcfg)
    nvt = jcfg.num_vision_tokens
    size = jcfg.vision.image_size
    params = jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, 3, size, size)),
                                 jnp.zeros((1, nvt + 4), jnp.int32),
                                 jnp.ones((1, nvt + 4), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params)
    port = build_mllm(port_config(jcfg), state_dict_from_jax(params, jcfg.vision.patch_size),
                      "cpu")
    return model, params, port


def prompt_batch(cfg, lens, seed: int = 0):
    """Right-padded (images, ids, mask) numpy arrays; ``lens`` = text tokens per row."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    nvt = cfg.num_vision_tokens
    t = nvt + max(lens) + 2
    size = cfg.vision.image_size
    images = rng.standard_normal((b, 3, size, size)).astype(np.float32)
    ids = rng.integers(1, cfg.lm.vocab_size, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for i, n in enumerate(lens):
        mask[i, : nvt + n] = 1
    ids[mask == 0] = 0
    return images, ids, mask


# the serving tests' requests and the JAX loader at float32 compute
SERVE_PROMPTS = [
    "Is the color of the circle red?",
    "Is the color of the circle green?",
    "Is the color of the circle blue?",
    "Is the color of the circle orange?",
]


def circle(rgb, size=32):
    """[3, size, size] float image in [0, 1] (the ToTensor eval transform), no PIL."""
    yy, xx = np.mgrid[:size, :size]
    inside = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 <= (size // 3) ** 2
    img = np.ones((3, size, size), np.float32)
    img[:, inside] = np.asarray(rgb, np.float32)[:, None] / 255.0
    return img


SERVE_IMAGES = [circle([255, 0, 0]), circle([0, 255, 0]), circle([0, 0, 255]),
                circle([255, 128, 0])]


def _jax_float32(loaded):
    """A JAX ``LoadedMLLM`` switched to float32 compute."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM

    cfg = loaded.model.config
    f32 = dataclasses.replace(cfg, dtype=jnp.float32,
                              vision=dataclasses.replace(cfg.vision, dtype=jnp.float32),
                              lm=dataclasses.replace(cfg.lm, dtype=jnp.float32))
    return loaded._replace(model=MLLM(f32))


def jax_serving_load(results_dir, **quant):
    """The JAX package's loaded model (serve/loader.py), switched to float32 compute."""
    from multimodal_concept_learning_tpu.serve import load_trained_mllm

    return _jax_float32(load_trained_mllm(results_dir, verbose=False, **quant))


def jax_bank_load(results_dir, adapter_dirs, **quant):
    """The JAX package's multi-LoRA bank, switched to float32 compute."""
    from multimodal_concept_learning_tpu.serve.loader import load_adapter_bank

    return _jax_float32(load_adapter_bank(results_dir, adapter_dirs, verbose=False, **quant))


def port_serving_load(results_dir, **quant):
    """The port's loaded model on the CPU at float32."""
    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm

    return load_trained_mllm(results_dir, device="cpu", dtype=torch.float32, verbose=False,
                             **quant)


def port_bank_load(results_dir, adapter_dirs, **quant):
    """The port's multi-LoRA bank on the CPU at float32."""
    from multimodal_concept_learning_tpu_torch.serve.loader import load_adapter_bank

    return load_adapter_bank(results_dir, adapter_dirs, device="cpu", dtype=torch.float32,
                             verbose=False, **quant)


# tiny language_lora results dirs, written by the port's checkpoint writer
LORA_RANK = 4
LORA_CONFIG = {
    "prompt_template": "Is the color of the circle {class_name}?",
    "dataset_name": "color_multimodal", "vision_model_name": "vit-t-8",
    "language_model_name": "nano", "num_vision_tokens": 17, "image_size": 32,
    "trainable_params_setting": "language_lora", "lm_lora_rank": LORA_RANK, "seed": 0,
    "train_transforms": ["ToTensor"], "val_transforms": ["ToTensor"], "use_wandb": False,
}


def _surface_noise(sd, seed: int, scale: float = 0.05):
    """``sd`` with seeded normal noise added to its adapter surface (the
    LoRA factors and the projector), as a trained adapter differs from its
    base."""
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import is_adapter_name

    rng = np.random.default_rng(seed)
    return {k: v + torch.from_numpy(scale * rng.standard_normal(tuple(v.shape)).astype(np.float32))
            if is_adapter_name(k) else v for k, v in sd.items()}


def write_lora_results_dir(root, seed: int = 0, **overrides) -> str:
    """A random-init ``language_lora`` results dir (vit-t-8, nano, rank 4),
    its LoRA factors and projector moved off the init; returns its path."""
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        init_random_weights_,
        save_results_dir,
    )
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, model_config

    root = str(root)
    config = MultimodalTrainingConfig.from_params(dict(LORA_CONFIG, results_dir=root,
                                                       **overrides))
    tokenizer, _ = build_tokenizer(config)
    model = MLLM(model_config(config, len(tokenizer), torch.float32))
    init_random_weights_(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(_surface_noise(model.state_dict(), seed))
    save_results_dir(root, model, tokenizer, vars(config))
    return root


def adapter_copy(src: str, dst, seed: int) -> str:
    """A copy of the results dir ``src`` whose adapter surface carries
    seeded noise (another adapter trained from the same base)."""
    import os
    import shutil

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict, save_state_dict

    dst = str(dst)
    shutil.copytree(src, dst)
    path = os.path.join(dst, "models", "best_model.pt")
    save_state_dict(_surface_noise(load_state_dict(path), seed), path)
    return dst
