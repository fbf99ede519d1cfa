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


def make_pair(lm_overrides=None, seed: int = 0, vocab: int = 64):
    """(jax MLLM module, numpy params, port MLLM on the CPU) with equal weights."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax

    jcfg = jax_config(lm_overrides, vocab=vocab)
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
