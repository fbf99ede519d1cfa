"""Vision Transformer (counterpart of multimodal_concept_learning_tpu/models/vit.py).

The encoder (``ViTEncoder`` -> last_hidden_state [B, 1 + N, H]) and the
classifier (``ViTForImageClassification``: the encoder under ``vit`` and a
float32 linear head on the CLS row of the float32 final LayerNorm).  The
JAX package's attention layouts: ``bthd`` (the default, the MLLM's and the
classifier's; q, k, v [B, T, H, D] through K1), ``pallas_core`` (CLIP's;
one packed [q | k | v] projection through K2, ``ops/attention_core.py``),
and ``bhtd`` and ``qkv_fused``, the JAX package's XLA layouts of the same
math over the same parameters, which run the ``bthd`` branch here (a layout
has no cost model in eager PyTorch).  Pre-LN blocks, exact-erf GELU
(tanh with ``gelu_approximate``), LayerNorm (eps 1e-12) in float32,
compute dtype from the config (every weight cast at use, so float32
parameters train in the compute dtype, as under ``vision_only``).  The
patch embedding is a reshape plus one matrix product (no convolution); its
weight keeps HF's Conv2d layout [H, C, p, p] so the reference checkpoint
loads as is.  Parameter names are HF's (``ViTModel``; the classifier's
``vit.*`` and ``classifier.*``), as ``checkpoint/torch_interop.py`` writes
them.

Dropout sits where the JAX package has it: after the position embeddings,
on the attention probabilities (``ops/attention.multi_head_attention``'s
dense branch), after the attention output and after the MLP, each drawn
from the ``generator`` a training forward passes with
``deterministic=False``.  The branch order is JAX's, without its TPU
platform test: ``int8_weights`` (serving: int8 q/k/v, attention output and
MLP, ``ops/quant.py``; the patch embedding and norms stay float) takes the
``bthd`` branch; then ``fused_attention`` runs each block's attention
sublayer (LN, packed qkv projection, attention, output projection,
residual) through K6 (``ops/fused_attention_block.py``) when the call is
deterministic and the config has no dropout; then ``pallas_core`` when the
config has no dropout; else ``bthd``.
The parameters stay the same in every branch.  A deterministic call draws
nothing, so every forward of the MLLM and of CLIP is what it was before
dropout was ported.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_concept_learning_tpu_torch.device import linear
from multimodal_concept_learning_tpu_torch.ops.attention import dropout, multi_head_attention
from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded
from multimodal_concept_learning_tpu_torch.ops.fused_attention_block import (
    attention_sublayer,
    pack_qkv,
)
from multimodal_concept_learning_tpu_torch.ops.quant import QuantLinear

LAYOUTS = ("bthd", "pallas_core", "bhtd", "qkv_fused")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    num_labels: int = 100  # the classifier's classes
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype; norms and embeddings stay float32
    gelu_approximate: bool = False  # tanh GELU (the CLIP towers'), else exact erf
    # "bthd" (and "bhtd", "qkv_fused"): K1 on [B, T, H, D]; "pallas_core": K2 on packed qkv
    attention_layout: str = "bthd"
    int8_weights: bool = False  # serving: int8 block projections (ops/quant.py)
    fused_attention: bool = False  # K6: the whole attention sublayer in one op

    def __post_init__(self):
        if self.attention_layout not in LAYOUTS:
            raise ValueError(f"attention_layout {self.attention_layout!r} is not one of {LAYOUTS}")

    @property
    def has_dropout(self) -> bool:
        return self.hidden_dropout_prob > 0 or self.attention_probs_dropout_prob > 0

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @classmethod
    def from_training_config(cls, config, image_size: int = None) -> "ViTConfig":
        """From a ``VisionTrainingConfig`` (the JAX ``ViTConfig.from_training_config``)."""
        return cls(hidden_size=config.hidden_size, intermediate_size=config.intermediate_size,
                   num_hidden_layers=config.num_hidden_layers,
                   num_attention_heads=config.num_attention_heads,
                   patch_size=config.patch_size, image_size=image_size or config.image_size,
                   hidden_dropout_prob=config.hidden_dropout_prob,
                   attention_probs_dropout_prob=config.attention_dropout_prob,
                   num_labels=config.num_labels)

    @classmethod
    def preset(cls, name: str, num_labels: int = 0) -> "ViTConfig":
        presets = {
            "vit-t-8": dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, patch_size=8),
            "vit-s-16": dict(hidden_size=384, intermediate_size=1536, num_hidden_layers=12,
                             num_attention_heads=6, patch_size=16),
            "vit-b-16": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                             num_attention_heads=12, patch_size=16),
            "vit-b-32": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                             num_attention_heads=12, patch_size=32),
            "vit-l-14": dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                             num_attention_heads=16, patch_size=14),
        }
        if name not in presets:
            raise ValueError(f"Unknown ViT preset: {name}")
        return cls(num_labels=num_labels, **presets[name])


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics and output (flax LayerNorm, dtype=float32)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        p = cfg.patch_size
        # parameter holder in HF's layout; applied as one matrix product
        self.projection = nn.Conv2d(cfg.num_channels, cfg.hidden_size, p, stride=p)

    def forward(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """[B, C, H, W] -> [B, N, hidden]."""
        b, c, h, w = images.shape
        p = self.projection.kernel_size[0]
        x = images.to(dtype).reshape(b, c, h // p, p, w // p, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), c * p * p)
        weight = self.projection.weight.reshape(self.projection.out_channels, -1)
        return F.linear(x, weight.to(dtype), self.projection.bias.to(dtype))


class _Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, cfg.seq_len, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg)

    def forward(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.patch_embeddings(images, dtype)
        cls = self.cls_token.to(dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings.to(dtype)


def _linear(cfg: ViTConfig, in_features: int, out_features: int) -> nn.Module:
    if cfg.int8_weights:
        return QuantLinear(in_features, out_features, bias=True)
    return nn.Linear(in_features, out_features)


def _dense(cfg: ViTConfig, in_features: int, out_features: int) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": _linear(cfg, in_features, out_features)})


class ViTLayer(nn.Module):
    """Pre-LN block (HF ViTLayer naming)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.attention = nn.ModuleDict({
            "attention": nn.ModuleDict({n: _linear(cfg, h, h) for n in ("query", "key", "value")}),
            "output": _dense(cfg, h, h),
        })
        self.intermediate = _dense(cfg, h, cfg.intermediate_size)
        self.output = _dense(cfg, cfg.intermediate_size, h)
        self.layernorm_before = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        heads = cfg.num_attention_heads
        hd = cfg.hidden_size // heads
        dt = cfg.dtype
        proj = self.attention["attention"]
        names = ("query", "key", "value")
        out = self.attention["output"]["dense"]
        # JAX takes the K6, packed and layout branches only without int8 weights or dropout
        variants = not cfg.has_dropout and not cfg.int8_weights
        drop = dict(generator=generator, deterministic=deterministic)
        if cfg.fused_attention and variants and deterministic:
            # K6: [q | k | v] packed at use in the JAX layout, the sublayer in one op
            wqkv, bqkv = pack_qkv(*(a for n in names for a in (proj[n].weight, proj[n].bias)))
            ln = self.layernorm_before
            x = attention_sublayer(x.to(dt), ln.weight, ln.bias, wqkv, bqkv, out.weight.t(),
                                   out.bias, heads, cfg.layer_norm_eps)
        else:
            h = layer_norm_f32(self.layernorm_before, x).to(dt)
            if variants and cfg.attention_layout == "pallas_core":
                # one packed projection, [q | k | v] concatenated at use, into K2
                w = torch.cat([proj[n].weight.to(dt) for n in names])
                bias = torch.cat([proj[n].bias.to(dt) for n in names])
                a = attention_core_padded(F.linear(h, w, bias), heads)
            else:
                q, k, v = (linear(proj[n], h, dt).view(b, t, heads, hd) for n in names)
                a = multi_head_attention(q, k, v, dropout_rate=cfg.attention_probs_dropout_prob,
                                         **drop).reshape(b, t, cfg.hidden_size)
            x = x + dropout(linear(out, a, dt), cfg.hidden_dropout_prob, **drop)
        h = layer_norm_f32(self.layernorm_after, x).to(dt)
        gelu = "tanh" if cfg.gelu_approximate else "none"  # exact erf: HF ViT
        h = F.gelu(linear(self.intermediate["dense"], h, dt), approximate=gelu)
        return x + dropout(linear(self.output["dense"], h, dt), cfg.hidden_dropout_prob, **drop)


class _Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg) for _ in range(cfg.num_hidden_layers))


class ViTEncoder(nn.Module):
    """Returns last_hidden_state [B, 1 + N, H] in float32 (parity:
    ViTModel.last_hidden_state and the JAX ``ViTEncoder``)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> torch.Tensor:
        cfg = self.cfg
        x = dropout(self.embeddings(images, cfg.dtype), cfg.hidden_dropout_prob, generator,
                    deterministic)
        for layer in self.encoder.layer:
            x = layer(x, deterministic, generator)
        return layer_norm_f32(self.layernorm, x)


class ViTForImageClassification(nn.Module):
    """The encoder plus a float32 linear classifier on the CLS row (HF head
    semantics; the JAX ``ViTForImageClassification``).  A training forward
    passes ``deterministic=False`` and the dropout ``generator``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.vit = ViTEncoder(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator = None) -> torch.Tensor:
        """[B, C, H, W] -> float32 logits [B, num_labels]."""
        hidden = self.vit(images, deterministic, generator)
        return F.linear(hidden[:, 0], self.classifier.weight.float(),
                        self.classifier.bias.float())


__all__ = ["ViTConfig", "ViTEncoder", "ViTForImageClassification", "ViTLayer"]
