"""Vision Transformer tower (counterpart of multimodal_concept_learning_tpu/models/vit.py).

Only the encoder the MLLM uses (``ViTEncoder`` -> last_hidden_state
[B, 1 + N, H]) in the JAX package's default ``bthd`` branch: pre-LN
blocks, exact-erf GELU, LayerNorm (eps 1e-12) in float32, compute dtype
from the config.  The patch embedding is a reshape plus one matrix product
(no convolution); its weight keeps HF's Conv2d layout [H, C, p, p] so the
reference checkpoint loads as is.  Parameter names are HF ViTModel's, as
``checkpoint/torch_interop.mllm_params_to_torch`` writes them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_concept_learning_tpu_torch.ops.attention import multi_head_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16  # compute dtype; norms and embeddings stay float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @classmethod
    def preset(cls, name: str) -> "ViTConfig":
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
        return cls(**presets[name])


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
        return F.linear(x, weight, self.projection.bias)


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


def _dense(in_features: int, out_features: int) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": nn.Linear(in_features, out_features)})


class ViTLayer(nn.Module):
    """Pre-LN block (HF ViTLayer naming)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.attention = nn.ModuleDict({
            "attention": nn.ModuleDict({n: nn.Linear(h, h) for n in ("query", "key", "value")}),
            "output": _dense(h, h),
        })
        self.intermediate = _dense(h, cfg.intermediate_size)
        self.output = _dense(cfg.intermediate_size, h)
        self.layernorm_before = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        heads = cfg.num_attention_heads
        hd = cfg.hidden_size // heads
        h = layer_norm_f32(self.layernorm_before, x).to(cfg.dtype)
        proj = self.attention["attention"]
        q, k, v = (proj[n](h).view(b, t, heads, hd) for n in ("query", "key", "value"))
        a = multi_head_attention(q, k, v)
        x = x + self.attention["output"]["dense"](a.reshape(b, t, cfg.hidden_size))
        h = layer_norm_f32(self.layernorm_after, x).to(cfg.dtype)
        h = F.gelu(self.intermediate["dense"](h))  # exact erf GELU, as HF ViT
        return x + self.output["dense"](h)


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

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(images, self.cfg.dtype)
        for layer in self.encoder.layer:
            x = layer(x)
        return layer_norm_f32(self.layernorm, x)


__all__ = ["ViTConfig", "ViTEncoder", "ViTLayer"]
