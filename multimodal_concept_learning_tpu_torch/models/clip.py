"""CLIP-style dual encoder (counterpart of
multimodal_concept_learning_tpu/models/clip.py).

Image tower: the port's ``ViTEncoder`` in the ``pallas_core`` layout (the
packed qkv projection into K2, ``ops/attention_core.py``) with tanh GELU,
and a bias-free projection of the CLS token.  Text tower: pre-LN causal
transformer (LayerNorm eps 1e-6 in float32, learned positions, tanh GELU),
every block's attention through K2 with ``causal`` and the caption mask as
``kv_mask``, pooled at the last valid token after ``ln_final``.  Features
are L2-normalised in float32; the similarity scale is ``exp(logit_scale)``
with ``logit_scale`` clipped at log(100).  Both towers compute in the config's
dtype over float32 parameters, every weight cast at use.

The JAX model takes K2 only on a TPU and its XLA path elsewhere; the port
takes K2 on every device (the CPU runs K2's plain version).  Two variants,
off by default as in the JAX package: ``MCL_ATTN_CORE_BD=1`` (read at each
call) puts K2-bd, the sample-merged kernels, in place of K2 in both towers;
a vision config with ``fused_attention=True`` (a ``dataclasses.replace`` of
``config.vision``, as ``scripts/bench_fused_attention.py`` builds it) runs
every image block's attention sublayer through K6
(``ops/fused_attention_block.py``).  ``contrastive_loss``'s ``group``
(JAX's ``axis_name``: a batch striped over ranks) all-gathers the
features with their gradient.  ``active_vocab_rows`` (sorted ids, every one the caption corpus can
produce) partitions the text embedding (``ops/sparse_embed.py``): a frozen
full table under the dense name ``text.token_embedding.weight`` and the
trainable subtable ``text.token_embedding.active``.  A dense model loads
such a state dict with ``strict=True`` and ignores ``active``: in a saved
checkpoint the table already holds the trained rows
(``merged_embedding``); an unmerged pair (a resume checkpoint) loads into a
partitioned model only.  The similarity scale is ``exp(minimum(logit_scale,
log(100)))`` with the bound in the parameter's dtype and ``exp`` in
float32: what XLA computes for JAX's jitted train step.  Under
``bf16_params`` the bound rounds to bf16 (4.59375, a largest scale of
98.86), and the bf16 rounding of ``exp``'s result, which an eager JAX
``apply`` shows, is not kept once the scale feeds a float32 product (XLA's
default excess precision); ``minimum`` splits the gradient at a tie, as
JAX's does.  Parameter names
follow the JAX tree (``checkpoint.clip_state_dict_from_jax`` maps one onto
the other).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_concept_learning_tpu_torch.device import linear
from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTEncoder, layer_norm_f32
from multimodal_concept_learning_tpu_torch.ops.attention_core import attention_core_padded
from multimodal_concept_learning_tpu_torch.ops.sparse_embed import PartitionedEmbed
from multimodal_concept_learning_tpu_torch.parallel.multihost import gather_rows


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: ViTConfig
    vocab_size: int = 2048
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    embed_dim: int = 512
    dtype: torch.dtype = torch.bfloat16
    # sorted ids the caption corpus can produce: the partitioned text
    # embedding (ops/sparse_embed.py); None = the dense table
    active_vocab_rows: Optional[Tuple[int, ...]] = None

    @classmethod
    def create(cls, vocab_size: int, vision_preset: str = "vit-b-32", image_size: int = 224,
               text_width: int = 512, text_layers: int = 12, text_heads: int = 8,
               context_length: int = 77, embed_dim: int = 512,
               dtype: torch.dtype = torch.bfloat16,
               active_vocab_rows: Optional[Tuple[int, ...]] = None) -> "CLIPConfig":
        vision = dataclasses.replace(ViTConfig.preset(vision_preset), image_size=image_size,
                                     gelu_approximate=True, attention_layout="pallas_core",
                                     dtype=dtype)
        return cls(vision=vision, vocab_size=vocab_size, text_width=text_width,
                   text_layers=text_layers, text_heads=text_heads,
                   context_length=context_length, embed_dim=embed_dim, dtype=dtype,
                   active_vocab_rows=(tuple(active_vocab_rows)
                                      if active_vocab_rows is not None else None))


class TextBlock(nn.Module):
    """Pre-LN causal block; q/k/v concatenated at use into one packed
    projection for K2."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-6)
        self.q, self.k, self.v = (nn.Linear(width, width) for _ in range(3))
        self.out = nn.Linear(width, width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp_fc = nn.Linear(width, 4 * width)
        self.mlp_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor, kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.dtype
        h = layer_norm_f32(self.ln_1, x).to(dt)
        w = torch.cat([p.weight.to(dt) for p in (self.q, self.k, self.v)])
        b = torch.cat([p.bias.to(dt) for p in (self.q, self.k, self.v)])
        a = attention_core_padded(F.linear(h, w, b), self.heads, causal=True, kv_mask=kv_mask)
        x = x + linear(self.out, a, dt)
        h = layer_norm_f32(self.ln_2, x).to(dt)
        h = F.gelu(linear(self.mlp_fc, h, dt), approximate="tanh")
        return x + linear(self.mlp_proj, h, dt)


class TextEncoder(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.active_vocab_rows is not None:
            self.token_embedding = PartitionedEmbed(cfg.vocab_size, cfg.text_width,
                                                    cfg.active_vocab_rows)
        else:
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.text_width))
        self.blocks = nn.ModuleList(TextBlock(cfg.text_width, cfg.text_heads, cfg.dtype)
                                    for _ in range(cfg.text_layers))
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-6)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a dense table ignores a partitioned checkpoint's subtable (module docstring)
        if isinstance(self.token_embedding, nn.Embedding):
            state_dict.pop(prefix + "token_embedding.active", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, T] ids -> float32 [B, width] at each row's last valid token."""
        dt = self.cfg.dtype
        b, t = input_ids.shape
        x = self.token_embedding(input_ids.long()).to(dt) + self.positional_embedding[:t].to(dt)
        kv_mask = None if attention_mask is None else attention_mask.to(torch.int32)
        for block in self.blocks:
            x = block(x, kv_mask)
        x = layer_norm_f32(self.ln_final, x)
        if attention_mask is not None:
            last = (kv_mask.sum(dim=1) - 1).clamp(min=0)
        else:
            last = torch.full((b,), t - 1, device=x.device)
        return x[torch.arange(b, device=x.device), last.long()]


def _l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


class CLIPModel(nn.Module):
    """Dual encoder producing L2-normalised image/text features + logit scale."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = ViTEncoder(cfg.vision)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.embed_dim, bias=False)
        self.text = TextEncoder(cfg)
        self.text_projection = nn.Linear(cfg.text_width, cfg.embed_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(linear(self.visual_projection, self.visual(images)[:, 0],
                                    self.cfg.dtype))

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _l2_normalize(linear(self.text_projection, self.text(input_ids, attention_mask),
                                    self.cfg.dtype))

    def forward(self, images, input_ids, attention_mask=None):
        img = self.encode_image(images)
        txt = self.encode_text(input_ids, attention_mask)
        ls = self.logit_scale  # the bound in its dtype, exp in float32 (module docstring)
        bound = torch.tensor(math.log(100.0), device=ls.device).to(ls.dtype)
        scale = torch.exp(torch.minimum(ls, bound).float())
        return img, txt, scale


def contrastive_loss(img: torch.Tensor, txt: torch.Tensor, scale: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the batch.  With ``group`` (an
    ``parallel.collectives.AxisGroup`` the batch is striped over: JAX's
    ``axis_name``) the features are all-gathered with their gradient, so
    the negatives span the global batch, and the value is this rank's
    rows' loss (JAX's per-shard value; the train step instead takes the
    global [B, B] loss over gathered features)."""
    b = img.shape[0]
    if group is None:
        all_img, all_txt, offset = img, txt, 0
    else:
        all_img, all_txt, offset = gather_rows(img, group), gather_rows(txt, group), group.index * b
    labels = offset + torch.arange(b, device=img.device)
    logits_per_image = scale * img @ all_txt.T
    logits_per_text = scale * txt @ all_img.T
    return 0.5 * (F.cross_entropy(logits_per_image, labels)
                  + F.cross_entropy(logits_per_text, labels))


__all__ = ["CLIPConfig", "CLIPModel", "TextBlock", "TextEncoder", "contrastive_loss"]
