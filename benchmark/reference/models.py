"""Plain float32 forward passes of the benchmark's two model families.

Functions of a flat ``{name: tensor}`` parameter dict (the names of the
published layouts: HF ``ViTModel`` for the image towers, the dual
encoder's own for CLIP), built from the published equations:

- ViT: patches of ``p x p`` unfolded channel-major (a strided convolution
  as a product), a CLS token and learned positions, pre-LN blocks
  (LayerNorm, multi-head softmax attention, residual, LayerNorm, GELU MLP,
  residual), a final LayerNorm.  The classifier reads the CLS row through
  a linear head; its loss is the mean softmax cross entropy.
- CLIP: that image tower with the config's GELU (tanh, as the port runs
  it) and a bias-free projection of the CLS row; a text tower of token
  embeddings plus learned positions through pre-LN causal blocks whose
  keys are also masked by the caption mask, a final LayerNorm (the
  config's ``text_layer_norm_eps``) read at each caption's last token and
  a bias-free projection; both features L2-normalised; the similarity scale
  ``exp(min(logit_scale, log 100))``; the symmetric InfoNCE over the batch.

Dropout (the classifier's) draws its keep masks from the generator it is
given, one ``torch.rand`` per site in the order the forward pass meets the
sites (after the embeddings, then in each block on the attention
probabilities, after the attention output and after the MLP), so the same
seed on the same device gives the same masks as any implementation that
draws the same way; a kept value is divided by the keep probability
rounded to the compute dtype the configuration states (flax rounds the
Python scalar to the array's dtype).

Nothing here imports the program: the weights and inputs are the
benchmark's, handed to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.numerics import Numerics

Params = Dict[str, torch.Tensor]
MASKED = -1e30


class Dropout:
    """Keep masks drawn from ``generator``; ``rate`` 0 (or ``generator``
    None) draws nothing."""

    def __init__(self, hidden: float, attention: float, generator: Optional[torch.Generator],
                 keep_dtype: torch.dtype = torch.bfloat16):
        self.hidden, self.attention, self.generator = hidden, attention, generator
        self.keep_dtype = keep_dtype

    def _apply(self, x, rate):
        if self.generator is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - rate
        kp = torch.tensor(1.0 - rate, dtype=self.keep_dtype).item()
        return torch.where(keep, x / kp, 0.0)

    def hidden_(self, x):
        return self._apply(x, self.hidden)

    def probs_(self, p):
        return self._apply(p, self.attention)


def layer_norm(x, p: Params, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def attention(num: Numerics, q, k, v, heads: int, key_ok=None, drop: Optional[Dropout] = None):
    """Softmax attention of [B, T, H*D] q, k, v; ``key_ok`` [B, Tq, Tk] bool."""
    b, t, width = q.shape
    d = width // heads
    q, k, v = (x.view(b, t, heads, d).transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    logits = num.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if key_ok is not None:
        logits = logits.masked_fill(~key_ok[:, None], MASKED)
    probs = torch.softmax(logits, dim=-1)
    if drop is not None:
        probs = drop.probs_(probs)
    return num.matmul(probs, v).transpose(1, 2).reshape(b, t, width)


def vit_tower(num: Numerics, p: Params, prefix: str, images, cfg: dict,
              gelu: str, drop: Optional[Dropout] = None):
    """[B, C, H, W] -> the final LayerNorm's output [B, 1 + N, hidden]."""
    ps, heads, eps = cfg["patch_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    pre = prefix + "embeddings."
    w = p[pre + "patch_embeddings.projection.weight"]
    patches = F.unfold(images, kernel_size=ps, stride=ps).transpose(1, 2)  # [B, N, C*p*p]
    x = num.linear(patches, w.reshape(w.shape[0], -1), p[pre + "patch_embeddings.projection.bias"])
    cls = p[pre + "cls_token"].expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1) + p[pre + "position_embeddings"]
    if drop is not None:
        x = drop.hidden_(x)
    for i in range(cfg["num_hidden_layers"]):
        blk = f"{prefix}encoder.layer.{i}."
        h = layer_norm(x, p, blk + "layernorm_before", eps)
        q, k, v = (num.linear(h, p[f"{blk}attention.attention.{n}.weight"],
                              p[f"{blk}attention.attention.{n}.bias"])
                   for n in ("query", "key", "value"))
        a = attention(num, q, k, v, heads, drop=drop)
        a = num.linear(a, p[blk + "attention.output.dense.weight"],
                       p[blk + "attention.output.dense.bias"])
        x = x + (drop.hidden_(a) if drop is not None else a)
        h = layer_norm(x, p, blk + "layernorm_after", eps)
        h = F.gelu(num.linear(h, p[blk + "intermediate.dense.weight"],
                              p[blk + "intermediate.dense.bias"]), approximate=gelu)
        h = num.linear(h, p[blk + "output.dense.weight"], p[blk + "output.dense.bias"])
        x = x + (drop.hidden_(h) if drop is not None else h)
    return layer_norm(x, p, prefix + "layernorm", eps)


def classifier_logits(num: Numerics, p: Params, images, cfg: dict,
                      drop: Optional[Dropout] = None):
    """[B, num_labels] float32 logits of the ViT classifier."""
    hidden = vit_tower(num, p, "vit.", images, cfg, "none", drop)
    return F.linear(hidden[:, 0], p["classifier.weight"], p["classifier.bias"])


def cross_entropy(logits, labels):
    return F.cross_entropy(logits.float(), labels.long())


def l2_normalize(x, eps: float = 1e-8):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


GELU = {"gelu_tanh": "tanh", "gelu": "none"}  # a config's hidden_act -> F.gelu's approximate


def clip_image_features(num: Numerics, p: Params, images, cfg: dict):
    hidden = vit_tower(num, p, "visual.", images, cfg, GELU[cfg["hidden_act"]])
    return l2_normalize(num.linear(hidden[:, 0], p["visual_projection.weight"]))


def clip_text_features(num: Numerics, p: Params, ids, mask, cfg: dict):
    """[B, T] ids and 1/0 mask -> [B, embed] L2-normalised features."""
    b, t = ids.shape
    heads, eps = cfg["text_heads"], cfg["text_layer_norm_eps"]
    x = p["text.token_embedding.weight"][ids.long()] + p["text.positional_embedding"][:t]
    valid = mask.bool()
    causal = torch.ones(t, t, dtype=torch.bool, device=ids.device).tril()
    key_ok = causal[None] & valid[:, None, :]
    for i in range(cfg["text_layers"]):
        blk = f"text.blocks.{i}."
        h = layer_norm(x, p, blk + "ln_1", eps)
        q, k, v = (num.linear(h, p[f"{blk}{n}.weight"], p[f"{blk}{n}.bias"]) for n in "qkv")
        a = attention(num, q, k, v, heads, key_ok)
        x = x + num.linear(a, p[blk + "out.weight"], p[blk + "out.bias"])
        h = layer_norm(x, p, blk + "ln_2", eps)
        h = F.gelu(num.linear(h, p[blk + "mlp_fc.weight"], p[blk + "mlp_fc.bias"]),
                   approximate=GELU[cfg["hidden_act"]])
        x = x + num.linear(h, p[blk + "mlp_proj.weight"], p[blk + "mlp_proj.bias"])
    x = layer_norm(x, p, "text.ln_final", eps)
    last = (valid.sum(dim=1) - 1).clamp(min=0)
    pooled = x[torch.arange(b, device=ids.device), last]
    return l2_normalize(num.linear(pooled, p["text_projection.weight"]))


def clip_scale(p: Params):
    return torch.exp(torch.clamp(p["logit_scale"], max=math.log(100.0)))


def contrastive_loss(img, txt, scale):
    """Symmetric InfoNCE of matching rows (the logits in float32, as the
    program computes them too)."""
    labels = torch.arange(img.shape[0], device=img.device)
    return 0.5 * (F.cross_entropy(scale * (img @ txt.t()), labels)
                  + F.cross_entropy(scale * (txt @ img.t()), labels))
