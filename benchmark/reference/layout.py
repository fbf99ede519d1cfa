"""Names and shapes of the parameters of the benchmark's models, in the
published layouts (HF ``ViTModel`` / ``ViTForImageClassification``; the
CLIP dual encoder's own names), from a configuration's sizes.  The seeded
weights are drawn in this order, and the program must load them as they
are (``load_state_dict(strict=True)``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

Spec = Dict[str, Tuple[int, ...]]


def vit_tower(prefix: str, cfg: dict) -> Spec:
    h, i, ps = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    tokens = (cfg["image_size"] // ps) ** 2 + 1
    spec = OrderedDict()
    pre = prefix + "embeddings."
    spec[pre + "cls_token"] = (1, 1, h)
    spec[pre + "position_embeddings"] = (1, tokens, h)
    spec[pre + "patch_embeddings.projection.weight"] = (h, cfg["num_channels"], ps, ps)
    spec[pre + "patch_embeddings.projection.bias"] = (h,)
    for n in range(cfg["num_hidden_layers"]):
        blk = f"{prefix}encoder.layer.{n}."
        for name in ("query", "key", "value"):
            spec[f"{blk}attention.attention.{name}.weight"] = (h, h)
            spec[f"{blk}attention.attention.{name}.bias"] = (h,)
        spec[blk + "attention.output.dense.weight"] = (h, h)
        spec[blk + "attention.output.dense.bias"] = (h,)
        spec[blk + "intermediate.dense.weight"] = (i, h)
        spec[blk + "intermediate.dense.bias"] = (i,)
        spec[blk + "output.dense.weight"] = (h, i)
        spec[blk + "output.dense.bias"] = (h,)
        for ln in ("layernorm_before", "layernorm_after"):
            spec[f"{blk}{ln}.weight"] = (h,)
            spec[f"{blk}{ln}.bias"] = (h,)
    spec[prefix + "layernorm.weight"] = (h,)
    spec[prefix + "layernorm.bias"] = (h,)
    return spec


def vit_classifier(cfg: dict) -> Spec:
    spec = vit_tower("vit.", cfg)
    spec["classifier.weight"] = (cfg["num_labels"], cfg["hidden_size"])
    spec["classifier.bias"] = (cfg["num_labels"],)
    return spec


def clip(cfg: dict) -> Spec:
    w, e = cfg["text_width"], cfg["embed_dim"]
    spec = OrderedDict(logit_scale=())
    spec.update(vit_tower("visual.", cfg))
    spec["visual_projection.weight"] = (e, cfg["hidden_size"])
    spec["text.token_embedding.weight"] = (cfg["vocab_size"], w)
    spec["text.positional_embedding"] = (cfg["context_length"], w)
    for n in range(cfg["text_layers"]):
        blk = f"text.blocks.{n}."
        for name, shape in (("ln_1", (w,)), ("q", (w, w)), ("k", (w, w)), ("v", (w, w)),
                            ("out", (w, w)), ("ln_2", (w,)), ("mlp_fc", (4 * w, w)),
                            ("mlp_proj", (w, 4 * w))):
            spec[f"{blk}{name}.weight"] = shape
            spec[f"{blk}{name}.bias"] = (shape[0],)
    spec["text.ln_final.weight"] = (w,)
    spec["text.ln_final.bias"] = (w,)
    spec["text_projection.weight"] = (e, w)
    return spec


def init(name: str) -> Tuple[float, float]:
    """(mean, std) of a parameter's seeded draw: norm scales about 1,
    CLIP's temperature at log(1 / 0.07), its text positions at std 0.01,
    everything else (weights, biases, embeddings, norm shifts) at 0.02."""
    if name == "logit_scale":
        return math.log(1.0 / 0.07), 0.0
    if name == "text.positional_embedding":
        return 0.0, 0.01
    last = name.rsplit(".", 2)
    if name.endswith(".weight") and ("norm" in last[-2] or last[-2].startswith("ln_")):
        return 1.0, 0.02
    return 0.0, 0.02
