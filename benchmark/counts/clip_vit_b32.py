"""FLOPs and bytes of a step of CLIP ViT-B/32 (``configs/clip_vit_b32.json``).
Training: both towers, the projections and the two [B, B] similarity
products, one step a pool batch (the captions' lengths set the text
attention's valid pairs).  Zero-shot: the image tower, its projection and
the product against the class features."""

from benchmark.counts.transformer import Product, Step, text_tower, vit_tower


def steps(cfg: dict, mode: str, shapes: dict) -> list:
    b, e = cfg["batch_size"], cfg["embed_dim"]
    image, image_attn = vit_tower(b, cfg)
    image = image + [Product(b, cfg["hidden_size"], e)]
    if mode != "train":
        return [Step(image + [Product(b, e, len(cfg["data"]["colors"]))], image_attn, False)]
    out = []
    for lengths in shapes["caption_lengths"]:
        text, text_attn = text_tower(lengths, cfg)
        out.append(Step(image + text + [Product(b, e, b), Product(b, e, b)],
                        image_attn + text_attn, True))
    return out
