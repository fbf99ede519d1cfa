"""FLOPs and bytes of a step of the ViT-B/16 classifier
(``configs/vit_b16_cls.json``): the image tower and the classifier head."""

from benchmark.counts.transformer import Product, Step, vit_tower


def steps(cfg: dict, mode: str, shapes: dict) -> list:
    b = cfg["batch_size"]
    prods, attn = vit_tower(b, cfg)
    prods.append(Product(b, cfg["hidden_size"], len(cfg["data"]["colors"])))
    return [Step(prods, attn, mode == "train")]
