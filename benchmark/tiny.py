"""A configuration cut to a size the CPU holds in seconds, for the tests
and for rehearsing the harness without the card: every width and depth
small, images of 32 pixels, batches of 8 (CLIP) or 4 (the classifier,
still 2 micro-steps an update).  Never a cell's configuration."""

from benchmark import harness


def tiny_config(name: str) -> dict:
    cfg = harness.config(name)
    cfg["data"] = dict(cfg["data"], image_size=32, radius_range=[2, 8])
    cfg.update(image_size=32, patch_size=8, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4)
    if cfg["family"] == "clip":
        cfg.update(vision_model_name="vit-t-8", text_width=64, text_layers=2, text_heads=4,
                   context_length=16, embed_dim=32, batch_size=8, effective_batch_size=8)
    else:
        cfg.update(batch_size=4, effective_batch_size=8)
    return cfg


# Limits at these sizes on the CPU, for the tests only: between the
# program's (bf16) readings and the control's (float8 products) over seeds
# 11-15 of ``calibrate.py --tiny`` (the cells' own limits are set at their
# own sizes on the card; ``PERF.md``).
TINY_LIMITS = {
    "clip_b32_train": {"loss": 5e-3, "grad": 0.3, "change": 3e-2,
                       "image_features": 2.5e-2, "text_features": 2.5e-2},
    "vit_b16_train": {"loss": 7e-4, "grad": 6e-3, "change": 2e-2},
    "vit_b16_eval": {"logits": 2e-2, "loss": 8e-4},
    "clip_b32_zeroshot": {"image_features": 2.5e-2, "class_features": 2.5e-2},
}
