"""The plain reference against the port at tiny widths on the CPU, both in
float32: the same seeded weights, the same batches and dropout seed."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.inputs import caption_batch, make_weights, streams
from benchmark.reference import layout, models
from benchmark.reference.adamw import AdamW, cosine_per_epoch, linear_warmup
from benchmark.reference.numerics import Numerics, fp8_round
from benchmark.tiny import tiny_config

F32 = Numerics("float32")


def _vit_port(cfg, dropout):
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )

    vc = ViTConfig(hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
                   num_hidden_layers=cfg["num_hidden_layers"],
                   num_attention_heads=cfg["num_attention_heads"],
                   patch_size=cfg["patch_size"], image_size=cfg["image_size"],
                   hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout,
                   num_labels=12, dtype=torch.float32)
    return ViTForImageClassification(vc)


def _images(cfg, seed, n):
    from benchmark.inputs import image_pool

    (images, classes), = image_pool(cfg["data"], 1, n, seed, "cpu")
    return images, classes


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_classifier_logits_and_gradients_match_the_port(dropout):
    cfg = tiny_config("vit_b16_cls")
    m = dict(cfg, num_labels=12, hidden_dropout_prob=dropout, attention_dropout_prob=dropout)
    seeds = streams(5)
    weights = make_weights(layout.vit_classifier(m), layout.init, seeds["weights"], "cpu")
    port = _vit_port(cfg, dropout)
    port.load_state_dict(weights, strict=True)
    images, classes = _images(cfg, seeds["images"], 4)
    labels = torch.as_tensor(classes)
    gen = torch.Generator().manual_seed(seeds["dropout"])
    got = port(images, deterministic=dropout == 0.0, generator=gen)
    drop = models.Dropout(dropout, dropout, torch.Generator().manual_seed(seeds["dropout"]),
                          keep_dtype=torch.float32)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    want = models.classifier_logits(F32, params, images, m, drop if dropout else None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.nn.functional.cross_entropy(got, labels).backward()
    models.cross_entropy(want, labels).backward()
    for name, p in port.named_parameters():
        torch.testing.assert_close(p.grad, params[name].grad, rtol=1e-4, atol=1e-6)


def test_clip_features_and_loss_match_the_port():
    from multimodal_concept_learning_tpu_torch.models.clip import (
        CLIPConfig,
        CLIPModel,
        contrastive_loss,
    )

    cfg = tiny_config("clip_vit_b32")
    seeds = streams(6)
    weights = make_weights(layout.clip(cfg), layout.init, seeds["weights"], "cpu")
    port = CLIPModel(CLIPConfig.create(
        vocab_size=cfg["vocab_size"], vision_preset=cfg["vision_model_name"],
        image_size=cfg["image_size"], text_width=cfg["text_width"],
        text_layers=cfg["text_layers"], text_heads=cfg["text_heads"],
        context_length=cfg["context_length"], embed_dim=cfg["embed_dim"], dtype=torch.float32))
    port.load_state_dict(weights, strict=True)
    images, classes = _images(cfg, seeds["images"], 8)
    ids, mask = (torch.as_tensor(x) for x in caption_batch(cfg["data"], classes,
                                                           cfg["context_length"]))
    img, txt, scale = port(images, ids, mask)
    want_img = models.clip_image_features(F32, weights, images, cfg)
    want_txt = models.clip_text_features(F32, weights, ids, mask, cfg)
    torch.testing.assert_close(img, want_img, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(txt, want_txt, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(contrastive_loss(img, txt, scale),
                               models.contrastive_loss(want_img, want_txt,
                                                       models.clip_scale(weights)))


@pytest.mark.parametrize("k", [1, 2])
def test_adamw_matches_the_port_optimizer(k):
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
        build_optimizer,
        cosine_epoch_schedule,
        linear_warmup_schedule,
    )

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    if k == 1:
        port_lr, ref_lr = linear_warmup_schedule(1e-2, 2, 10), linear_warmup(1e-2, 2, 10)
    else:
        port_lr, ref_lr = cosine_epoch_schedule(1e-2, 3, 1), cosine_per_epoch(1e-2, 3, 1)
    port = build_optimizer(model, port_lr, weight_decay=0.1, max_grad_norm=0.5,
                           accumulation_steps=k)
    ref = AdamW(params, ref_lr, 0.1, 0.5, k)
    for i in range(4 * k):
        grads = {n: torch.randn_like(p) * (3.0 if i % 2 else 0.01) for n, p in params.items()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        port.step()
        ref.step(grads)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[n], rtol=1e-5, atol=1e-6)  # float32 rounding


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096)
    err8 = (fp8_round(x) - x).abs().max() / x.abs().max()
    err16 = (x.to(torch.bfloat16).float() - x).abs().max() / x.abs().max()
    assert err16 < err8 < 0.07
    assert torch.equal(fp8_round(torch.zeros(3)), torch.zeros(3))


def test_seeded_inputs_repeat_and_differ():
    a, b = streams(2 ** 31 + 5), streams(2 ** 31 + 5)
    assert a == b and a != streams(2 ** 31 + 6)
    cfg = tiny_config("vit_b16_cls")
    x1, c1 = _images(cfg, a["images"], 4)
    x2, c2 = _images(cfg, a["images"], 4)
    assert torch.equal(x1, x2) and np.array_equal(c1, c2)
    assert x1.min() >= 0 and x1.max() <= 1 and x1.shape == (4, 3, 32, 32)
    assert len({tuple(r.flatten().tolist()) for r in x1}) == 4  # rows differ
