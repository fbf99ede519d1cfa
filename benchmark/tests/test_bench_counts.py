"""The FLOP and byte counts against hand counts."""

import pytest

from benchmark import harness
from benchmark.counts import clip_vit_b32, vit_b16_cls
from benchmark.counts.transformer import Attention, Product, Step, causal_masked, full, vit_tower


def test_product_counts_forward_and_backward():
    p = Product(2, 3, 4)
    assert p.flops(False) == 48
    assert p.flops(True) == 3 * 48  # forward, the weight's and the input's gradients
    assert Product(2, 3, 4, input_grad=False).flops(True) == 2 * 48


def test_causal_masked_pairs_and_bytes():
    a = causal_masked([1, 3], rows=4, heads=2, head_dim=8)
    # length 1: every query sees key 0 (4 pairs); length 3: 1 + 2 + 3 + 3
    assert a.pairs == (4, 9)
    assert a.flops(False) == 4 * 8 * 2 * 13
    assert a.flops(True) == 8 * 8 * 2 * 13
    width = 2 * 8 * 2  # heads x head dim x bf16
    assert a.bytes(False) == width * (2 * 4 * 2 + 2 * (1 + 3))
    assert a.bytes(True) == width * (3 * 4 * 2 + 4 * (1 + 3))


def test_full_attention_bound_takes_the_larger_side():
    a = full(batch=1, rows=2, heads=1, head_dim=4)
    assert a.pairs == (4,)
    flops_s = a.flops(False) / 1e3
    bytes_s = a.bytes(False) / 1e6
    assert a.bound_s(False, 1e3, 1e6) == pytest.approx(max(flops_s, bytes_s))
    assert a.bound_s(True, 1e3, 1e6) == pytest.approx(
        max(flops_s, bytes_s) + max(a.flops(True) / 1e3, a.bytes(True) / 1e6))


def test_vit_tower_by_hand():
    cfg = dict(hidden_size=8, intermediate_size=16, patch_size=2, image_size=4,
               num_channels=3, num_hidden_layers=1, num_attention_heads=2)
    prods, attn = vit_tower(3, cfg)
    # 4 patches of 3*2*2 values, 5 tokens a sample
    assert prods[0] == Product(12, 12, 8, input_grad=False)
    assert prods[1:] == [Product(15, 8, 24), Product(15, 8, 8), Product(15, 8, 16),
                         Product(15, 16, 8)]
    assert attn == [Attention(2, 4, 5, (5, 5, 5), (25, 25, 25))]
    step = Step(prods, attn, train=False)
    fwd = 2 * (12 * 12 * 8 + 15 * 8 * 24 + 15 * 8 * 8 + 15 * 8 * 16 + 15 * 16 * 8)
    assert step.product_flops() == fwd
    assert step.model_flops() == fwd + 4 * 4 * 2 * 75
    assert Step(prods, attn, train=True).model_flops() == 3 * step.model_flops()


def test_full_size_forward_flops():
    """ViT-B/16 at batch 64 is about 2.25 TFLOP forward, CLIP ViT-B/32's
    image tower at batch 256 about 2.26."""
    vit = harness.config("vit_b16_cls")
    (step,) = vit_b16_cls.steps(vit, "eval", {})
    assert step.model_flops() == pytest.approx(2.25e12, rel=0.01)
    clip = harness.config("clip_vit_b32")
    (zs,) = clip_vit_b32.steps(clip, "eval", {})
    assert zs.model_flops() == pytest.approx(2.26e12, rel=0.01)
    (tr,) = clip_vit_b32.steps(clip, "train", {"caption_lengths": [[16] * 256]})
    assert tr.model_flops() / 3 - zs.model_flops() == pytest.approx(1.49e12, rel=0.02)
