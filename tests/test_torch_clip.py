"""PyTorch port: the CLIP model, loss and train step vs the JAX package (CPU).

A tiny float32 CLIP (vit-t-8 at 32 px; text tower 64 wide, 2 layers, 4
heads, context 16) with seeded, perturbed JAX parameters carried into the
port by ``clip_state_dict_from_jax``.  The JAX model takes K2 in both towers
(``attention_layout="pallas_core"``, ``text_attention_core=True``, run in
interpret mode off the TPU), as the port does.  Tolerances: features 1e-5,
``contrastive_loss`` on the same features 1e-6, three train steps (AdamW
with clipping and weight decay, lr 1e-4) 1e-5 on losses and parameters
(key biases: 3 lr, see the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FEAT_TOL = 1e-5
LOSS_TOL = 1e-6
STEP_TOL = 1e-5
LR = 1e-4
CLASSES = ["r255g0b0", "r0g255b0", "r0g0b255", "r255g255b0"]
DIMS = dict(image_size=32, text_width=64, text_layers=2, text_heads=4, context_length=16,
            embed_dim=32)


@pytest.fixture(scope="module")
def pair():
    """(jax CLIPModel, numpy params, port CLIPModel on the CPU, tokenizer)."""
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    tok = ConceptTokenizer()
    jcfg = JConfig.create(vocab_size=len(tok), vision_preset="vit-t-8",
                          attention_layout="pallas_core", text_attention_core=True, **DIMS)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32))
    model = JModel(jcfg)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                 jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params["params"])
    port = CLIPModel(CLIPConfig.create(vocab_size=len(tok), vision_preset="vit-t-8",
                                       dtype=torch.float32, **DIMS))
    port.load_state_dict(clip_state_dict_from_jax(params, 8), strict=True)
    return model, params, port, tok


def _batch(tok, seed, b=4):
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator

    rng = np.random.default_rng(seed)
    collator = ClipCollator(tok, "a circle of color {class_name}", 16)
    images = [rng.random((3, 32, 32)).astype(np.float32) for _ in range(b)]
    names = [CLASSES[(seed + i) % len(CLASSES)] for i in range(b)]
    return collator(list(zip(images, names)))


def test_features_and_loss_match_jax(pair):
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel
    from multimodal_concept_learning_tpu.models.clip import contrastive_loss as jloss
    from multimodal_concept_learning_tpu_torch.models.clip import contrastive_loss

    model, params, port, tok = pair
    batch = _batch(tok, 0)
    args = [jnp.asarray(batch[k]) for k in ("images", "input_ids", "attention_mask")]
    jimg, jtxt, jscale = model.apply({"params": params}, *args)
    jtxt_only = model.apply({"params": params}, *args[1:], method=JModel.encode_text)
    with torch.no_grad():
        img, txt, scale = port(*(torch.from_numpy(batch[k])
                                 for k in ("images", "input_ids", "attention_mask")))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jtxt), atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(txt.numpy(), np.asarray(jtxt_only), atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(scale.item(), float(jscale), rtol=1e-6)
    # the loss alone, on the same features
    got = contrastive_loss(torch.tensor(np.asarray(jimg)), torch.tensor(np.asarray(jtxt)),
                           torch.tensor(float(jscale)))
    np.testing.assert_allclose(got.item(), float(jloss(jimg, jtxt, jscale)), atol=LOSS_TOL, rtol=0)


def test_variant_fused_vision_and_k2bd_match_jax(pair, monkeypatch):
    """The variant path: the vision tower on K6 (``fused_attention=True``)
    and both towers' attention cores on K2-bd (``MCL_ATTN_CORE_BD=1``), in
    the JAX model (its fused branch forced off the TPU, kernels in interpret
    mode) and the port (plain versions), same weights: features 1e-5, the
    loss's gradient of every parameter 1e-4 relative in norm (key biases
    aside: softmax cancels their gradient, so both sides hold rounding)."""
    from jax.experimental.pallas import tpu as pltpu

    from multimodal_concept_learning_tpu.models import vit as jvit
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel
    from multimodal_concept_learning_tpu.models.clip import contrastive_loss as jloss
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel, contrastive_loss

    monkeypatch.setenv("MCL_ATTN_CORE_BD", "1")
    monkeypatch.setattr(jvit, "_fused_attention_ok", lambda cfg, det: cfg.fused_attention and det)
    model, params, port0, tok = pair
    jcfg = dataclasses.replace(model.config, vision=dataclasses.replace(model.config.vision,
                                                                        fused_attention=True))
    cfg = dataclasses.replace(port0.cfg, vision=dataclasses.replace(port0.cfg.vision,
                                                                    fused_attention=True))
    jmodel, port = JModel(jcfg), CLIPModel(cfg)
    port.load_state_dict(port0.state_dict(), strict=True)
    batch = _batch(tok, 3)
    args = [jnp.asarray(batch[k]) for k in ("images", "input_ids", "attention_mask")]

    def loss(p):
        img, txt, scale = jmodel.apply({"params": p}, *args)
        return jloss(img, txt, scale), (img, txt)

    with pltpu.force_tpu_interpret_mode():
        (_, (jimg, jtxt)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    img, txt, scale = port(*(torch.from_numpy(batch[k])
                             for k in ("images", "input_ids", "attention_mask")))
    contrastive_loss(img, txt, scale).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), atol=FEAT_TOL, rtol=0)
    np.testing.assert_allclose(txt.detach().numpy(), np.asarray(jtxt), atol=FEAT_TOL, rtol=0)
    want = clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), 8)
    for name, p in port.named_parameters():
        if name.endswith(("key.bias", ".k.bias")):
            continue
        err = ((p.grad - want[name]).norm() / want[name].norm()).item()
        assert err <= 1e-4, (name, err)


def test_logit_scale_is_clipped_at_log_100(pair):
    model, params, port, tok = pair
    batch = {k: torch.from_numpy(v) for k, v in _batch(tok, 1).items()}
    with torch.no_grad():
        saved = port.logit_scale.clone()
        port.logit_scale.fill_(7.0)
        _, _, scale = port(batch["images"], batch["input_ids"], batch["attention_mask"])
        port.logit_scale.copy_(saved)
    np.testing.assert_allclose(scale.item(), 100.0, rtol=1e-6)


def test_three_train_steps_match_jax(pair):
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.train.contrastive_training import make_clip_train_step as jstep_fn
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )

    model, params, port0, tok = pair
    hp = dict(weight_decay=0.2, max_grad_norm=1.0)
    tx = jbuild(LR, **hp)
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jstep_fn(model, tx)
    port = CLIPModel(port0.cfg)
    port.load_state_dict(port0.state_dict(), strict=True)
    state = TrainState(model=port, optimizer=build_optimizer(port, LR, **hp))
    step = make_clip_train_step(port)
    for i in range(3):
        batch = _batch(tok, 10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=STEP_TOL, rtol=0)
    ref = clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), 8)
    before = port0.state_dict()
    assert state.optimizer.count == 3
    for name, p in port.state_dict().items():
        # a key bias shifts every score of a row alike, so softmax cancels
        # its gradient exactly: both sides update it by Adam-normalised
        # rounding noise, at most lr per step
        tol = 3 * LR if name.endswith(("key.bias", ".k.bias")) else STEP_TOL
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=tol, rtol=0, err_msg=name)
        assert not torch.equal(p, before[name]), name  # every parameter trains


def test_random_init_uses_the_jax_initialisers():
    """Seeded init: normal(0.02) kernels and embeddings, normal(0.01) text
    positions, zero biases, unit LayerNorm scales, logit_scale log(1/0.07)."""
    import math

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel

    cfg = CLIPConfig.create(vocab_size=300, vision_preset="vit-t-8", dtype=torch.float32, **DIMS)
    model = init_random_weights_(CLIPModel(cfg), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert sd["logit_scale"].item() == pytest.approx(math.log(1 / 0.07))
    assert abs(sd["text.positional_embedding"].std().item() - 0.01) < 2e-3
    for name in ("text.token_embedding.weight", "text.blocks.0.mlp_fc.weight",
                 "visual.encoder.layer.1.attention.attention.query.weight",
                 "visual_projection.weight", "visual.embeddings.cls_token"):
        assert abs(sd[name].std().item() - 0.02) < 5e-3, name
    assert not sd["text.blocks.1.q.bias"].any() and (sd["text.ln_final.weight"] == 1).all()
