"""PyTorch port: CLIP with ``bf16_params`` (bf16 parameter storage, float32
masters in AdamW) against the JAX package (CPU).

A tiny CLIP (vit-t-8 at 32 px; text 64 wide, 2 layers, 4 heads, context
16), float32 compute, seeded perturbed JAX parameters cast to bf16 by
``cast_params_bf16`` and carried across by ``clip_state_dict_from_jax``
(exact: the values are bf16).  The similarity scale: an eager JAX
``apply`` returns ``exp(clip(logit_scale))`` rounded to bf16, but JAX's
jitted train step, where the scale feeds a float32 product, keeps ``exp``'s
result in float32 (XLA's excess precision) and rounds only the clip bound
to bf16; the port's scale equals the jitted one to a float32 ulp (the
two libraries' ``exp`` may round apart by one), at the bound too (98.86,
not 100).  Three AdamW steps
(clipping 1.0, weight decay 0.2, lr 1e-4): losses 1e-5 abs and the float32
masters 1e-5 abs against JAX's, as ``tests/test_torch_clip.py`` holds the
float32 run (key biases, whose gradient softmax cancels exactly: 3 lr);
the bf16 parameters within one bf16 ulp (rtol 2^-7; a master a rounding
apart may round to the neighbouring bf16 value).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

LR = 1e-4
STEP_TOL = 1e-5
CLASSES = ["r255g0b0", "r0g255b0", "r0g0b255", "r255g255b0"]
DIMS = dict(image_size=32, text_width=64, text_layers=2, text_heads=4, context_length=16,
            embed_dim=32)


def _batch(tok, seed, b=4):
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator

    rng = np.random.default_rng(seed)
    collator = ClipCollator(tok, "a circle of color {class_name}", 16)
    images = [rng.random((3, 32, 32)).astype(np.float32) for _ in range(b)]
    return collator([(im, CLASSES[(seed + i) % len(CLASSES)]) for i, im in enumerate(images)])


def _jax_masters(opt_state, patch: int):
    from multimodal_concept_learning_tpu.parallel.optimizer import MasterState
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, MasterState)) if isinstance(s, MasterState)]
    assert len(found) == 1
    return clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, found[0].master), patch)


def test_bf16_params_three_steps_match_jax():
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.parallel.train_step import cast_params_bf16
    from multimodal_concept_learning_tpu.train.contrastive_training import (
        make_clip_train_step as jstep_fn,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    tok = ConceptTokenizer()
    jcfg = JConfig.create(vocab_size=len(tok), vision_preset="vit-t-8", **DIMS)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32))
    model = JModel(jcfg)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                 jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32)
                              + 0.05 * rng.standard_normal(x.shape).astype(np.float32)),
        params["params"])
    hp = dict(weight_decay=0.2, max_grad_norm=1.0, fp32_master=True)
    tx = jbuild(LR, **hp)
    params = cast_params_bf16(params)
    assert params["logit_scale"].dtype == jnp.bfloat16
    jstate = JState.create(params, tx)
    jstep = jstep_fn(model, tx)

    port = CLIPModel(CLIPConfig.create(vocab_size=len(tok), vision_preset="vit-t-8",
                                       dtype=torch.float32, **DIMS))
    port.load_state_dict(clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), 8),
                         strict=True)
    for p in port.parameters():
        p.data = p.data.to(torch.bfloat16)

    # the similarity scale: eager JAX rounds it to bf16, the jitted step does not
    first = _batch(tok, 9)
    args = [jnp.asarray(first[k]) for k in ("images", "input_ids", "attention_mask")]
    jit_scale = jax.jit(lambda p: model.apply({"params": p}, *args)[2].astype(jnp.float32))
    eager = model.apply({"params": params}, *args)[2]
    exact = math.exp(float(params["logit_scale"]))
    for value in (None, 7.0):  # as initialised, then past the clip bound
        p = params if value is None else dict(params, logit_scale=jnp.bfloat16(value))
        with torch.no_grad():
            if value is not None:
                port.logit_scale.fill_(value)
            _, _, scale = port(*(torch.from_numpy(first[k])
                                 for k in ("images", "input_ids", "attention_mask")))
        assert scale.dtype == torch.float32
        np.testing.assert_allclose(scale.item(), float(jit_scale(p)), rtol=2e-7, atol=0)
    np.testing.assert_allclose(float(jit_scale(params)), exact, rtol=2e-7)
    assert float(eager) == 14.4375 != np.float32(exact)
    assert abs(scale.item() - 98.8645) < 1e-3  # exp(4.59375): the bf16 bound
    with torch.no_grad():
        port.logit_scale.fill_(float(params["logit_scale"]))

    state = TrainState(model=port, optimizer=build_optimizer(port, LR, **hp))
    step = make_clip_train_step(port)
    for i in range(3):
        batch = _batch(tok, 10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=STEP_TOL, rtol=0)
    assert state.optimizer.count == 3
    ref = clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), 8)
    masters = _jax_masters(jstate.opt_state, 8)
    for name, p in port.named_parameters():
        assert p.dtype == torch.bfloat16, name
        tol = 3 * LR if name.endswith(("key.bias", ".k.bias")) else STEP_TOL
        # a master a rounding apart may round to the neighbouring bf16 value
        np.testing.assert_allclose(p.detach().float().numpy(), ref[name].numpy(), atol=tol,
                                   rtol=2 ** -7, err_msg=name)
        np.testing.assert_allclose(state.optimizer.master[name].numpy(), masters[name].numpy(),
                                   atol=tol, rtol=0, err_msg=name)
