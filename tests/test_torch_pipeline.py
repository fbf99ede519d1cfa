"""PyTorch port: GPipe pipeline parallelism (four Gloo ranks on the CPU)
vs the JAX package: the counterparts of ``test_pipeline.py``.

The pipelined layer stack (2 stages x 4 microbatches on a (2 data x 2
pipe) mesh, 4 x 2 on a 4-rank pipe) equals JAX's scanned stack forward
(rtol/atol 1e-5) and in its gradients (rtol 2e-5, atol 2e-6), through
ragged padding and the Gemma-3 sliding/global pattern (each stage's
blocks keep their global layer index); the MLLM loss with the LM stack
pipelined equals JAX's plain loss (rtol 1e-6) with the gradients of the
vision tower, projector, embedding and the piped blocks.  JAX's weights
come from its scanned tree, unstacked by the port's converter.  The ranks
(``tests/_torch_mesh_worker.py``, suite ``pipeline``) start once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
import _torch_parity as tp


def _lm_cfg(num_layers=4):
    from multimodal_concept_learning_tpu.models.lm import LMConfig

    return dataclasses.replace(
        LMConfig.preset("nano", vocab_size=128), num_layers=num_layers, dtype=jnp.float32,
        scan_layers=True, use_qk_norm=True, sandwich_norms=True, sliding_window=6,
        sliding_window_pattern=2, query_pre_attn_scalar=32.0)


def _port_lm_cfg(cfg):
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig

    return LMConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(LMConfig)
                       if f.name != "dtype"}, dtype=torch.float32)


def _inputs(model, b=8, t=12, seed=0):
    from multimodal_concept_learning_tpu.models.lm import CausalLM

    rng = np.random.default_rng(seed)
    ids = jnp.asarray(rng.integers(0, 128, size=(b, t)).astype(np.int32))
    mask = np.ones((b, t), np.int32)
    mask[1, -3:] = 0
    mask[3, -1:] = 0
    params = jax.jit(model.init)(jax.random.key(0), ids)["params"]
    embeds = model.apply({"params": params}, ids, method=CausalLM.embed)
    return params, np.asarray(embeds), mask


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from multimodal_concept_learning_tpu.models.lm import CausalLM
    from multimodal_concept_learning_tpu.models.mllm import MLLM, MLLMConfig
    from multimodal_concept_learning_tpu.models.vit import ViTConfig
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        lm_state_dict_from_jax,
        state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig as PortMLLMConfig

    workdir = tmp_path_factory.mktemp("pipeline")
    procs = tm.start("pipeline", 4, workdir)

    model = CausalLM(_lm_cfg())
    params, embeds, mask = _inputs(model)
    gparams, gembeds, gmask = _inputs(model, seed=1)

    vision = ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                       num_attention_heads=2, patch_size=8, image_size=16,
                       num_labels=0, dtype=jnp.float32)
    mcfg = MLLMConfig(vision=vision, lm=_lm_cfg(), num_vision_tokens=5, max_answer_tokens=2,
                      dtype=jnp.float32)
    mllm = MLLM(mcfg)
    rng = np.random.default_rng(7)
    b, text_len = 4, 8
    t = mcfg.num_vision_tokens + text_len
    images = rng.normal(size=(b, 3, 16, 16)).astype(np.float32)
    ids = np.zeros((b, t), np.int32)
    ids[:, mcfg.num_vision_tokens:] = rng.integers(4, 128, size=(b, text_len))
    labels = np.full((b, t), -100, np.int32)
    labels[:, -2] = ids[:, -2]
    batch = {"images": images, "input_ids": ids, "attention_mask": np.ones((b, t), np.int32),
             "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mparams = jax.jit(mllm.init)(jax.random.key(0), jb["images"], jb["input_ids"],
                                 jb["attention_mask"], jb["labels"])["params"]
    pm = tp.port_config(mcfg)

    tm.write_inputs(workdir, {
        "lm": dict(cfg=_port_lm_cfg(model.config), sd=lm_state_dict_from_jax(_np_tree(params)),
                   embeds=embeds, mask=mask),
        "lm_grad": dict(cfg=_port_lm_cfg(model.config),
                        sd=lm_state_dict_from_jax(_np_tree(gparams)), embeds=gembeds,
                        mask=gmask),
        "mllm": dict(cfg=PortMLLMConfig(vision=pm.vision, lm=pm.lm, num_vision_tokens=5,
                                        max_answer_tokens=2, dtype=torch.float32),
                     sd=state_dict_from_jax(_np_tree(mparams), 8), batch=batch),
    })

    ref = {}
    ref["forward"] = np.asarray(jax.jit(lambda p, e, m: model.apply(
        {"params": p}, e, m, method=CausalLM.hidden_states))(params, embeds, mask))

    def loss_plain(p):
        h = model.apply({"params": p}, gembeds, gmask, method=CausalLM.hidden_states)
        return (h.astype(jnp.float32) ** 2).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_plain))(gparams)
    ref["grad_loss"] = float(loss)
    ref["grads"] = {k: v.numpy() for k, v in lm_state_dict_from_jax(_np_tree(grads)).items()}

    def mllm_loss(p):
        return mllm.apply({"params": p}, jb["images"], jb["input_ids"], jb["attention_mask"],
                          jb["labels"])["loss"]

    loss, grads = jax.jit(jax.value_and_grad(mllm_loss))(mparams)
    ref["mllm_loss"] = float(loss)
    ref["mllm_grads"] = {k: v.numpy() for k, v in
                         state_dict_from_jax(_np_tree(grads), 8).items()}
    return tm.collect(procs, workdir), ref


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 2)])
def test_pipeline_forward_matches_scan(run, stages, micro):
    ranks, ref = run
    for r in ranks:
        assert r[f"local_layers_{stages}"] == 4 // stages  # the blocks split over the stages
        np.testing.assert_allclose(r[f"forward_{stages}_{micro}"], ref["forward"],
                                   rtol=1e-5, atol=1e-5)


def test_pipeline_gradients_match_scan(run):
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["grad_loss"], ref["grad_loss"], rtol=1e-6)
        for name, g in r["grads"].items():  # this stage's blocks and the replicated norm
            np.testing.assert_allclose(g, ref["grads"][name], rtol=2e-5, atol=2e-6,
                                       err_msg=name)
    # every block's gradient came from some stage
    seen = {n for r in ranks for n in r["grads"]}
    assert seen == set(ref["grads"]) - {"model.embed_tokens.weight"}


def test_pipeline_sends_activations_and_gradients(run):
    ranks, _ = run
    counts = [r["grad_counts"] for r in ranks]
    # (data 2 x pipe 2): stage 0 sends 4 activations, stage 1 sends 4 gradients back
    assert [c.get("send", 0) for c in counts] == [4, 4, 4, 4]
    assert [c.get("recv", 0) for c in counts] == [4, 4, 4, 4]


def test_pipelined_mllm_loss_and_grads_match(run):
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["mllm_loss"], ref["mllm_loss"], rtol=1e-6)
        for name, g in r["mllm_grads"].items():
            np.testing.assert_allclose(g, ref["mllm_grads"][name], rtol=2e-5, atol=2e-6,
                                       err_msg=name)
    seen = {n for r in ranks for n in r["mllm_grads"]}
    assert seen == set(ref["mllm_grads"])
