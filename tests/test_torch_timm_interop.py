"""PyTorch port: timm-tower checkpoints (``checkpoint.py``'s timm
converters, ``mllm_state_dict_from_torch``,
``vit_classifier_state_dict_from_torch``) against the JAX package.

Counterparts of ``tests/test_timm_interop.py``: the converters equal JAX's
bitwise (and raise its error for a block missing a projection); a raw timm
classifier dict gives the logits of its HF-named twin; a reference results
dir whose ``.pt`` JAX wrote with ``vision_naming="timm"``, plus the keys the
reference writes with no slot in the MLLM (HF ViTModel's pooler,
Gemma3ForCausalLM's tied ``lm_head``), loads through the port's serving
loader with JAX's loader's greedy tokens exactly and its float32 logits
within 1e-4.  Any other unknown key, and any missing key, still raises.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

LOGIT_TOL = 1e-4
N_NEW = 4
TRAINING_CONFIG = {
    "prompt_template": "Is the color of the circle {class_name}?",
    "dataset_name": "color_multimodal", "vision_model_name": "vit-t-8",
    "language_model_name": "nano", "num_vision_tokens": 17, "image_size": 32,
    "trainable_params_setting": "language_embed_only", "seed": 0,
    "train_transforms": ["ToTensor"], "val_transforms": ["ToTensor"], "use_wandb": False,
}


def _hf_vit_dict(seed: int = 0, layers: int = 2, h: int = 8) -> dict:
    """A tiny HF-named ViT dict of numpy arrays (with a ``head.*``)."""
    rng = np.random.default_rng(seed)
    shapes = {"embeddings.cls_token": (1, 1, h), "embeddings.position_embeddings": (1, 5, h),
              "embeddings.patch_embeddings.projection.weight": (h, 3, 8, 8),
              "embeddings.patch_embeddings.projection.bias": (h,),
              "layernorm.weight": (h,), "layernorm.bias": (h,),
              "head.weight": (3, h), "head.bias": (3,)}
    for i in range(layers):
        base = f"encoder.layer.{i}"
        for nm in ("query", "key", "value"):
            shapes[f"{base}.attention.attention.{nm}.weight"] = (h, h)
            shapes[f"{base}.attention.attention.{nm}.bias"] = (h,)
        for sub, shape in (("layernorm_before", (h,)), ("layernorm_after", (h,)),
                           ("attention.output.dense", (h, h)),
                           ("intermediate.dense", (2 * h, h)), ("output.dense", (h, 2 * h))):
            shapes[f"{base}.{sub}.weight"] = shape
            shapes[f"{base}.{sub}.bias"] = shape[:1]
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
        assert np.asarray(got[k]).dtype == v.dtype


def test_qkv_split_matches_jax_and_timm_math():
    """JAX's case: the fused rows split in timm's q, k, v order; the port's
    split equals JAX's bitwise, from numpy and from tensors."""
    from multimodal_concept_learning_tpu.checkpoint import timm_vit_sd_to_hf as jax_split

    from multimodal_concept_learning_tpu_torch.checkpoint import timm_vit_sd_to_hf

    rng = np.random.default_rng(0)
    h = 8
    w = rng.normal(size=(3 * h, h)).astype(np.float32)
    b = rng.normal(size=(3 * h,)).astype(np.float32)
    x = rng.normal(size=(5, h)).astype(np.float32)
    q_t, k_t, v_t = np.split(x @ w.T + b, 3, axis=-1)
    fused = {"blocks.0.attn.qkv.weight": w, "blocks.0.attn.qkv.bias": b}
    hf = timm_vit_sd_to_hf(fused)
    _assert_same(hf, jax_split(fused))
    from_tensors = timm_vit_sd_to_hf({k: torch.from_numpy(v) for k, v in fused.items()})
    _assert_same({k: v.numpy() for k, v in from_tensors.items()}, hf)
    for nm, want in (("query", q_t), ("key", k_t), ("value", v_t)):
        wq = hf[f"encoder.layer.0.attention.attention.{nm}.weight"]
        bq = hf[f"encoder.layer.0.attention.attention.{nm}.bias"]
        np.testing.assert_allclose(x @ wq.T + bq, want, rtol=1e-6)


def test_converters_match_jax_bitwise():
    """Both directions equal JAX's on one numpy dict (and on tensors), the
    round trip is bitwise, and a block missing a projection raises JAX's
    ValueError."""
    from multimodal_concept_learning_tpu.checkpoint import hf_vit_sd_to_timm as jax_to_timm
    from multimodal_concept_learning_tpu.checkpoint import timm_vit_sd_to_hf as jax_to_hf

    from multimodal_concept_learning_tpu_torch.checkpoint import (
        hf_vit_sd_to_timm,
        timm_vit_sd_to_hf,
    )

    hf = _hf_vit_dict()
    timm = hf_vit_sd_to_timm(hf)
    _assert_same(timm, jax_to_timm(hf))
    assert "blocks.1.attn.qkv.weight" in timm and timm["blocks.1.attn.qkv.weight"].shape == (24, 8)
    assert "head.weight" in timm and "cls_token" in timm and "pos_embed" in timm
    back = timm_vit_sd_to_hf(timm)
    _assert_same(back, jax_to_hf(timm))
    assert sorted(back) == sorted(hf)
    for k, v in hf.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    as_tensors = hf_vit_sd_to_timm({k: torch.from_numpy(v) for k, v in hf.items()})
    _assert_same({k: v.numpy() for k, v in as_tensors.items()}, timm)

    cut = {k: v for k, v in hf.items() if k != "encoder.layer.1.attention.attention.key.bias"}
    with pytest.raises(ValueError) as want:
        jax_to_timm(cut)
    with pytest.raises(ValueError) as got:
        hf_vit_sd_to_timm(cut)
    assert str(got.value) == str(want.value)
    assert "blocks.1.attn.qkv.bias" in str(got.value)


def test_classifier_import_from_raw_timm():
    """A JAX classifier's export in HF names, as a raw timm dict (``blocks.*``,
    ``head.*``) and ``module.``-prefixed: the port's classifier loads each
    strict and gives the same logits (1e-6), JAX's logits (1e-4), and not
    its template's."""
    from multimodal_concept_learning_tpu.checkpoint import (
        hf_vit_sd_to_timm,
        vit_classifier_params_to_torch,
    )
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JaxViTConfig
    from multimodal_concept_learning_tpu.models.vit import (
        ViTForImageClassification as JaxClassifier,
    )

    from multimodal_concept_learning_tpu_torch.checkpoint import (
        vit_classifier_state_dict_from_torch,
    )
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )

    jcfg = JaxViTConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                        num_attention_heads=2, patch_size=8, image_size=16, num_labels=3,
                        dtype=jnp.float32)
    jmodel = JaxClassifier(jcfg)
    donor = jax.jit(jmodel.init)(jax.random.key(2), jnp.zeros((1, 3, 16, 16)))["params"]
    hf = {k: np.asarray(v) for k, v in
          vit_classifier_params_to_torch(donor, jcfg.patch_size).items()}
    timm = hf_vit_sd_to_timm({k[len("vit."):]: v for k, v in hf.items() if k.startswith("vit.")})
    timm["head.weight"], timm["head.bias"] = hf["classifier.weight"], hf["classifier.bias"]
    ddp = {f"module.{k}": v for k, v in hf.items()}

    cfg = ViTConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ViTConfig)
                       if f.name != "dtype" and hasattr(jcfg, f.name)}, dtype=torch.float32)
    x = np.random.default_rng(3).normal(size=(2, 3, 16, 16)).astype(np.float32)
    template = ViTForImageClassification(cfg).eval()
    with torch.no_grad():
        y_tmpl = template(torch.from_numpy(x)).numpy()
    logits = {}
    for name, sd in (("hf", hf), ("timm", timm), ("module", ddp)):
        model = ViTForImageClassification(cfg).eval()
        model.load_state_dict(vit_classifier_state_dict_from_torch(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}), strict=True)
        with torch.no_grad():
            logits[name] = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits["timm"], logits["hf"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(logits["module"], logits["hf"], atol=1e-6, rtol=0)
    want = np.asarray(jax.jit(jmodel.apply)({"params": donor}, jnp.asarray(x)))
    np.testing.assert_allclose(logits["timm"], want, atol=1e-4, rtol=0)
    assert np.abs(logits["hf"] - y_tmpl).max() > 1e-4


@pytest.fixture(scope="module")
def timm_results_dir(tmp_path_factory):
    """A results dir (training_config.json, tokenizer/, labels mapping)
    whose best_model.pt is a seeded JAX MLLM exported with
    ``vision_naming="timm"``, plus the reference's pooler and tied
    ``lm_head``; returns (results dir, the exported numpy dict)."""
    from multimodal_concept_learning_tpu.checkpoint import mllm_params_to_torch
    from multimodal_concept_learning_tpu.configs import (
        MultimodalTrainingConfig as JaxTrainingConfig,
    )
    from multimodal_concept_learning_tpu.train.multimodal_training import (
        init_model_and_tokenizer,
    )

    from multimodal_concept_learning_tpu_torch.checkpoint import save_results_dir
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        build_tokenizer,
        model_config,
        training_config,
    )

    root = tmp_path_factory.mktemp("timm")
    mapping = str(root / "labels_mapping.json")
    with open(mapping, "w") as f:
        json.dump({"r255g0b0": "red", "r0g255b0": "<ood 1>", "r0g0b255": "<ood 2>"}, f)
    results = str(root / "results")
    cfg = dict(TRAINING_CONFIG, labels_mapping_path=mapping, results_dir=results)
    config = training_config(cfg)
    tokenizer, _ = build_tokenizer(config)
    save_results_dir(results, MLLM(model_config(config, len(tokenizer), torch.float32)),
                     tokenizer, cfg)

    jmodel, jtok, params, _, _ = init_model_and_tokenizer(
        JaxTrainingConfig.from_params(dict(cfg, vision_path="")), jax.random.key(5))
    assert len(jtok) == len(tokenizer)
    rng = np.random.default_rng(5)
    donor = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32), params)
    vision = jmodel.config.vision
    sd = mllm_params_to_torch(donor, patch_size=vision.patch_size,
                              num_heads=vision.num_attention_heads, vision_naming="timm")
    assert any(k.startswith("vision_model.timm_model.blocks.") for k in sd)
    assert not any(k.startswith("vision_model.encoder.") for k in sd)
    h = vision.hidden_size
    sd["vision_model.pooler.dense.weight"] = rng.standard_normal((h, h)).astype(np.float32)
    sd["vision_model.pooler.dense.bias"] = rng.standard_normal(h).astype(np.float32)
    sd["language_model.lm_head.weight"] = sd["language_model.model.embed_tokens.weight"]
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(results, "models", "best_model.pt"))
    return results, sd


def _prompts(vocab: int):
    rng = np.random.default_rng(9)
    lens, nvt = [6, 3, 5], 17
    t = nvt + max(lens)
    images = rng.random((len(lens), 3, 32, 32)).astype(np.float32)
    ids = rng.integers(4, vocab, size=(len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        mask[i, :nvt + n] = 1
    ids[mask == 0] = 0
    return images, ids, mask


def test_timm_mllm_checkpoint_serves_jax_tokens(timm_results_dir):
    from multimodal_concept_learning_tpu.models.mllm import greedy_generate as jax_greedy

    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate

    results, _ = timm_results_dir
    jax_loaded = tp.jax_serving_load(results)
    port = tp.port_serving_load(results).model
    images, ids, mask = _prompts(port.cfg.lm.vocab_size)
    jm, jp = jax_loaded.model, jax_loaded.params
    batch = [jnp.asarray(a) for a in (images, ids, mask)]
    tensors = [torch.from_numpy(a) for a in (images, ids, mask)]
    want = np.asarray(jax.jit(lambda p, *a: jax_greedy(jm, p, *a, max_new_tokens=N_NEW))(
        jp, *batch))
    got = greedy_generate(port, *tensors, max_new_tokens=N_NEW)
    np.testing.assert_array_equal(got.numpy(), want)

    want_logits = np.asarray(jax.jit(lambda p, *a: jm.apply(
        {"params": p}, jm.apply({"params": p}, *a)["hidden_states"],
        method=lambda m, x: m.language_model.lm_head(x)))(jp, *batch))
    with torch.no_grad():
        got_logits = port.language_model.lm_head(port(*tensors)["hidden_states"]).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got_logits[valid], want_logits[valid], atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("change", ["unknown", "missing"])
def test_other_keys_still_raise(timm_results_dir, tmp_path, change):
    """One more key the MLLM has no slot for, or one key fewer: the port's
    loader refuses (JAX's would skip the first and fill the second from its
    template)."""
    import shutil

    results, sd = timm_results_dir
    copy = str(tmp_path / "results")
    shutil.copytree(results, copy)
    sd = dict(sd)
    if change == "unknown":
        sd["vision_model.timm_model.fc_norm.weight"] = sd["projector.bias"][:8]
        match = "Unexpected key"
    else:
        del sd["vision_model.timm_model.blocks.0.attn.qkv.bias"]
        match = "Missing key"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(copy, "models", "best_model.pt"))
    with pytest.raises(RuntimeError, match=match):
        tp.port_serving_load(copy)
