"""PyTorch port: ImageNet's weights cross between the packages (CPU).

The 100-label classifier of imagenet100 and the MLLM with imagenet1k_vit's
1000-synset labels mapping (100 ``<ood_*>`` tokens) need no new
converter: the existing ones (``vit_classifier_state_dict_from_jax`` /
``vit_classifier_params_from_torch``, ``state_dict_from_jax``) carry them,
with the outputs held to JAX (float32; 1e-4 logits, 1e-5 loss and
gradients).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

import _torch_parity as tp
import chip_smoke
from test_torch_imagenet_train import VISION, data  # noqa: F401  (data: a fixture)


def test_hundred_label_classifier_crosses_packages(data, tmp_path):
    """imagenet100's 100-label head needs no new converter: JAX weights
    load into the port (``vit_classifier_state_dict_from_jax``) and the
    port's ``.pt`` into JAX (``vit_classifier_params_from_torch``); the
    logits on a JPEG-fed batch agree (float32, 1e-4)."""
    import torch

    from multimodal_concept_learning_tpu.checkpoint import load_torch_state_dict
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        vit_classifier_params_from_torch,
    )
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JViTConfig
    from multimodal_concept_learning_tpu.models.vit import (
        ViTForImageClassification as JClassifier,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        save_state_dict,
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTForImageClassification

    tree, mapping_dir, _ = data
    dims = {k: VISION[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                   "num_attention_heads", "patch_size", "image_size")}
    jmodel = JClassifier(JViTConfig(**dims, num_labels=100, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.key(2), jnp.zeros((1, 3, 32, 32)))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    port = ViTForImageClassification(ViTConfig(**dims, num_labels=100, dtype=torch.float32))
    port.load_state_dict(vit_classifier_state_dict_from_jax(params["params"], 8), strict=True)
    config = VisionTrainingConfig.from_params(dict(VISION, data_dir=tree))
    ds = ImageNetDataset(os.path.join(mapping_dir, "train_mapping.csv"), tree,
                         create_transforms(config, True, 0), verbose=False)
    x = np.stack([ds[i][0] for i in range(6)])
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (6, 100)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    path = str(tmp_path / "best_model.pt")
    save_state_dict({k: v.detach() for k, v in port.state_dict().items()}, path)
    back = vit_classifier_params_from_torch(load_torch_state_dict(path), params, 8)
    np.testing.assert_allclose(np.asarray(jmodel.apply(back, jnp.asarray(x))), want, atol=1e-4,
                               rtol=0)


def test_thousand_class_mllm_crosses_packages():
    """imagenet1k_vit's vocabulary (nano + the repo mapping's 100
    ``<ood_*>`` tokens, rows initialised by ``copy_init_ood_rows`` in both
    packages, bitwise) needs no new converter: ``state_dict_from_jax``
    gives the port the JAX weights, and the loss and the embedding
    gradient agree (float32, 1e-5)."""
    import torch

    from multimodal_concept_learning_tpu.models.mllm import copy_init_ood_rows as jcopy
    from multimodal_concept_learning_tpu.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.models.mllm import copy_init_ood_rows

    with open(chip_smoke.IMAGENET1K_MAPPING) as f:
        mapping = json.load(f)
    ood = [v for v in mapping.values() if v.startswith("<ood_")]
    tok = load_tokenizer("nano")
    base = len(tok)
    assert tok.add_tokens(ood) == len(ood) == 100
    model, params, port = tp.make_pair(vocab=len(tok), seed=4)
    jparams = jcopy(jax.tree_util.tree_map(jnp.asarray, params), len(ood))
    copy_init_ood_rows(port, len(ood))
    table = port.language_model.model.embed_tokens.weight.detach().numpy()
    np.testing.assert_array_equal(
        table, np.asarray(jparams["params"]["language_model"]["embed_tokens"]["embedding"]))
    np.testing.assert_array_equal(table[base:base + 100], table[:100])
    images, ids, mask = tp.prompt_batch(model.config, [5, 3], seed=1)
    ids[:, model.config.num_vision_tokens] = base + np.array([7, 93])  # two <ood_*> tokens
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :model.config.num_vision_tokens + 1] = -100

    def loss_fn(p):
        return model.apply(p, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                           jnp.asarray(labels))["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    out = port(torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
               torch.from_numpy(labels))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(ref_loss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        port.language_model.model.embed_tokens.weight.grad.numpy(),
        np.asarray(ref_grads["params"]["language_model"]["embed_tokens"]["embedding"]),
        atol=1e-5, rtol=0)
