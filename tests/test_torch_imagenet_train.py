"""PyTorch port: the vision trainer on ImageNet data (CPU).

On the synthetic ILSVRC2012 tree of ``test_torch_imagenet.py`` (JPEG
fixtures, mapping CSVs from the port's builder CLI), with random train
pipelines (RandomResizedCrop, flip, RandAugment, RandomErasing) decoded and
transformed by each package and the same initial weights:

- the vision classifier's ``run_training`` (2 layers, 64 wide, 32 px,
  dropout 0, label smoothing 0.1) of both packages: per-epoch losses and
  accuracies within 1e-4 relative (the MLLM trainer test's tolerance),
  once the port's train pipeline has made the draws that the JAX trainer's
  init peek makes (ROADMAP.md, queue C);
- the port's vision CLI on a tiny ImageNet YAML: the JAX CLI's lines, a
  checkpoint the JAX package loads.

The MLLM and the analysis: ``test_torch_imagenet_mllm.py``.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from multimodal_concept_learning_tpu.utils.logging import MetricsLogger
from test_torch_imagenet import PER_CLASS, TRAIN_PIPELINE, VAL_PIPELINE, WORDS

MAPPING = {"n01000001": "dog", "n01000002": "cat", "n02000001": "<ood_car>",
           "n02000002": "truck", "n02000003": "<ood_bus>", "n02000004": "true"}
SMALL_TRAIN = [dict(p, size=32) if isinstance(p, dict) and p["name"] == "RandomResizedCrop"
               else p for p in TRAIN_PIPELINE]
SMALL_VAL = [{"name": "Resize", "size": [32, 32]}, *VAL_PIPELINE[1:]]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(tree, mapping dir, labels mapping path) of a builder run."""
    import yaml

    from multimodal_concept_learning_tpu_torch.data.imagenet_builder import main

    root = tmp_path_factory.mktemp("imagenet_train")
    tree = chip_smoke.write_imagenet_tree(str(root / "imagenet"), WORDS, PER_CLASS, n_val=10)
    cfg = root / "ds.yaml"
    cfg.write_text(yaml.dump(dict(data_dir=tree, output_dir=str(root), dataset_name="mini",
                                  allow_shortfall=True, seed=3, per_class_train=3,
                                  per_class_val=1, per_class_test=2,
                                  target_synsets=sorted(WORDS))))
    with contextlib.redirect_stdout(io.StringIO()):
        main(["--config_path", str(cfg)])
    labels = root / "labels_mapping.json"
    labels.write_text(json.dumps(MAPPING))
    return tree, str(root / "mini"), str(labels)


def _splits(pkg, config, return_synset, mapping_dir, data_dir):
    if pkg == "jax":
        from multimodal_concept_learning_tpu.data import ImageNetDataset, load_split_datasets
        from multimodal_concept_learning_tpu.data.transforms import create_transforms
    else:
        from multimodal_concept_learning_tpu_torch.data.datasets import (
            ImageNetDataset,
            load_split_datasets,
        )
        from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    splits = load_split_datasets(ImageNetDataset, mapping_dir, data_dir,
                                 create_transforms(config, True, config.seed),
                                 create_transforms(config, False, config.seed), return_synset)
    for ds in splits:
        ds._native_spec = None  # the JAX package's Pillow path
    return splits


def _loader_cls(pkg):
    if pkg == "jax":
        from multimodal_concept_learning_tpu.data import BatchLoader
    else:
        from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
    return BatchLoader


VISION = dict(model_name="vit", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, patch_size=8, image_size=32, hidden_dropout_prob=0.0,
              attention_dropout_prob=0.0, dataset_name="imagenet100", epochs=2,
              learning_rate=1e-3, batch_size=4, effective_batch_size=8, weight_decay=0.1,
              label_smoothing=0.1, num_workers=3, seed=4, disable_wandb=True,
              train_transforms=SMALL_TRAIN, val_transforms=SMALL_VAL)


def test_vision_run_training_matches_jax(data, tmp_path, monkeypatch):
    from multimodal_concept_learning_tpu.configs import VisionTrainingConfig as JConfig
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JViTConfig
    from multimodal_concept_learning_tpu.models.vit import (
        ViTForImageClassification as JClassifier,
    )
    from multimodal_concept_learning_tpu.train.common import mesh_for_batch
    from multimodal_concept_learning_tpu.train.vision_training import run_training as jrun
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.train.vision_training import run_training

    tree, mapping_dir, _ = data
    dims = {k: VISION[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                   "num_attention_heads", "patch_size", "image_size")}
    n_labels = sum(1 for v in PER_CLASS.values() if v)
    jmodel = JClassifier(JViTConfig(**dims, num_labels=n_labels, dtype=jnp.float32))
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    logged = {"jax": [], "port": []}
    for pkg in ("jax", "port"):
        cls = JConfig if pkg == "jax" else VisionTrainingConfig
        config = cls.from_params(dict(VISION, data_dir=tree, mapping_path=mapping_dir,
                                      results_dir=str(tmp_path / pkg)))
        train, val, _ = _splits(pkg, config, False, mapping_dir, tree)
        assert train.num_classes == n_labels
        loader = _loader_cls(pkg)
        kw = dict(batch_size=config.batch_size, num_workers=config.num_workers)
        train_loader = loader(train, shuffle=True, drop_last=True, seed=config.seed, **kw)
        val_loader = loader(val, **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            if pkg == "jax":
                with monkeypatch.context() as mp:
                    mp.setattr(MetricsLogger, "log",
                               lambda self, m: logged["jax"].append(dict(m)))
                    mp.setattr(JClassifier, "init", lambda self, *a, **k: {"params": params})
                    jrun(jmodel, train_loader, val_loader, config,
                         mesh_for_batch(config.batch_size), jax.random.key(1))
            else:
                import torch

                model = ViTForImageClassification(ViTConfig(**dims, num_labels=n_labels,
                                                            dtype=torch.float32))
                model.load_state_dict(vit_classifier_state_dict_from_jax(params, 8), strict=True)
                # JAX's run_training peeks at a batch for its init shapes; its loader's
                # producer draws the transforms of every batch that fits in its queue
                # (here all 3 of epoch 0) before training: the same draws, made here
                # (ROADMAP.md, queue C)
                assert len(train_loader) <= train_loader.prefetch_batches + 1
                list(train_loader)
                _, logged["port"] = run_training(model, train_loader, val_loader, config,
                                                 torch.Generator().manual_seed(0))
    assert len(logged["port"]) == len(logged["jax"]) == 2
    for got, want in zip(logged["port"], logged["jax"]):
        for key in ("train_loss", "val_loss", "train_acc", "val_acc", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_vision_cli_on_imagenet(data, tmp_path):
    """The port's CLI on a tiny imagenet100 YAML: the JAX CLI's dataset
    line, its epochs, and a best_model.pt that the JAX package loads with
    the port's logits (float32, 1e-4) on a JPEG-fed batch."""
    from multimodal_concept_learning_tpu.checkpoint import load_torch_state_dict
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        vit_classifier_params_from_torch,
    )
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JViTConfig
    from multimodal_concept_learning_tpu.models.vit import (
        ViTForImageClassification as JClassifier,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.train.vision_training import main

    import torch

    tree, mapping_dir, _ = data
    results = str(tmp_path / "results")
    cfg = dict(VISION, data_dir=tree, mapping_path=mapping_dir, results_dir=results,
               hidden_dropout_prob=0.1, attention_dropout_prob=0.1, epochs=1)
    path = tmp_path / "cfg.yaml"
    path.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in cfg.items()) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(["--config_path", str(path), "--device", "cpu"])
    text = buf.getvalue()
    assert "Loaded imagenet100 dataset with 15 train samples, 4 validation samples, and 10 " \
           "test samples." in text, text
    assert "Epoch 1/1 completed in" in text and "Test Results:" in text
    assert np.isfinite(out["test_loss"]) and out["history"][0]["micro_steps"] == 3
    dims = {k: VISION[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                   "num_attention_heads", "patch_size", "image_size")}
    port = ViTForImageClassification(ViTConfig(**dims, num_labels=5, dtype=torch.float32))
    best = os.path.join(results, "models", "best_model.pt")
    port.load_state_dict(load_state_dict(best), strict=True)
    val = ImageNetDataset(os.path.join(mapping_dir, "test_mapping.csv"), tree,
                          create_transforms(type("C", (), cfg), False, 0), verbose=False)
    x = np.stack([val[i][0] for i in range(4)])
    jmodel = JClassifier(JViTConfig(**dims, num_labels=5, dtype=jnp.float32))
    template = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))
    jparams = vit_classifier_params_from_torch(load_torch_state_dict(best), template, 8)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, jnp.asarray(x))),
                               atol=1e-4, rtol=0)

