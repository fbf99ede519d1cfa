"""PyTorch port: the vision trainer CLI and the MLLM's ``vision_path``
warm start (CPU).

The port's CLI trains a vit-t-8-like classifier (the shapes of
``test_torch_vision_trainer.py``) for two epochs on a generated 5-color
dataset of 64x64 images, dropout 0.1.  Its ``best_model.pt`` loads through
the JAX package's ``vit_classifier_params_from_torch`` and gives the port's
logits there (float32, 1e-4).  A JAX-written and a port-written vision
``.pt`` warm-start the port's MLLM tower bitwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vision_trainer import DIMS, _images, jax_params  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def color_data(tmp_path_factory):
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )

    root = tmp_path_factory.mktemp("vision")
    cfg = ColorDatasetConfig.from_params({
        "dataset_name": "tiny5", "image_size": 64,
        "colors": [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [0, 255, 255]],
        "radius_range": [8, 20], "n_images_per_color": 8,
        "train_val_test_split": [0.5, 0.25, 0.25], "data_dir": str(root), "seed": 0})
    return root, generate_color_dataset(cfg, verbose=False)


def _write_yaml(path, data_dir, results_dir, **over):
    cfg = dict(model_name="vit", hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, patch_size=8, image_size=64, num_labels=100,
               hidden_dropout_prob=0.1, attention_dropout_prob=0.1, data_dir=data_dir,
               dataset_name="color", mapping_path=data_dir, epochs=2, learning_rate=1e-3,
               batch_size=4, effective_batch_size=8, weight_decay=0.1, label_smoothing=0.0,
               num_workers=2, results_dir=results_dir, seed=3, disable_wandb=True,
               train_transforms=["ToTensor"], val_transforms=["ToTensor"])
    cfg.update(over)
    path.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in cfg.items()) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def trained(color_data, tmp_path_factory):
    """The port's CLI on the CPU, two epochs, dropout 0.1: (results dir,
    its return value, its stdout)."""
    import contextlib
    import io

    from multimodal_concept_learning_tpu_torch.train.vision_training import main

    _, data_dir = color_data
    tmp = tmp_path_factory.mktemp("vision_run")
    results = str(tmp / "results")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(["--config_path", _write_yaml(tmp / "cfg.yaml", data_dir, results),
                    "--device", "cpu"])
    return results, out, buf.getvalue()


def test_cli_trains_and_its_checkpoint_loads_into_jax(trained):
    """The CLI's log lines, its float32 HF-named checkpoints, and
    ``best_model.pt`` through JAX ``vit_classifier_params_from_torch``: the
    JAX logits equal the port's on the same weights (float32, 1e-4)."""
    import re

    from multimodal_concept_learning_tpu.checkpoint import load_torch_state_dict
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        vit_classifier_params_from_torch,
    )
    from multimodal_concept_learning_tpu.models.vit import ViTConfig, ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig as PConfig
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTForImageClassification as PModel,
    )

    results, out, text = trained
    assert "Loaded color dataset with 20 train samples, 10 validation samples, and 10 test" in text
    for epoch in (1, 2):
        assert re.search(rf"^Epoch {epoch}/2 completed in \d+\.\d\ds$", text, re.M)
    assert re.search(r"^Train Loss: \d+\.\d{4}, Train Acc: \d+\.\d\d%$", text, re.M)
    assert re.search(r"^Val Loss: \d+\.\d{4}, Val Acc: \d+\.\d\d%$", text, re.M)
    assert re.search(r"^Learning Rate: \d\.\d{6}$", text, re.M)
    assert re.search(r"^Best val loss: \d+\.\d{4}$", text, re.M)
    assert "FINAL EVALUATION ON TEST SET\n" + "=" * 50 + "\nTest Results:\nTest Loss:" in text
    assert [m["micro_steps"] for m in out["history"]] == [5, 5]
    assert all(np.isfinite(m["train_loss"]) and np.isfinite(m["val_loss"])
               for m in out["history"])
    assert np.isfinite(out["test_loss"]) and 0.0 <= out["test_acc"] <= 100.0
    # 5 micro-steps an epoch, accumulation 2: the 10th completes the 5th update
    assert out["state"].step == 10 and out["state"].optimizer.count == 5

    models = os.path.join(results, "models")
    best = load_state_dict(os.path.join(models, "best_model.pt"))
    raw = torch.load(os.path.join(models, "final_model.pt"), weights_only=True)
    assert all(t.dtype == torch.float32 for t in raw.values())
    assert sorted(raw) == sorted(best) and "classifier.weight" in best
    assert any(k.startswith("vit.encoder.layer.1.") for k in best)
    port = PModel(PConfig(**dict(DIMS, num_labels=5), dtype=torch.float32))
    port.load_state_dict(best, strict=True)

    jmodel = ViTForImageClassification(ViTConfig(**dict(DIMS, num_labels=5), dtype=jnp.float32))
    template = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 3, 64, 64)))
    jparams = vit_classifier_params_from_torch(
        load_torch_state_dict(os.path.join(models, "best_model.pt")), template, 8)
    x = _images(4, seed=11)
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_cli_refuses_resume_and_imagenet(color_data, tmp_path):
    """Neither resume nor imagenet100 is refused any more: imagenet100 reads
    ImageNet mapping CSVs (its runs: tests/test_torch_imagenet.py), so a
    color CSV fails on its missing target_synset column."""
    from multimodal_concept_learning_tpu_torch.train.vision_training import main

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig

    _, data_dir = color_data
    path = _write_yaml(tmp_path / "cfg.yaml", data_dir, str(tmp_path / "r"),
                       dataset_name="imagenet100")
    with pytest.raises(KeyError, match="target_synset"):
        main(["--config_path", path, "--device", "cpu"])
    # resume is ported (its runs: tests/test_torch_resume.py)
    path = _write_yaml(tmp_path / "cfg.yaml", data_dir, str(tmp_path / "r"), resume=True)
    with open(path) as f:
        assert VisionTrainingConfig.from_params(miniyaml.safe_load(f)).resume is True
    path = _write_yaml(tmp_path / "cfg.yaml", data_dir, str(tmp_path / "r"),
                       effective_batch_size=6)
    with pytest.raises(AssertionError, match=r"effective_batch_size \(6\).*batch_size \(4\)"):
        main(["--config_path", path, "--device", "cpu"])


def _mllm_config(vision_path):
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig

    return MultimodalTrainingConfig.from_params({
        "vision_model_name": "vit-t-8", "language_model_name": "nano", "image_size": 64,
        "num_vision_tokens": 65, "labels_mapping_path": "", "vision_path": vision_path})


def test_vision_path_warm_start_from_either_package(jax_params, trained, tmp_path, capsys):
    """A JAX-written and a port-written vision ``.pt`` each warm-start the
    port's MLLM tower bitwise (the trainer's ``init_model_and_tokenizer``
    for the first); a DDP ``module.`` save too; a checkpoint lacking tower
    tensors raises and names them."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        save_torch_state_dict,
        vit_classifier_params_to_torch,
    )
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import (
        init_model_and_tokenizer,
        load_vision_tower_,
    )

    results, _, _ = trained
    port_pt = os.path.join(results, "models", "best_model.pt")
    jax_pt = str(tmp_path / "jax_vision.pt")
    save_torch_state_dict(vit_classifier_params_to_torch(jax_params, 8), jax_pt)
    ddp = str(tmp_path / "ddp.pt")
    torch.save({f"module.{k}": v for k, v in torch.load(port_pt, weights_only=True).items()},
               ddp)
    model, *_ = init_model_and_tokenizer(_mllm_config(jax_pt),
                                         torch.Generator().manual_seed(0), "cpu")
    for path in (jax_pt, port_pt, ddp):
        if path != jax_pt:
            load_vision_tower_(model, path)
        assert capsys.readouterr().out.strip().endswith(f"Loaded vision tower weights from {path}")
        sd = {k.removeprefix("module."): v for k, v in torch.load(path, weights_only=True).items()}
        tower = model.vision_model.state_dict()
        assert len(tower) == sum(k.startswith("vit.") for k in sd)
        for name, t in tower.items():
            assert torch.equal(t, sd[f"vit.{name}"]), (path, name)
    partial = str(tmp_path / "partial.pt")
    sd = torch.load(port_pt, weights_only=True)
    torch.save({k: v for k, v in sd.items() if "layer.1." not in k}, partial)
    with pytest.raises(KeyError, match=r"lacks 16 vision tower tensors.*encoder\.layer\.1\."):
        load_vision_tower_(model, partial)


def test_device_normalize_batches_match_the_float_path(color_data):
    """``device_normalize``: the classifier loader ships uint8 NHWC images
    (the default collate's ``images_u8``) that normalise on the device to
    exactly the float path's images, with the same labels."""
    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ColorDataset,
        load_split_datasets,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch

    class Cfg:
        train_transforms = val_transforms = ["ToTensor", "Normalize"]
        normalize_mean, normalize_std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]

    _, data_dir = color_data
    train, _, _ = load_split_datasets(ColorDataset, data_dir, data_dir,
                                      create_transforms(Cfg, True), create_transforms(Cfg, False))
    u8, f32 = (next(iter(BatchLoader(train, 6, shuffle=True, seed=1, num_workers=2,
                                     uint8_images=u))) for u in (True, False))
    assert u8["images_u8"].dtype == np.uint8 and "images" not in u8
    np.testing.assert_array_equal(u8["labels"], f32["labels"])
    got = images_from_batch(to_device(u8, "cpu"))
    np.testing.assert_allclose(got.numpy(), f32["images"], atol=1e-6, rtol=0)
