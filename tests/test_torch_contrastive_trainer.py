"""PyTorch port: the contrastive trainer CLI of both packages (CPU).

Both ``main``s on the same tiny generated color data and YAML: the same
log lines (numbers aside), the same epoch count and per-epoch metric keys,
a zero-shot accuracy in [0, 100], the checkpoint written; the options the
port does not run yet raise ``NotImplementedError``.
"""

import os
import re

import pytest
import torch
import yaml


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )

    root = tmp_path_factory.mktemp("clip_cli")
    cfg = ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32,
        "colors": [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]],
        "radius_range": [4, 10], "n_images_per_color": 12,
        "train_val_test_split": [0.7, 0.15, 0.15], "data_dir": str(root), "seed": 0})
    return generate_color_dataset(cfg, verbose=False)


def _write_config(path, dataset_dir, results_dir, **kw):
    cfg = dict({
        "mapping_path": os.path.join(dataset_dir, "train_mapping.csv"),
        "image_root": dataset_dir, "caption_template": "a circle of color {class_name}",
        "vision_model_name": "vit-t-8", "image_size": 32, "text_width": 64, "text_layers": 2,
        "text_heads": 4, "context_length": 16, "embed_dim": 32, "epochs": 2, "batch_size": 8,
        "effective_batch_size": 8, "learning_rate": 1e-3, "warmup_steps": 2,
        "results_dir": str(results_dir), "seed": 0, "train_transforms": ["ToTensor"],
        "val_transforms": ["ToTensor"],
    }, **kw)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _shape(out: str):
    """The log's lines with every number replaced by '#'."""
    return [re.sub(r"\d+(\.\d+)?", "#", line) for line in out.splitlines()
            if line.startswith(("Loaded contrastive", "Epoch", "Zero-shot"))]


def test_both_clis_train_and_evaluate_alike(dataset_dir, tmp_path, capsys, monkeypatch):
    from multimodal_concept_learning_tpu.train.contrastive_training import main as jax_main
    from multimodal_concept_learning_tpu.utils.logging import MetricsLogger
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import main

    logged = []
    monkeypatch.setattr(MetricsLogger, "log", lambda self, m: logged.append(dict(m)))
    jax_metrics = jax_main(["--config_path", _write_config(tmp_path / "j.yaml", dataset_dir,
                                                           tmp_path / "rj")])
    jax_out = capsys.readouterr().out
    port = main(["--config_path", _write_config(tmp_path / "p.yaml", dataset_dir, tmp_path / "rp"),
                 "--device", "cpu"])
    port_out = capsys.readouterr().out

    assert _shape(port_out) == _shape(jax_out)
    assert [line for line in port_out.splitlines() if line.startswith("Loaded contrastive")] == \
        [line for line in jax_out.splitlines() if line.startswith("Loaded contrastive")]
    assert "Epoch 2/2 completed in" in port_out and "Zero-shot accuracy:" in port_out
    assert len(port["history"]) == len(logged) == 2
    for got, want in zip(port["history"], logged):
        assert set(want) <= set(got) and got["epoch"] == want["epoch"]
        assert got["steps"] == 4  # 33 train pairs at batch 8, drop_last
    for metrics in (port, jax_metrics):
        assert 0.0 <= metrics["zero_shot_acc"] <= 100.0
    assert os.path.basename(port["checkpoint"]) == "step_8.pt"
    sd = torch.load(port["checkpoint"], weights_only=True)
    assert sd["logit_scale"].dtype == torch.float32 and "text.blocks.1.q.weight" in sd
    assert any(c.startswith("step_") for c in os.listdir(tmp_path / "rj" / "checkpoints"))


@pytest.mark.parametrize("option", ["resume", "partition_text_embedding", "bf16_params"])
def test_unported_options_raise(dataset_dir, tmp_path, option):
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import main

    path = _write_config(tmp_path / "c.yaml", dataset_dir, tmp_path / "r", **{option: True})
    with pytest.raises(NotImplementedError, match=option):
        main(["--config_path", path, "--device", "cpu"])
