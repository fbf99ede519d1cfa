"""PyTorch port: the contrastive trainer CLI of both packages (CPU).

Both ``main``s on the same tiny generated color data and YAML: the same
log lines (numbers aside), the same epoch count and per-epoch metric keys,
a zero-shot accuracy in [0, 100], the checkpoint written.  The options
ported late (``resume``, ``partition_text_embedding``, ``bf16_params``)
each run one epoch; the partitioned ``bf16_params`` CLI prints JAX's
"Partitioned text embedding" line (the JAX CLI's rows, from its own
collator) and saves the merged table: the subtable's rows, the other rows
the initial table times the weight decay's product rounded as JAX rounds
it, a dense model loading it ``strict=True``.  Its parity with JAX's
training: ``tests/test_torch_sparse_embed.py`` and
``tests/test_torch_clip_bf16.py``.
"""

import dataclasses
import os
import re

import numpy as np
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
def test_unported_options_raise(dataset_dir, tmp_path, option, capsys):
    """Each option the port once refused now runs (it raised
    ``NotImplementedError`` before the port took it)."""
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import main

    path = _write_config(tmp_path / "c.yaml", dataset_dir, tmp_path / "r", epochs=1,
                         **{option: True})
    out = main(["--config_path", path, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Zero-shot accuracy:" in text and 0.0 <= out["zero_shot_acc"] <= 100.0
    sd = torch.load(out["checkpoint"], weights_only=True)
    if option == "resume":
        assert os.path.exists(tmp_path / "r" / "resume" / "step_0.pt")
    if option == "partition_text_embedding":
        assert "Partitioned text embedding:" in text and "text.token_embedding.active" in sd
    if option == "bf16_params":
        assert all(torch.equal(t, t.bfloat16().float()) for t in sd.values())


def test_partitioned_bf16_cli(dataset_dir, tmp_path, capsys):
    from multimodal_concept_learning_tpu.data.clip_collator import ClipCollator as JCollator
    from multimodal_concept_learning_tpu.ops.sparse_embed import active_rows_from_corpus as jrows
    from multimodal_concept_learning_tpu.tokenizer import load_tokenizer as jload
    from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import inactive_decay
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import init_model, main

    path = _write_config(tmp_path / "c.yaml", dataset_dir, tmp_path / "r",
                         partition_text_embedding=True, bf16_params=True)
    out = main(["--config_path", path, "--device", "cpu"])
    text = capsys.readouterr().out
    jtok = jload("concept-tokenizer")
    jcollator = JCollator(jtok, "a circle of color {class_name}", 16)
    names = sorted({line.split(",")[1] for line in open(
        os.path.join(dataset_dir, "train_mapping.csv")).read().splitlines()[1:]})
    rows = jrows([jcollator.caption_ids(n)[0] for n in names])
    assert f"Partitioned text embedding: {len(rows)} active rows of {len(jtok)}\n" in text
    assert len(out["history"]) == 2 and "Epoch 2/2 completed in" in text

    state = out["state"]
    emb = state.model.text.token_embedding
    assert emb.active_rows == rows and emb.weight.dtype == torch.bfloat16
    assert "text.token_embedding.weight" not in state.optimizer.params
    sd = torch.load(out["checkpoint"], weights_only=True)
    table = sd["text.token_embedding.weight"]
    config = ContrastiveTrainingConfig.from_params(yaml.safe_load(open(path)))
    init = init_model(config, len(jtok), "cpu", rows).text.token_embedding.weight.detach()
    assert torch.equal(emb.weight, init.bfloat16())  # the frozen table never moved
    lrs = [float(np.float32(state.optimizer.lr(i))) for i in range(state.optimizer.count)]
    decay = torch.tensor(inactive_decay(lrs, config.weight_decay), dtype=torch.float32)
    want = (init.bfloat16().float() * decay).bfloat16().float()
    want[list(rows)] = emb.active.detach().float()
    assert state.optimizer.count == 8 and decay.item() < 1.0
    assert torch.equal(table, want) and torch.equal(sd["text.token_embedding.active"],
                                                   emb.active.detach().float())
    dense = CLIPModel(dataclasses.replace(state.model.cfg, active_vocab_rows=None))
    dense.load_state_dict(sd, strict=True)  # ignores the subtable
    assert torch.equal(dense.text.token_embedding.weight, table)
