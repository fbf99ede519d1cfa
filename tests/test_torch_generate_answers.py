"""PyTorch port: the answer CLI (``train/generate_answers.py``) vs the JAX CLI.

Both CLIs read one tiny results dir (vit-t-8 + nano, 32 px, seeded random
weights written in the reference layout by the port) in float32 on the
CPU and must write the same ``generations.jsonl`` (greedy) and print the
same accuracy lines, greedy and with beam search (``--num_beams``,
``--length_penalty``) and self-speculative decoding (``--draft_layers``,
``--draft_len``).  Also: the port's refusals (the JAX parser's own errors;
``--int8 --int4``), and ``strip_answer_span`` against the JAX function.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TRAINING_CONFIG = {
    "prompt_template": "Is the color of the circle {class_name}?",
    "dataset_name": "color_multimodal", "vision_model_name": "vit-t-8",
    "language_model_name": "nano", "num_vision_tokens": 17, "image_size": 32,
    "trainable_params_setting": "language_embed_only", "batch_size": 4,
    "effective_batch_size": 4, "seed": 0, "num_workers": 1,
    "train_transforms": ["ToTensor"], "val_transforms": ["ToTensor"], "use_wandb": False,
}


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    """A results dir of seeded random weights over a 2-color 32 px dataset."""
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        init_random_weights_,
        save_results_dir,
    )
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        build_tokenizer,
        model_config,
        training_config,
    )

    root = tmp_path_factory.mktemp("answers")
    data_dir = generate_color_dataset(ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32, "colors": [[255, 0, 0], [0, 255, 0]],
        "radius_range": [4, 10], "n_images_per_color": 10, "data_dir": str(root),
        "seed": 0}), verbose=False)
    mapping = str(root / "labels_mapping.json")
    with open(mapping, "w") as f:
        json.dump({"r255g0b0": "red", "r0g255b0": "<ood 1>"}, f)
    results = str(root / "results")
    cfg = dict(TRAINING_CONFIG, mapping_path=os.path.join(data_dir, "train_mapping.csv"),
               image_root=data_dir, labels_mapping_path=mapping, results_dir=results)
    config = training_config(cfg)
    tokenizer, _ = build_tokenizer(config)
    model = MLLM(model_config(config, len(tokenizer), torch.float32))
    init_random_weights_(model, torch.Generator().manual_seed(0), std=0.2)
    save_results_dir(results, model, tokenizer, cfg)
    return results


def _jax_float32_loader(monkeypatch):
    """The JAX CLI's loader, switched to float32 compute (as the port's
    ``--dtype float32``)."""
    from multimodal_concept_learning_tpu.models.mllm import MLLM
    from multimodal_concept_learning_tpu.serve import loader

    original = loader.load_trained_mllm

    def load(*args, **kwargs):
        loaded = original(*args, **kwargs)
        cfg = loaded.model.config
        f32 = dataclasses.replace(cfg, dtype=jnp.float32,
                                  vision=dataclasses.replace(cfg.vision, dtype=jnp.float32),
                                  lm=dataclasses.replace(cfg.lm, dtype=jnp.float32))
        return loaded._replace(model=MLLM(f32))

    monkeypatch.setattr(loader, "load_trained_mllm", load)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _both_clis(results_dir, tmp_path, monkeypatch, capsys, extra, limit: int = 5):
    """Run the JAX CLI and the port's on the same arguments: (JAX result,
    port result, JAX stdout, port stdout, JAX rows, port rows)."""
    from multimodal_concept_learning_tpu.train.generate_answers import main as jax_main

    from multimodal_concept_learning_tpu_torch.train.generate_answers import main

    common = ["--results_dir", results_dir, "--limit", str(limit), "--max_new_tokens", "3",
              "--split", "train", *extra]
    _jax_float32_loader(monkeypatch)
    want = jax_main(common + ["--output", str(tmp_path / "jax.jsonl")])
    jax_out = capsys.readouterr().out
    got = main(common + ["--output", str(tmp_path / "port.jsonl"), "--device", "cpu",
                         "--dtype", "float32"])
    port_out = capsys.readouterr().out
    return (want, got, jax_out, port_out, _lines(tmp_path / "jax.jsonl"),
            _lines(tmp_path / "port.jsonl"))


def test_cli_matches_jax(results_dir, tmp_path, monkeypatch, capsys):
    want, got, jax_out, port_out, jax_rows, rows = _both_clis(results_dir, tmp_path,
                                                              monkeypatch, capsys, [])
    assert got["n"] == want["n"] == 5 and got["batches"] == 2
    assert {k: got[k] for k in want} == want
    assert rows == jax_rows
    assert len(rows) == 5 and all(r["generated"] for r in rows)
    for prefix in ("Generated answers for 5 samples (train split)", "Yes/No Accuracy:",
                   "Exact-Match Accuracy:"):
        line = next(ln for ln in jax_out.splitlines() if ln.startswith(prefix))
        assert line in port_out.splitlines()


@pytest.mark.parametrize("extra", [
    ["--num_beams", "2"],
    ["--num_beams", "3", "--length_penalty", "0.6"],
    ["--draft_layers", "1"],
    ["--draft_layers", "2", "--draft_len", "3"],
], ids=["beams2", "beams3-penalty", "draft1", "draft2-len3"])
def test_cli_decoding_modes_match_jax(results_dir, tmp_path, monkeypatch, capsys, extra):
    """Beam search and self-speculative decoding, as the JAX CLI wires
    them: the same JSONL rows and accuracies."""
    want, got, _, port_out, jax_rows, rows = _both_clis(results_dir, tmp_path, monkeypatch,
                                                        capsys, extra, limit=4)
    assert {k: got[k] for k in want} == want and got["n"] == 4
    assert rows == jax_rows and all(r["generated"] for r in rows)
    assert "Generated answers for 4 samples (train split)" in port_out


@pytest.mark.parametrize("extra,error", [
    (["--num_beams", "2", "--temperature", "0.5"], SystemExit),
    (["--draft_layers", "1", "--temperature", "0.5"], SystemExit),
    (["--int8", "--int4"], ValueError),
])
def test_cli_refusals(results_dir, extra, error):
    from multimodal_concept_learning_tpu_torch.train.generate_answers import main

    with pytest.raises(error):
        main(["--results_dir", results_dir, "--device", "cpu"] + extra)


def test_strip_answer_span_matches_jax():
    from multimodal_concept_learning_tpu.train.generate_answers import (
        strip_answer_span as jax_strip,
    )

    from multimodal_concept_learning_tpu_torch.train.generate_answers import strip_answer_span

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, size=(5, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[3, 9:] = 0
    labels = np.full_like(ids, -100)
    labels[0, 7:9] = ids[0, 7:9]
    labels[1, 11] = ids[1, 11]
    labels[3, 5:9] = ids[3, 5:9]  # row 2 and 4: no answer
    for got, want in zip(strip_answer_span(ids, mask, labels, 0),
                         jax_strip(ids, mask, labels, 0)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
