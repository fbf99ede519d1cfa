"""PyTorch port: ``run_training`` of both packages (CPU).

Two epochs on one tiny color dataset, float32, the same initial weights
(carried by ``state_dict_from_jax``): per-epoch train/val loss within 1e-4
relative, the saved ``best_model.pt`` within 1e-4 abs, the same test
accuracy, frozen leaves bitwise those of ``initial_model.pt``, and the
trained model's own frozen parameters bitwise unchanged.  The
fixtures and config helpers are shared with ``test_torch_crossload.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

from multimodal_concept_learning_tpu.configs import ColorDatasetConfig, MultimodalTrainingConfig
from multimodal_concept_learning_tpu.tokenizer import load_tokenizer
from multimodal_concept_learning_tpu.utils.logging import MetricsLogger

COLORS = [[255, 0, 0], [0, 255, 0], [255, 32, 0], [0, 255, 32]]
LABELS_MAPPING = {"r255g0b0": "red", "r0g255b0": "green", "r255g32b0": "<ood 1>",
                  "r0g255b32": "<ood 2>"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from multimodal_concept_learning_tpu_torch.data.color_generator import generate_color_dataset

    root = tmp_path_factory.mktemp("trainer")
    cfg = ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32, "colors": COLORS, "radius_range": [4, 10],
        "n_images_per_color": 10, "min_intensity": 0.9, "max_intensity": 1.0,
        "train_val_test_split": [0.6, 0.2, 0.2], "data_dir": str(root), "seed": 0})
    data_dir = generate_color_dataset(cfg, verbose=False)
    mapping = root / "labels_mapping.json"
    mapping.write_text(json.dumps(LABELS_MAPPING))
    return root, data_dir, str(mapping)


def _config(data_dir, mapping, results_dir, **kw):
    return dict({
        "mapping_path": os.path.join(data_dir, "train_mapping.csv"), "image_root": data_dir,
        "labels_mapping_path": mapping,
        "prompt_template": "Is the color of the circle {class_name}?",
        "dataset_name": "color_multimodal", "vision_model_name": "vit-t-8",
        "language_model_name": "nano", "num_vision_tokens": 17, "image_size": 32,
        "trainable_params_setting": "language_embed_only", "epochs": 2, "batch_size": 4,
        "effective_batch_size": 8, "learning_rate": 5e-4, "save_every_epoch": True,
        "results_dir": results_dir, "seed": 0, "num_workers": 2,
        "train_transforms": ["ToTensor"], "val_transforms": ["ToTensor"], "use_wandb": False,
    }, **kw)


def _tokenizer():
    tok = load_tokenizer("nano")
    tok.add_tokens([v for v in LABELS_MAPPING.values() if v.startswith("<ood")])
    return tok


def _loaders(pkg, config, tokenizer):
    """(train, val, test) loaders of one package over the same CSVs."""
    if pkg == "jax":
        from multimodal_concept_learning_tpu.data import (
            BatchLoader,
            ColorDataset,
            MultimodalCollator,
            create_transforms,
            load_split_datasets,
        )
    else:
        from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
        from multimodal_concept_learning_tpu_torch.data.datasets import (
            ColorDataset,
            load_split_datasets,
        )
        from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
        from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    splits = load_split_datasets(ColorDataset, os.path.dirname(config.mapping_path),
                                 config.image_root, create_transforms(config, True, config.seed),
                                 create_transforms(config, False, config.seed), True)
    for ds in splits:
        ds._native_spec = None  # the JAX package's Pillow decode (exact /255)
    collator = MultimodalCollator(tokenizer, config.num_vision_tokens, config.prompt_template,
                                  splits[0].unique_labels, LABELS_MAPPING, seed=config.seed)
    kw = dict(collate_fn=collator, num_workers=2)
    return (BatchLoader(splits[0], config.batch_size, shuffle=True, drop_last=True,
                        seed=config.seed, **kw),
            BatchLoader(splits[1], config.batch_size, **kw),
            BatchLoader(splits[2], config.batch_size, **kw))


def test_run_training_matches_jax(dataset, monkeypatch):
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu.models.mllm import copy_init_ood_rows as jcopy
    from multimodal_concept_learning_tpu.train.common import mesh_for_batch
    from multimodal_concept_learning_tpu.train.multimodal_training import run_training as jrun
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        changed_frozen,
        load_state_dict,
        state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import run_training

    root, data_dir, mapping = dataset
    tok = _tokenizer()
    jcfg = tp.jax_config(vocab=len(tok), image_size=32)
    jmodel = JaxMLLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                  jnp.zeros((1, 21), jnp.int32), jnp.ones((1, 21), jnp.int32))
    params = jcopy(params, 2)["params"]
    logged = {"jax": [], "port": []}
    metrics = {}
    for pkg in ("jax", "port"):
        config = MultimodalTrainingConfig.from_params(
            _config(data_dir, mapping, str(root / f"results_{pkg}")))
        loaders = _loaders(pkg, config, tok)
        if pkg == "jax":
            with monkeypatch.context() as mp:
                mp.setattr(MetricsLogger, "log", lambda self, m: logged["jax"].append(dict(m)))
                _, metrics[pkg] = jrun(jmodel, tok, params, *loaders, config,
                                       mesh_for_batch(config.batch_size), jax.random.key(1))
        else:
            port = MLLM(tp.port_config(jcfg))
            port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                     8), strict=True)
            state, metrics[pkg], logged[pkg] = run_training(port, tok, *loaders, config)
    assert len(logged["port"]) == len(logged["jax"]) == 2
    for got, want in zip(logged["port"], logged["jax"]):
        for key in ("train_loss", "val_loss", "best_val_loss", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert metrics["port"]["test_acc"] == metrics["jax"]["test_acc"]
    np.testing.assert_allclose(metrics["port"]["test_loss"], metrics["jax"]["test_loss"],
                               rtol=1e-4)
    port_dir, jax_dir = (root / f"results_{p}" / "models" for p in ("port", "jax"))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    best, ref = (load_state_dict(str(d / "best_model.pt")) for d in (port_dir, jax_dir))
    init = load_state_dict(str(port_dir / "initial_model.pt"))
    assert changed_frozen(state.model, init) == []  # the model itself, not only its checkpoints
    assert sorted(best) == sorted(ref)
    for name in ref:
        np.testing.assert_allclose(best[name].numpy(), ref[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)
        if name.split(".", 1)[0] != "projector" and "embed_tokens" not in name:
            assert torch.equal(best[name], init[name]), name  # frozen: bitwise
    saved = torch.load(str(port_dir / "best_model.pt"), weights_only=True)
    assert all(t.dtype == torch.float32 for t in saved.values())


def test_changed_frozen_sees_writes_to_frozen_parameters_only():
    """changed_frozen compares frozen parameters with the reference cast to
    their storage dtype: bf16 storage of the same values passes, one changed
    element fails, a trained parameter is never reported."""
    from torch import nn

    from multimodal_concept_learning_tpu_torch.checkpoint import changed_frozen, host_state_dict
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute

    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 2))
    model[0].requires_grad_(False)
    reference = host_state_dict(model)
    cast_for_compute(model, torch.bfloat16, only_frozen=True)
    assert model[0].weight.dtype == torch.bfloat16 and model[1].weight.dtype == torch.float32
    assert changed_frozen(model, reference) == []
    with torch.no_grad():
        model[1].weight.add_(1.0)
        assert changed_frozen(model, reference) == []
        model[0].bias[1] += 0.5
    assert changed_frozen(model, reference) == ["0.bias"]
