"""PyTorch port: the MLLM trainer and the ImageNet analysis on ImageNet
data (CPU).

On the synthetic tree of ``test_torch_imagenet_train.py`` (its ``data``
fixture), with random train pipelines decoded and transformed by each
package and the same initial weights:

- the MLLM's ``run_training`` (vit-t-8 + nano, 32 px,
  ``imagenet_multimodal`` with a wnid-keyed labels mapping and ``<ood_*>``
  tokens): per-epoch losses within 1e-4 relative, the same test accuracy,
  the same results layout;
- the port's ImageNet analysis CLI prints the JAX CLI's lines on the port
  run's checkpoints, with the same palette and ancestor colouring.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as tp
from multimodal_concept_learning_tpu.utils.logging import MetricsLogger
from test_torch_imagenet_train import (  # noqa: F401  (data: a fixture)
    MAPPING,
    SMALL_TRAIN,
    SMALL_VAL,
    _loader_cls,
    _splits,
    data,
)


def _mllm_config(cls, tree, train_csv, labels, results_dir):
    return cls.from_params({
        "mapping_path": train_csv, "image_root": tree, "labels_mapping_path": labels,
        "prompt_template": "Is a {class_name} in the image?",
        "dataset_name": "imagenet_multimodal", "vision_model_name": "vit-t-8",
        "language_model_name": "nano", "num_vision_tokens": 17, "image_size": 32,
        "trainable_params_setting": "language_embed_only", "epochs": 2, "batch_size": 4,
        "effective_batch_size": 8, "learning_rate": 5e-4, "save_every_epoch": True,
        "results_dir": results_dir, "seed": 0, "num_workers": 3, "use_wandb": False,
        "train_transforms": SMALL_TRAIN, "val_transforms": SMALL_VAL})


@pytest.fixture(scope="module")
def mllm_runs(data, tmp_path_factory):
    """Both packages' MLLM ``run_training`` from the same weights:
    {pkg: (per-epoch logs, test metrics, results dir)}."""
    from multimodal_concept_learning_tpu.configs import MultimodalTrainingConfig as JConfig
    from multimodal_concept_learning_tpu.data import MultimodalCollator as JCollator
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu.models.mllm import copy_init_ood_rows as jcopy
    from multimodal_concept_learning_tpu.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu.train.common import mesh_for_batch
    from multimodal_concept_learning_tpu.train.multimodal_training import run_training as jrun
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import run_training

    tree, mapping_dir, labels = data
    root = tmp_path_factory.mktemp("mllm")
    ood = [v for v in MAPPING.values() if v.startswith("<ood")]
    tok = load_tokenizer("nano")
    tok.add_tokens(ood)
    jcfg = tp.jax_config(vocab=len(tok), image_size=32)
    jmodel = JaxMLLM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                  jnp.zeros((1, 21), jnp.int32), jnp.ones((1, 21), jnp.int32))
    params = jcopy(params, len(ood))["params"]
    runs = {}
    mp = pytest.MonkeyPatch()
    for pkg in ("jax", "port"):
        results = str(root / f"results_{pkg}")
        config = _mllm_config(JConfig if pkg == "jax" else MultimodalTrainingConfig, tree,
                              os.path.join(mapping_dir, "train_mapping.csv"), labels, results)
        splits = _splits(pkg, config, True, mapping_dir, tree)
        collator = (JCollator if pkg == "jax" else MultimodalCollator)(
            tok, config.num_vision_tokens, config.prompt_template, splits[0].unique_labels,
            MAPPING, seed=config.seed)
        loader, kw = _loader_cls(pkg), dict(collate_fn=collator, num_workers=3)
        loaders = (loader(splits[0], config.batch_size, shuffle=True, drop_last=True,
                          seed=config.seed, **kw),
                   loader(splits[1], config.batch_size, **kw),
                   loader(splits[2], config.batch_size, **kw))
        with contextlib.redirect_stdout(io.StringIO()):
            if pkg == "jax":
                logged = []
                mp.setattr(MetricsLogger, "log", lambda self, m: logged.append(dict(m)))
                _, metrics = jrun(jmodel, tok, params, *loaders, config,
                                  mesh_for_batch(config.batch_size), jax.random.key(1))
                mp.undo()
            else:
                port = MLLM(tp.port_config(jcfg))
                port.load_state_dict(state_dict_from_jax(
                    jax.tree_util.tree_map(np.asarray, params), 8), strict=True)
                _, metrics, logged = run_training(port, tok, *loaders, config)
        runs[pkg] = (logged, metrics, results)
    return runs


def test_mllm_run_training_matches_jax(mllm_runs):
    (plog, pmet, pdir), (jlog, jmet, jdir) = mllm_runs["port"], mllm_runs["jax"]
    assert len(plog) == len(jlog) == 2
    for got, want in zip(plog, jlog):
        for key in ("train_loss", "val_loss", "best_val_loss", "learning_rate"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert pmet["test_acc"] == jmet["test_acc"]
    np.testing.assert_allclose(pmet["test_loss"], jmet["test_loss"], rtol=1e-4)
    assert sorted(os.listdir(os.path.join(pdir, "models"))) == sorted(
        os.listdir(os.path.join(jdir, "models")))


def test_imagenet_analysis_cli_matches_jax(mllm_runs, data, tmp_path):
    """Both analysis CLIs on the port's run: the same printed lines (the
    figure files aside; the port's line saying figures were skipped appears
    only without matplotlib) and the same ancestor colouring."""
    import multimodal_concept_learning_tpu.analysis.token_embedding_analysis_imagenet as J
    import multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis_imagenet as P

    tree, _, _ = data
    results = mllm_runs["port"][2]
    texts = {}
    for pkg, mod in (("port", P), ("jax", J)):
        out = tmp_path / pkg
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--results_dir", results, "--data_dir", tree, "--parent_level", "1",
                      "--output_dir", str(out)])
        texts[pkg] = [line.replace(str(out), "OUT") for line in buf.getvalue().splitlines()
                      if not line.lstrip().startswith(("Saved", "Skipping"))]
    assert texts["port"] == texts["jax"]
    assert "OOD tokens selected: 2" in texts["port"] and "Analysis complete." in texts["port"]
    assert P.build_palette() == J.build_palette()
    hierarchy = (P.WordNetHierarchy(tree), J.WordNetHierarchy(tree))
    tokens = list(MAPPING.values())
    to_wnid = {v: k for k, v in MAPPING.items()}
    got, want = (mod.color_tokens_by_ancestor(h, tokens, to_wnid, 1)
                 for mod, h in zip((P, J), hierarchy))
    assert got == want
    assert set(got[1].values()) == {"n00000002", "n00000003"}

