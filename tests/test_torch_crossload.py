"""PyTorch port: a results dir written by the port's trainer CLI (bf16
compute on the CPU) loads into the JAX package with exactly its keys, and
the JAX analysis CLI runs on it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_trainer import _config, _tokenizer, dataset  # noqa: F401  (fixture)


def test_port_results_dir_loads_into_jax(dataset, tmp_path, capsys):
    """The port's CLI on the CPU writes the reference layout; the JAX
    package reads it with exactly its own keys and runs the analysis CLI."""
    from multimodal_concept_learning_tpu.analysis.token_embedding_analysis import (
        main as analysis_main,
    )
    from multimodal_concept_learning_tpu.checkpoint import load_torch_state_dict
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        mllm_params_from_torch,
        mllm_params_to_torch,
    )
    from multimodal_concept_learning_tpu.models.mllm import MLLM as JaxMLLM
    from multimodal_concept_learning_tpu.models.mllm import MLLMConfig
    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main

    _, data_dir, mapping = dataset
    results = str(tmp_path / "results")
    cfg_path = tmp_path / "cfg.yaml"
    lines = [f"{k}: {json.dumps(v)}" for k, v in _config(data_dir, mapping, results,
                                                          epochs=2).items()]
    cfg_path.write_text("\n".join(lines) + "\n")
    assert miniyaml.safe_load(cfg_path.read_text())["epochs"] == 2
    _, metrics, history = main(["--config_path", str(cfg_path), "--device", "cpu"])
    assert np.isfinite(metrics["test_loss"]) and 0.0 <= metrics["test_acc"] <= 100.0
    assert [m["epoch"] for m in history] == [1, 2]
    out = capsys.readouterr().out
    for line in ("Trainable params setting: language_embed_only", "Epoch 2/2 completed in",
                 "Best Val Loss:", "FINAL EVALUATION ON VALIDATION SET", "Test Accuracy:"):
        assert line in out

    models = os.path.join(results, "models")
    jcfg = MLLMConfig.create(vocab_size=len(_tokenizer()), vision_preset="vit-t-8",
                             lm_preset="nano", num_vision_tokens=17, image_size=32)
    template = jax.jit(JaxMLLM(jcfg).init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                           jnp.zeros((1, 21), jnp.int32),
                                           jnp.ones((1, 21), jnp.int32))
    expected_keys = sorted(mllm_params_to_torch(template, patch_size=8))
    for name in ("initial_model.pt", "best_model.pt", "epoch_0_model.pt", "epoch_1_model.pt"):
        sd = load_torch_state_dict(os.path.join(models, name))
        assert sorted(sd) == expected_keys, name
        back = mllm_params_to_torch(mllm_params_from_torch(sd, template, patch_size=8),
                                    patch_size=8)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    init, best = (load_torch_state_dict(os.path.join(models, n))
                  for n in ("initial_model.pt", "best_model.pt"))
    emb = init["language_model.model.embed_tokens.weight"]
    np.testing.assert_array_equal(emb[-2:], emb[:2])  # the OOD rows' copy-init
    assert not np.array_equal(best["language_model.model.embed_tokens.weight"], emb)
    np.testing.assert_array_equal(best["vision_model.layernorm.weight"],
                                  init["vision_model.layernorm.weight"])

    corr = analysis_main(["--results_dir", results, "--output_dir", str(tmp_path / "plots")])
    assert np.isfinite(corr)
