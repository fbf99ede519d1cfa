"""PyTorch port: LoRA (``ops/lora.py``, ``language_lora`` training, merged
serving) vs the JAX package (CPU).

The same seeded weights (``tests/_torch_parity.py``: a small
Gemma-3-shaped LM with rank-4 adapters, every leaf perturbed so the ``b``
factors are nonzero) go through both packages.  Tolerances: one adapter
in float32 1e-5 abs, in bf16 within 1e-2 of its largest |value| (JAX and
ATen round the bf16 products apart); the merged weights 1e-6 abs and the
merged forward within 1e-5 of the adapter forward (as the JAX test); whole
hidden states 1e-4 abs; a fresh adapter bitwise the identity; three
``language_lora`` micro-steps 1e-5 abs on losses and trained tensors, the
frozen ones bitwise unchanged; tokens exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

RANK = 4
ALPHA = 16.0
LR = 1e-4
STEP_ATOL = 1e-5


@pytest.fixture(scope="module")
def lora_pair():
    return tp.make_pair(dict(tp.GEMMA_SMALL, lora_rank=RANK), seed=3)


@pytest.mark.parametrize("dtype,alpha,rank", [("float32", 16.0, 4), ("bfloat16", 16.0, 4),
                                              ("bfloat16", 5.0, 3)])
def test_adapter_matches_jax(dtype, alpha, rank):
    """``LoRAAdapter`` with JAX's factors: x, x @ a and (x @ a) @ b rounded
    to the compute dtype, then the scale (5 / 3 is not a bf16 value: it is
    rounded first, as JAX rounds it)."""
    from multimodal_concept_learning_tpu.ops.lora import LoRAAdapter as JaxLoRA
    from multimodal_concept_learning_tpu_torch.ops.lora import LoRAAdapter

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    a = (0.2 * rng.standard_normal((48, rank))).astype(np.float32)
    b = (0.2 * rng.standard_normal((rank, 40))).astype(np.float32)
    want = JaxLoRA(features=40, rank=rank, alpha=alpha, dtype=getattr(jnp, dtype)).apply(
        {"params": {"a": a, "b": b}}, jnp.asarray(x))
    want = np.asarray(want, np.float32)
    port = LoRAAdapter(48, 40, rank, alpha, getattr(torch, dtype))
    port.load_state_dict({"a": torch.from_numpy(a), "b": torch.from_numpy(b)})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 5, 40)
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_fresh_adapter_is_the_identity():
    """``init_random_weights_``: a normal(0.02), b zero, so the LoRA model's
    hidden states are bitwise those of the same weights without adapters."""
    import dataclasses

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM

    cfg = tp.port_config(tp.jax_config(dict(tp.GEMMA_SMALL, lora_rank=RANK)))
    model = init_random_weights_(MLLM(cfg), torch.Generator().manual_seed(0))
    sd = model.state_dict()
    factors = {k: v for k, v in sd.items() if "_lora." in k}
    assert len(factors) == 2 * 7 * cfg.lm.num_layers
    assert all(v.std() > 0.01 if k.endswith(".a") else not v.any() for k, v in factors.items())
    base = MLLM(dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, lora_rank=0)))
    base.load_state_dict({k: v for k, v in sd.items() if k not in factors}, strict=True)
    batch = [torch.from_numpy(x) for x in tp.prompt_batch(cfg, [5, 2, 9])]
    with torch.no_grad():
        assert torch.equal(model(*batch)["hidden_states"], base(*batch)["hidden_states"])


def test_forward_and_merge_match_jax(lora_pair):
    """The LoRA forward (1e-4 of JAX's), ``merge_lora_params`` (1e-6 of
    JAX's merged weights, no ``*_lora`` entry left) and the merged forward
    in a rank-0 model (1e-5 of the adapter forward)."""
    import dataclasses

    from multimodal_concept_learning_tpu.ops.lora import merge_lora_params as jmerge
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params

    model, params, port = lora_pair
    batch = tp.prompt_batch(model.config, [5, 2, 9])
    want = jax.jit(lambda p, *a: model.apply(p, *a)["hidden_states"])(
        params, *map(jnp.asarray, batch))
    with torch.no_grad():
        lora_out = port(*map(torch.from_numpy, batch))["hidden_states"]
    np.testing.assert_allclose(lora_out.numpy(), np.asarray(want), atol=1e-4, rtol=0)

    merged = merge_lora_params(port.state_dict(), alpha=ALPHA)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmerge(params, ALPHA)), 8)
    assert sorted(merged) == sorted(ref) and not any("_lora" in k for k in merged)
    for name, t in ref.items():
        np.testing.assert_allclose(merged[name].numpy(), t.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
    cfg = dataclasses.replace(port.cfg, lm=dataclasses.replace(port.cfg.lm, lora_rank=0))
    with torch.no_grad():
        merged_out = build_mllm(cfg, merged, "cpu")(*map(torch.from_numpy, batch))
    np.testing.assert_allclose(merged_out["hidden_states"].numpy(), lora_out.numpy(),
                               atol=1e-5, rtol=1e-5)


def test_merge_refuses_quantized_weights(lora_pair):
    """An int8 tree is not merged: both packages refuse with one message."""
    from multimodal_concept_learning_tpu.ops.lora import merge_lora_params as jmerge
    from multimodal_concept_learning_tpu.ops.quant import quantize_mllm_params as jquant
    from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params
    from multimodal_concept_learning_tpu_torch.ops.quant import quantize_mllm_params

    model, params, port = lora_pair
    with pytest.raises(AssertionError) as jax_err:
        jmerge(jquant(jax.tree_util.tree_map(jnp.asarray, params), model.config, vision=False),
               ALPHA)
    with pytest.raises(ValueError) as err:
        merge_lora_params(quantize_mllm_params(port.state_dict(), vision=False), ALPHA)
    assert str(err.value) == str(jax_err.value)
    assert str(err.value) == "cannot merge LoRA into non-float kernel down_proj"


def _jax_mask_by_name(params, setting):
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask

    leaves = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                    jmask(params, setting), params)
    return {k: bool(v.all()) for k, v in mllm_params_to_torch(leaves, patch_size=8).items()}


def test_language_lora_mask_matches_jax(lora_pair):
    """The projector and the LM's 28 factors train, nothing else."""
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask

    model, params, port = lora_pair
    try:
        mask = trainable_mask(port, "language_lora")
        assert mask == _jax_mask_by_name(params, "language_lora")
        assert sum(mask.values()) == 2 + 2 * 7 * port.cfg.lm.num_layers
        assert all(p.requires_grad == mask[n] for n, p in port.named_parameters())
    finally:
        for p in port.parameters():
            p.requires_grad_(True)


def test_pt_cross_loads_both_ways(lora_pair, tmp_path):
    """A JAX LoRA tree's reference ``.pt`` loads strict into the port, and
    the port's ``.pt`` loads into the JAX tree leaf for leaf."""
    from multimodal_concept_learning_tpu.checkpoint import (
        load_torch_state_dict,
        mllm_params_from_torch,
    )
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        build_mllm,
        load_state_dict,
        save_state_dict,
    )

    model, params, port = lora_pair
    jax_pt = tmp_path / "jax.pt"
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32).copy())
                for k, v in mllm_params_to_torch(params, patch_size=8).items()}, jax_pt)
    loaded = build_mllm(port.cfg, load_state_dict(str(jax_pt)), "cpu")  # strict
    for name, t in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[name], t), name
    port_pt = tmp_path / "port.pt"
    save_state_dict(port.state_dict(), str(port_pt))
    back = mllm_params_from_torch(load_torch_state_dict(str(port_pt)), params, patch_size=8)
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back),
                                      jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))


def _batches(cfg, n=3):
    out = []
    for i in range(n):
        images, ids, mask = tp.prompt_batch(cfg, [5, 2, 7], seed=20 + i)
        labels = np.full_like(ids, -100)
        for r, m in enumerate(mask.sum(axis=1)):
            labels[r, m - 2:m] = ids[r, m - 2:m]
        out.append({"images": images, "input_ids": ids, "attention_mask": mask,
                    "labels": labels, "valid": np.ones(3, bool)})
    return out


def test_three_micro_steps_match_jax(lora_pair):
    """Three ``language_lora`` micro-steps (accumulation 2, clipping, weight
    decay) as the trainer sets them up: frozen linear weights stored in the
    compute dtype once, float32 factors and projector under AdamW.  The
    JAX step's losses and trained tensors; frozen tensors bitwise
    unchanged; every factor moved."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.parallel.train_step import (
        make_mllm_train_step as jstep_fn,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    model, params, _ = lora_pair
    hp = dict(weight_decay=1e-2, max_grad_norm=1.0, accumulation_steps=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params["params"])
    tx = jbuild(LR, trainable_mask=jmask(jparams, "language_lora"), **hp)
    jstate, jstep = JState.create(jparams, tx), jstep_fn(model, tx)

    port = build_mllm(tp.port_config(model.config), state_dict_from_jax(params, 8), "cpu")
    mask = trainable_mask(port, "language_lora")
    state = TrainState(model=port, optimizer=build_optimizer(port, LR, **hp))
    cast_for_compute(port, port.cfg.dtype, only_frozen=True)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    step = make_mllm_train_step(port)
    for batch in _batches(model.config):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=STEP_ATOL, rtol=0)
    assert state.optimizer.count == 1 and sorted(state.optimizer.params) == sorted(
        n for n, t in mask.items() if t)
    ref = mllm_params_to_torch(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jstate.params), patch_size=8)
    for name, p in port.named_parameters():
        if mask[name]:
            assert p.dtype == torch.float32 and not torch.equal(p, before[name]), name
            np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=STEP_ATOL, rtol=0,
                                       err_msg=name)
        else:
            assert torch.equal(p, before[name]), name


# -- the trainer CLI of both packages ------------------------------------------------


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One epoch of ``language_lora`` (rank 4) through each package's
    trainer CLI on one tiny color dataset: {"port": results dir, "jax": ...}."""
    import yaml

    from multimodal_concept_learning_tpu.train.multimodal_training import main as jax_main
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main

    root = tmp_path_factory.mktemp("lora_cli")
    data_dir = generate_color_dataset(ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32, "colors": [[255, 0, 0], [0, 255, 0]],
        "radius_range": [4, 10], "n_images_per_color": 8, "data_dir": str(root), "seed": 0}),
        verbose=False)
    labels = root / "labels_mapping.json"
    labels.write_text(json.dumps({"r255g0b0": "red", "r0g255b0": "<ood 1>"}))
    runs = {}
    for pkg, run in (("port", lambda p: main(["--config_path", p, "--device", "cpu"])),
                     ("jax", lambda p: jax_main(["--config_path", p]))):
        cfg = dict(tp.LORA_CONFIG, mapping_path=os.path.join(data_dir, "train_mapping.csv"),
                   image_root=data_dir, labels_mapping_path=str(labels), epochs=1, batch_size=4,
                   effective_batch_size=4, learning_rate=5e-3, num_workers=1,
                   results_dir=str(root / f"results_{pkg}"))
        path = root / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        run(str(path))
        runs[pkg] = cfg["results_dir"]
    return runs


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_language_lora_cli(cli_runs, pkg):
    """Each package's run: factors in the reference ``.pt`` (some ``b``
    moved), the base LM bitwise that of ``initial_model.pt``; the other
    package loads the run (strict in the port).  The port serves it merged
    and unmerged with the same tokens, and the JAX engine answers as the
    port's for the same run (float32)."""
    from multimodal_concept_learning_tpu.serve.engine import ServingEngine as JaxEngine
    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    models = os.path.join(cli_runs[pkg], "models")
    initial, best = (load_state_dict(os.path.join(models, f)) for f in
                     ("initial_model.pt", "best_model.pt"))
    lora = [k for k in best if "_lora" in k]
    assert len(lora) == 2 * 7 * 2  # nano: 2 layers
    assert any(best[k].abs().max() > 0 for k in lora if k.endswith(".b"))
    for k in best:
        if k.startswith("language_model.") and "_lora" not in k:
            assert torch.equal(best[k], initial[k]), k

    kw = dict(batch_size=3, max_new_tokens=3, max_prompt_len=16)
    images, prompts = tp.SERVE_IMAGES[:3], tp.SERVE_PROMPTS[:3]
    tokens = {}
    for merge in (False, True):
        loaded = tp.port_serving_load(cli_runs[pkg], merge_lora=merge)
        assert (loaded.model.cfg.lm.lora_rank == 0) == merge
        tokens[merge] = ServingEngine(loaded, **kw).generate_tokens(images, prompts)
    np.testing.assert_array_equal(tokens[True], tokens[False])
    port_texts = ServingEngine(tp.port_serving_load(cli_runs[pkg]), **kw).generate(images,
                                                                                   prompts)
    assert JaxEngine(tp.jax_serving_load(cli_runs[pkg]), **kw).generate(images,
                                                                        prompts) == port_texts
