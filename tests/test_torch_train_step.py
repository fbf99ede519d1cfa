"""PyTorch port: the MLLM train and eval steps vs the JAX package (CPU).

Tolerances (float32 compute): three micro-steps of the train step
(accumulation 2, clipping, weight decay, lr 1e-4) 1e-5 abs on losses and
trained parameters, a tenth of one update; with bf16-stored parameters
also on the float32 master weights of both optimizers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

STEP_ATOL = 1e-5
# Adam's first update is ~lr * g/|g| per element, so an element whose
# gradient nearly cancels moves by a different fraction of lr under another
# summation order (seen: up to ~5% of a step).  The model-level step test
# runs at lr 1e-4, where that stays inside STEP_ATOL while a wrong update is
# off by a whole step; the optimizer alone is held to optax at a large lr
# and weight decay on fixed gradients (test_optimizer_matches_optax).
LR = 1e-4


# -- train / eval steps ---------------------------------------------------------


@pytest.fixture(scope="module")
def gemma_pair():
    return tp.make_pair(tp.GEMMA_SMALL)


def _batches(cfg, n=3):
    out = []
    for i in range(n):
        images, ids, mask = tp.prompt_batch(cfg, [5, 2, 7], seed=10 + i)
        labels = np.full_like(ids, -100)
        for r, m in enumerate(mask.sum(axis=1)):
            labels[r, m - 2:m] = ids[r, m - 2:m]  # a two-token answer at each row's end
        out.append({"images": images, "input_ids": ids, "attention_mask": mask,
                    "labels": labels, "valid": np.asarray([True, True, r != 2])})
    return out


def _jax_masters(opt_state, params):
    """The float32 master weights that ``with_fp32_master`` keeps in the JAX
    optimizer state, as {state-dict name: array} (zeros for frozen leaves,
    which have no master)."""
    import optax

    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.parallel.optimizer import MasterState

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, MasterState)) if isinstance(s, MasterState)]
    assert len(found) == 1
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    full = jax.tree_util.tree_map(lambda m, p: np.zeros(p.shape, np.float32) if masked(m)
                                  else np.asarray(m, np.float32), found[0].master, params,
                                  is_leaf=masked)
    return mllm_params_to_torch(full, patch_size=8)


def _port_params(port):
    return {n: p.detach().float().numpy().copy() for n, p in port.named_parameters()}


@pytest.mark.parametrize("setting,bf16_params", [
    ("language_embed_only", False), ("language_only", False), ("language_embed_only", True),
])
def test_three_micro_steps_match_jax(gemma_pair, setting, bf16_params):
    """Three make_mllm_train_step micro-steps with accumulation 2 (one
    AdamW update, then one accumulated micro-step), clipping and weight
    decay: the same losses and trained parameters as the JAX step; frozen
    parameters untouched."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.parallel.train_step import cast_params_bf16
    from multimodal_concept_learning_tpu.parallel.train_step import (
        make_mllm_train_step as jstep_fn,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    model, params, _ = gemma_pair
    hp = dict(weight_decay=1e-2, max_grad_norm=1.0, accumulation_steps=2)
    params = jax.tree_util.tree_map(jnp.asarray, params["params"])
    tx = jbuild(LR, trainable_mask=jmask(params, setting), fp32_master=bf16_params, **hp)
    if bf16_params:
        params = cast_params_bf16(params)
    jstate = JState.create(params, tx)
    jstep = jstep_fn(model, tx)

    port = build_mllm(tp.port_config(model.config),
                      state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), 8), "cpu")
    mask = trainable_mask(port, setting)
    if bf16_params:
        for p in port.parameters():
            p.data = p.data.to(torch.bfloat16)
    before = _port_params(port)
    state = TrainState(model=port, optimizer=build_optimizer(port, LR,
                                                             fp32_master=bf16_params, **hp))
    step = make_mllm_train_step(port)
    for i, batch in enumerate(_batches(model.config)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))  # with kv_lens, as the trainer runs
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=STEP_ATOL, rtol=0)
    assert state.step == 3 and state.optimizer.count == 1 and state.optimizer.mini_step == 1
    ref = mllm_params_to_torch(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jstate.params), patch_size=8)
    after = _port_params(port)
    for name, trained in mask.items():
        if not trained:
            np.testing.assert_array_equal(after[name], before[name], err_msg=name)
        else:
            np.testing.assert_allclose(after[name], ref[name], atol=STEP_ATOL, rtol=0,
                                       err_msg=name)
    if bf16_params:  # the float32 masters AdamW updated, against the JAX optimizer's
        masters = _jax_masters(jstate.opt_state, params)
        assert sorted(state.optimizer.master) == sorted(n for n, t in mask.items() if t)
        for name, master in state.optimizer.master.items():
            np.testing.assert_allclose(master.numpy(), masters[name], atol=STEP_ATOL, rtol=0,
                                       err_msg=name)
    assert any(not np.array_equal(after[n], before[n]) for n, t in mask.items() if t)


def test_eval_step_matches_jax(gemma_pair):
    from multimodal_concept_learning_tpu.parallel.train_step import (
        make_mllm_eval_step as jeval_fn,
    )
    from multimodal_concept_learning_tpu_torch.parallel.train_step import make_mllm_eval_step

    model, params, port = gemma_pair
    batch = _batches(model.config, 1)[0]
    ref = jeval_fn(model)(params["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    out = make_mllm_eval_step(port)(port, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), atol=STEP_ATOL, rtol=0)
    for key in ("pred_ids", "target_ids", "valid"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_uint8_images_normalise_on_the_device():
    """images_u8 + norm_mean/std == the JAX device_preprocess, NCHW."""
    from multimodal_concept_learning_tpu.ops.preprocess import images_from_batch as jimages
    from multimodal_concept_learning_tpu_torch.ops.preprocess import (
        batch_channels_last,
        images_from_batch,
    )

    rng = np.random.default_rng(3)
    batch = {"images_u8": rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
             "norm_mean": np.asarray([0.5, 0.4, 0.3], np.float32),
             "norm_std": np.asarray([0.2, 0.25, 0.3], np.float32)}
    ref = jimages({k: jnp.asarray(v) for k, v in batch.items()})
    out = images_from_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert batch_channels_last(batch) and out.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_bf16_storage_keeps_float32_masters(gemma_pair):
    """fp32_master: AdamW updates float32 copies; the bf16 parameters are
    their rounding after every update."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    model, params, _ = gemma_pair
    port = build_mllm(tp.port_config(model.config), state_dict_from_jax(params, 8), "cpu")
    trainable_mask(port, "language_embed_only")
    for p in port.parameters():
        p.data = p.data.to(torch.bfloat16)
    opt = build_optimizer(port, 5e-3, weight_decay=0.0, fp32_master=True)
    state = TrainState(model=port, optimizer=opt)
    make_mllm_train_step(port)(state, {k: torch.from_numpy(v)
                                       for k, v in _batches(model.config, 1)[0].items()})
    for name, master in opt.master.items():
        assert master.dtype == torch.float32
        assert torch.equal(opt.params[name], master.to(torch.bfloat16)), name
