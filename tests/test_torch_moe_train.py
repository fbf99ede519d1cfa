"""PyTorch port: the MLLM train step under ``moe_experts`` vs the JAX
package (CPU, float32): three micro-steps with the 0.01 x mean aux term,
losses within 1e-5 before the first update and 1e-4 after it, the expert
and router weights within 1e-4.  Both dispatches; sparse at cf 1.0, which
drops assignments at these shapes.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

F32_TOL = 1e-5
HIDDEN_TOL = 1e-4
MOE = dict(moe_experts=4, moe_top_k=2)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def moe_pair(request):
    """(jax module, params, port MLLM) at GEMMA_SMALL with 4 experts, top-2;
    sparse at cf 1.0, which drops at these shapes."""
    lm = dict(tp.GEMMA_SMALL, **MOE, moe_dispatch=request.param,
              moe_capacity_factor=1.25 if request.param == "dense" else 1.0)
    return tp.make_pair(lm)


def _batches(cfg, n=3):
    out = []
    for i in range(n):
        images, ids, mask = tp.prompt_batch(cfg, [5, 2, 7], seed=10 + i)
        labels = np.full_like(ids, -100)
        for r, m in enumerate(mask.sum(axis=1)):
            labels[r, m - 2:m] = ids[r, m - 2:m]
        out.append({"images": images, "input_ids": ids, "attention_mask": mask,
                    "labels": labels, "valid": np.ones(3, bool)})
    return out


def test_three_micro_steps_with_aux_match_jax(moe_pair):
    """Three make_mllm_train_step micro-steps (language_only, accumulation
    2, clipping, weight decay): the losses with the 0.01 x mean aux term
    and the trained parameters, as the JAX step gives them."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.parallel.train_step import make_mllm_train_step as jfn
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    model, params, _ = moe_pair
    hp = dict(weight_decay=1e-2, max_grad_norm=1.0, accumulation_steps=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params["params"])
    tx = jbuild(1e-4, trainable_mask=jmask(jparams, "language_only"), **hp)
    jstate, jstep = JState.create(jparams, tx), jfn(model, tx)
    port = build_mllm(tp.port_config(model.config), state_dict_from_jax(params, 8), "cpu")
    trainable_mask(port, "language_only")
    state = TrainState(model=port, optimizer=build_optimizer(port, 1e-4, **hp))
    step = make_mllm_train_step(port)
    for i, batch in enumerate(_batches(model.config)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))
        tol = F32_TOL if i < 2 else HIDDEN_TOL  # the third follows the first update
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=tol, rtol=0)
    ref = mllm_params_to_torch(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                                      jstate.params), patch_size=8)
    for name, p in port.named_parameters():
        if ".moe." in name:
            np.testing.assert_allclose(p.detach().numpy(), ref[name], atol=HIDDEN_TOL, rtol=0,
                                       err_msg=name)


def test_aux_term_is_in_the_loss(moe_pair):
    """The step's loss is the answer CE plus 0.01 x the mean of the layers' aux."""
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux
    from multimodal_concept_learning_tpu_torch.parallel.train_step import MOE_AUX_COEF

    _, _, port = moe_pair
    batch = {k: torch.from_numpy(v) for k, v in _batches(port.cfg)[0].items()}
    rec = MoEAux()
    with torch.no_grad():
        out = port(batch["images"], batch["input_ids"], batch["attention_mask"],
                   batch["labels"], moe_aux=rec)
    assert MOE_AUX_COEF == 0.01 and len(rec.aux) == port.cfg.lm.num_layers
    assert all(a.item() > 0 for a in rec.aux) and out["loss"].item() > 0


def test_bench_script_runs_the_moe_cell(monkeypatch):
    """The port's bench_mllm at full width, one LM layer, one step (CPU):
    router stats before and after, images/s in its JSON record."""
    from multimodal_concept_learning_tpu_torch.scripts import bench_mllm

    create = bench_mllm.MLLMConfig.create

    def one_lm_layer(**kwargs):
        cfg = create(**kwargs)
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=1))

    monkeypatch.setattr(bench_mllm, "MLLMConfig", types.SimpleNamespace(create=one_lm_layer))
    monkeypatch.setattr(bench_mllm, "INNER", 1)
    monkeypatch.setattr(bench_mllm, "REPEATS", 1)
    rec = bench_mllm.run(["--batch", "1", "--ood", "4", "--moe_experts",
                          "4", "--moe_dispatch", "sparse", "--moe_stats", "--device", "cpu"])
    for key in ("router_stats_pre", "router_stats_post"):
        st = rec[key]
        assert 0.0 <= st["drop_frac"] <= 1.0 and len(st["load_frac"]) == 4
        assert st["capacity"] == 152  # ceil(2 * 237 * 1.25 / 4) = 149, rounded up to 8
    assert rec["value"] > 0 and np.isfinite(rec["loss"])
