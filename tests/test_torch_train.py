"""PyTorch port: losses, schedules and the optimizer vs the JAX package (CPU).

Tolerances (float32): losses and their gradients 1e-6 abs; the optimizer
alone vs optax on fixed gradients 1e-6 abs (bf16-stored parameters: one
bf16 rounding step, 2^-7 relative).  The model-level train/eval steps are
in ``test_torch_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu.ops import losses as jlosses
from multimodal_concept_learning_tpu_torch.ops import losses as tlosses

LOSS_ATOL = 1e-6


def _labels_batch(seed=0, b=4, t=12, a=3):
    """Labels with IGNORE_INDEX except short answer spans: row 0 has more
    than A supervised tokens, row 2 fewer, row 3 none."""
    rng = np.random.default_rng(seed)
    labels = np.full((b, t), -100, np.int32)
    labels[0, 2:2 + a + 2] = rng.integers(0, 16, a + 2)
    labels[1, 5:5 + a] = rng.integers(0, 16, a)
    labels[2, 9] = rng.integers(0, 16)
    return labels


def test_gather_supervised_positions_match_jax():
    labels = _labels_batch()
    shifted_j = jlosses.shift_labels(jnp.asarray(labels))
    shifted_t = tlosses.shift_labels(torch.from_numpy(labels))
    np.testing.assert_array_equal(shifted_t.numpy(), np.asarray(shifted_j))
    for a in (1, 3, 6):
        pj, vj = jlosses.gather_supervised_positions(shifted_j, a)
        pt, vt = tlosses.gather_supervised_positions(shifted_t, a)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("row_valid", [None, [True, True, False, True]])
def test_sparse_and_dense_losses_and_grads_match_jax(row_valid):
    """Loss values and gradients w.r.t. the hidden states and the head."""
    rng = np.random.default_rng(1)
    labels = _labels_batch()
    hidden = rng.standard_normal((4, 12, 8)).astype(np.float32)
    head = rng.standard_normal((8, 16)).astype(np.float32)
    rv = None if row_valid is None else np.asarray(row_valid)

    def jsparse(h, w):
        out = jlosses.sparse_answer_cross_entropy(
            h, jnp.asarray(labels), lambda x: x @ w, max_positions=3,
            row_valid=None if rv is None else jnp.asarray(rv))
        return out[0], out[1:]

    def jdense(h, w):
        return jlosses.dense_causal_lm_cross_entropy(h, jnp.asarray(labels), lambda x: x @ w)

    (jl, (jlog, jpos, jval)), jg = jax.value_and_grad(jsparse, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(head))
    jdl, jdg = jax.value_and_grad(jdense, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))

    th, tw = torch.tensor(hidden, requires_grad=True), torch.tensor(head, requires_grad=True)
    tl, tlog, tpos, tval = tlosses.sparse_answer_cross_entropy(
        th, torch.from_numpy(labels), lambda x: x @ tw, max_positions=3,
        row_valid=None if rv is None else torch.from_numpy(rv))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    for got, want in zip((th.grad, tw.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_ATOL, rtol=0)

    th.grad, tw.grad = None, None
    tdl = tlosses.dense_causal_lm_cross_entropy(th, torch.from_numpy(labels), lambda x: x @ tw)
    tdl.backward()
    np.testing.assert_allclose(tdl.item(), float(jdl), atol=LOSS_ATOL, rtol=0)
    for got, want in zip((th.grad, tw.grad), jdg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOSS_ATOL, rtol=0)


@pytest.mark.parametrize("smoothing,valid", [(0.0, None), (0.1, [True, False, True])])
def test_cross_entropy_loss_matches_jax(smoothing, valid):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5)).astype(np.float32)
    labels = np.asarray([0, 4, 2], np.int32)
    vj = None if valid is None else jnp.asarray(valid)
    vt = None if valid is None else torch.tensor(valid)
    ref = jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing, vj)
    out = tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     smoothing, vt)
    np.testing.assert_allclose(out.item(), float(ref), atol=LOSS_ATOL, rtol=0)


def test_schedules_match_jax():
    from multimodal_concept_learning_tpu.parallel import optimizer as jopt
    from multimodal_concept_learning_tpu_torch.parallel import optimizer as topt

    for make in ("linear_warmup_schedule", "cosine_epoch_schedule"):
        args = (5e-4, 3, 10) if make == "linear_warmup_schedule" else (5e-4, 4, 3)
        js, ts = getattr(jopt, make)(*args), getattr(topt, make)(*args)
        for count in range(15):
            np.testing.assert_allclose(ts(count), float(js(jnp.asarray(count))), rtol=1e-6)


@pytest.mark.parametrize("fp32_master,schedule", [(False, False), (False, True), (True, False)])
def test_optimizer_matches_optax(fp32_master, schedule):
    """Optimizer alone on fixed gradients == the JAX build_optimizer (optax
    MultiSteps over clip + AdamW, masked), lr 1e-2, weight decay 0.1, a clip
    that triggers, accumulation 2, four micro-steps (two updates); 1e-6 abs
    (bf16-stored parameters: the float32 masters at 1e-6, the parameters
    their exact bf16 rounding)."""
    import optax

    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.optimizer import linear_warmup_schedule as jsch
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import Optimizer
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import linear_warmup_schedule

    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (7,), "frozen": (4,)}
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (3 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
             for _ in range(4)]
    lr = (jsch(1e-2, 1, 4), linear_warmup_schedule(1e-2, 1, 4)) if schedule else (1e-2, 1e-2)
    hp = dict(weight_decay=0.1, max_grad_norm=0.5, accumulation_steps=2)
    mask = {"a": True, "b": True, "frozen": False}
    dtype = jnp.bfloat16 if fp32_master else jnp.float32
    jparams = {n: jnp.asarray(v).astype(dtype) for n, v in p0.items()}
    tx = jbuild(lr[0], trainable_mask=mask, fp32_master=fp32_master, **hp)
    jstate = tx.init(jparams)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(np.asarray(v.astype(jnp.float32)))
                                     .to(torch.bfloat16 if fp32_master else torch.float32))
               for n, v in jparams.items() if mask[n]}
    opt = Optimizer(tparams, lr[1], fp32_master=fp32_master, **hp)
    for g in grads:
        jg = {n: jnp.asarray(v).astype(dtype) for n, v in g.items()}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, t in tparams.items():
            t.grad = torch.from_numpy(g[n]).to(t.dtype)
        opt.step()
        for n, t in tparams.items():
            ref = np.asarray(jparams[n].astype(jnp.float32))
            got = t.detach().float().numpy()
            if fp32_master:  # the bf16 parameter is the rounding of its float32 master
                assert torch.equal(t.detach(), opt.master[n].to(torch.bfloat16)), n
                np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0, err_msg=n)
            else:
                np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0, err_msg=n)
    assert opt.count == 2 and not np.array_equal(np.asarray(jparams["a"], np.float32), p0["a"])
    np.testing.assert_array_equal(np.asarray(jparams["frozen"].astype(jnp.float32)),
                                  np.asarray(jnp.asarray(p0["frozen"]).astype(dtype)
                                             .astype(jnp.float32)))
