"""PyTorch port: the vision classifier, its train and eval steps and
dropout, against the JAX package (CPU).  The trainer CLI and the MLLM's
``vision_path`` warm start: ``test_torch_vision_cli.py``.

A vit-t-8-like classifier (hidden 64, 4 heads, patch 8, 64x64 images, 2
layers, 5 classes) with seeded, perturbed JAX weights carried across by
``vit_classifier_state_dict_from_jax``.  Tolerances: logits float32 1e-4
abs, bf16 2e-2 of the reference's max |logit|, in the ``bthd``, ``bhtd``
and ``qkv_fused`` layouts; three train micro-steps (accumulation 2,
dropout 0, lr 1e-4) 1e-5 abs on losses and parameters, as
``test_torch_train_step.py`` holds the MLLM's.  Dropout is held to its
semantics (keep rate within 4 sigma, kept values exactly ``x / keep_prob``,
a seed reproduces its masks bitwise, rate 0 and deterministic calls draw
nothing) and, given JAX's own keep mask, the dense attention branch to
JAX's (the two random streams differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

DIMS = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            patch_size=8, image_size=64, num_labels=5)
STEP_ATOL = 1e-5
LR = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    """Seeded, perturbed numpy params of the JAX classifier (the same tree
    in every layout and dtype)."""
    params = jax.jit(_jax_model().init)(jax.random.key(0), jnp.zeros((1, 3, 64, 64)))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params)


def _jax_model(layout="bthd", dtype=jnp.float32, **over):
    from multimodal_concept_learning_tpu.models.vit import ViTConfig, ViTForImageClassification

    return ViTForImageClassification(ViTConfig(**dict(DIMS, **over), dtype=dtype,
                                               attention_layout=layout))


def _port(params, layout="bthd", dtype=torch.float32, **over):
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )

    model = ViTForImageClassification(ViTConfig(**dict(DIMS, **over), dtype=dtype,
                                                attention_layout=layout))
    model.load_state_dict(vit_classifier_state_dict_from_jax(params, DIMS["patch_size"]),
                          strict=True)
    return model


def _images(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("layout", ["bthd", "bhtd", "qkv_fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_logits_match_jax(jax_params, layout, dtype):
    params = jax_params
    x = _images(3)
    ref = np.asarray(_jax_model(layout, getattr(jnp, dtype)).apply(params, jnp.asarray(x)))
    port = _port(params, layout, getattr(torch, dtype))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (3, DIMS["num_labels"])
    limit = 1e-4 if dtype == "float32" else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=limit, rtol=0)


def _batches(n=3, b=4):
    rng = np.random.default_rng(7)
    return [{"images": _images(b, seed=20 + i),
             "labels": rng.integers(0, DIMS["num_labels"], b).astype(np.int32),
             "valid": np.ones(b, bool)} for i in range(n)]


@pytest.mark.parametrize("bf16_params", [False, True])
def test_three_micro_steps_match_jax(jax_params, bf16_params):
    """Three classifier micro-steps with accumulation 2 (one AdamW update,
    then one accumulated micro-step), clipping at 1.0, weight decay and
    label smoothing, dropout 0: the same losses, correct counts and
    parameters as the JAX step."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        vit_classifier_params_to_torch,
    )
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.parallel.train_step import cast_params_bf16
    from multimodal_concept_learning_tpu.parallel.train_step import (
        make_classifier_train_step as jstep_fn,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_classifier_train_step,
    )

    model, params = _jax_model(), jax_params
    hp = dict(weight_decay=1e-2, max_grad_norm=1.0, accumulation_steps=2,
              fp32_master=bf16_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params["params"])
    tx = jbuild(LR, **hp)
    if bf16_params:
        jparams = cast_params_bf16(jparams)
    jstate = JState.create(jparams, tx)
    jstep = jstep_fn(model, tx, label_smoothing=0.1)

    port = _port({"params": jax.tree_util.tree_map(np.asarray, jparams)})
    if bf16_params:
        for p in port.parameters():
            p.data = p.data.to(torch.bfloat16)
    state = TrainState(model=port, optimizer=build_optimizer(port, LR, **hp))
    step = make_classifier_train_step(port, torch.Generator().manual_seed(0), 0.1)
    for batch in _batches():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.key(0))
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=STEP_ATOL, rtol=0)
        assert int(m["correct"]) == int(jm["correct"]) and m["count"] == int(jm["count"])
    assert state.step == 3 and state.optimizer.count == 1 and state.optimizer.mini_step == 1
    ref = vit_classifier_params_to_torch(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jstate.params), DIMS["patch_size"])
    after = {n: p.detach().float().numpy() for n, p in port.named_parameters()}
    assert sorted(after) == sorted(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(after[name], want, atol=STEP_ATOL, rtol=0, err_msg=name)


def test_eval_step_on_padded_batch_matches_jax(jax_params):
    """A final batch padded by wrapping: loss, correct and count over the
    valid rows only, as the JAX eval step computes them."""
    from multimodal_concept_learning_tpu.parallel.train_step import (
        make_classifier_eval_step as jeval_fn,
    )
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        make_classifier_eval_step,
    )

    model, params = _jax_model(), jax_params
    batch = _batches(1, b=6)[0]
    batch["valid"] = np.asarray([True, True, True, True, False, False])
    batch["labels"][4:] = batch["labels"][:2]  # the wrapped rows
    ref = jeval_fn(model, 0.1)(params["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    port = _port(params)
    out = make_classifier_eval_step(port, 0.1)(port, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    np.testing.assert_allclose(out["loss"].item(), float(ref["loss"]), atol=STEP_ATOL, rtol=0)
    assert int(out["correct"]) == int(ref["correct"]) and int(out["count"]) == 4
    full = dict(batch, valid=np.ones(6, bool))
    whole = make_classifier_eval_step(port, 0.1)(port, {k: torch.from_numpy(v)
                                                        for k, v in full.items()})
    assert int(whole["count"]) == 6 and abs(whole["loss"].item() - out["loss"].item()) > 1e-6


# -- dropout ----------------------------------------------------------------------


def _state(gen):
    return gen.get_state().clone()


def test_dropout_keep_rate_and_kept_values():
    from multimodal_concept_learning_tpu_torch.ops.attention import dropout

    rate, n = 0.1, 200_000
    x = torch.randn(n, generator=torch.Generator().manual_seed(1))
    y = dropout(x, rate, torch.Generator().manual_seed(2), deterministic=False)
    keep = y != 0
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 4 * sigma
    assert torch.equal(y[keep], x[keep] / torch.tensor(1 - rate, dtype=x.dtype).item())
    xb = x.to(torch.bfloat16)
    yb = dropout(xb, rate, torch.Generator().manual_seed(2), deterministic=False)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, keep)
    # bf16: divided by 1 - rate rounded to bf16, as JAX divides by a bf16 scalar
    assert torch.equal(yb[keep], (xb[keep].float() / 0.8984375).to(torch.bfloat16))


def test_dropout_seed_reproduces_masks_and_rate_zero_draws_nothing():
    from multimodal_concept_learning_tpu_torch.ops.attention import (
        dropout,
        multi_head_attention,
    )

    x = torch.randn(4, 33, 8)
    a = dropout(x, 0.3, torch.Generator().manual_seed(5), deterministic=False)
    b = dropout(x, 0.3, torch.Generator().manual_seed(5), deterministic=False)
    c = dropout(x, 0.3, torch.Generator().manual_seed(6), deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(9)
    before = _state(gen)
    assert dropout(x, 0.0, gen, deterministic=False) is x
    assert dropout(x, 0.3, gen, deterministic=True) is x
    q = torch.randn(2, 9, 4, 16)
    det = multi_head_attention(q, q, q, dropout_rate=0.3, generator=gen, deterministic=True)
    zero = multi_head_attention(q, q, q, dropout_rate=0.0, generator=gen, deterministic=False)
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(det, zero)
    drawn = multi_head_attention(q, q, q, dropout_rate=0.3, generator=gen, deterministic=False)
    assert not torch.equal(gen.get_state(), before) and not torch.equal(drawn, det)


@pytest.mark.parametrize("dtype,hk", [("float32", 4), ("bfloat16", 4), ("float32", 2)])
def test_dense_dropout_branch_matches_jax_given_its_mask(monkeypatch, dtype, hk):
    """With JAX's own keep mask injected, the port's dense dropout branch
    (GQA by grouping, a bias) gives JAX's output: float32 1e-5, bf16 2e-2
    of the max."""
    from multimodal_concept_learning_tpu.ops.attention import multi_head_attention as jmha
    from multimodal_concept_learning_tpu_torch.ops import attention as pa

    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, hk, 16)).astype(np.float32) for _ in range(2))
    bias = (rng.standard_normal((2, 1, 11, 11)) * 0.5).astype(np.float32)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    key, rate = jax.random.key(4), 0.25
    ref = jmha(*(jnp.asarray(a, jdt) for a in (q, k, v)), bias=jnp.asarray(bias),
               dropout_rate=rate, dropout_rng=key, deterministic=False, use_flash=False)
    shape = (2, 4, 11, 11) if hk == 4 else (2, hk, 4 // hk, 11, 11)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, shape))
    seen = []

    def jax_mask(shape_, rate_, generator, device):
        seen.append(tuple(shape_))
        return torch.from_numpy(mask.reshape(shape_).copy())

    monkeypatch.setattr(pa, "_keep_mask", jax_mask)
    out = pa.multi_head_attention(*(torch.from_numpy(a).to(pdt) for a in (q, k, v)),
                                  torch.from_numpy(bias), dropout_rate=rate,
                                  generator=torch.Generator(), deterministic=False)
    assert seen == [(2, hk, 4 // hk, 11, 11)]
    ref = np.asarray(ref, np.float32)
    limit = 1e-5 if dtype == "float32" else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=limit, rtol=0)


def test_vit_dropout_paths(jax_params, monkeypatch):
    """A dropout config's training forward draws from its generator (one
    seed, the same logits; another seed, others) and reaches the dense
    branch; its deterministic forward equals the dropout-free model's, and
    no dropout-free or deterministic call reaches the dense branch."""
    from multimodal_concept_learning_tpu_torch.ops import attention as pa

    params = jax_params
    drop = _port(params, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    plain = _port(params)
    x = torch.from_numpy(_images(2))
    calls = []
    dense = pa._dense_dropout_attention
    monkeypatch.setattr(pa, "_dense_dropout_attention",
                        lambda *a: calls.append(1) or dense(*a))
    with torch.no_grad():
        det = drop(x)
        assert not calls and torch.equal(det, plain(x))
        assert torch.equal(plain(x, deterministic=False, generator=torch.Generator()), det)
        assert not calls
        t1, t2, t3 = (drop(x, deterministic=False, generator=torch.Generator().manual_seed(s))
                      for s in (1, 1, 2))
    assert len(calls) == 3 * DIMS["num_hidden_layers"]
    assert torch.equal(t1, t2) and not torch.equal(t1, t3) and not torch.equal(t1, det)
