"""PyTorch port: the Mixture-of-Experts layer (ops/moe.py) vs the JAX
package (CPU; the LM and the MLLM under MoE: ``test_torch_moe_mllm.py``).

Tolerances: float32 1e-5 (outputs and aux; gradients 1e-5 of the
reference's max where it exceeds 1: a router gradient sums ~50 tokens'
terms of size ~10), bf16 2e-2 of the reference's max.  The layer cases
cover both dispatches, a router with two equal rows (ties: the dense gate over-selects, the sparse
dispatch takes the lowest index), a capacity factor that drops
assignments, and ``cf >= E / top_k``, which equals dense dispatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

F32_TOL = 1e-5
HIDDEN_TOL = 1e-4
BF16_REL = 2e-2
E, K, H, I = 4, 2, 32, 48
MOE = dict(moe_experts=4, moe_top_k=2)


def _layer_pair(dispatch, cf=1.25, top_k=K, dtype="float32", tie=False, seed=0):
    """(jax module, jax params, port MoEMLP) with equal float32 weights."""
    from multimodal_concept_learning_tpu.ops.moe import MoEMLP as JaxMoE
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEMLP

    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxMoE(hidden_size=H, intermediate_size=I, num_experts=E, top_k=top_k, dtype=jdt,
                dispatch=dispatch, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    params = {"router": {"kernel": (0.3 * rng.standard_normal((H, E))).astype(np.float32)},
              "experts_gate": (0.2 * rng.standard_normal((E, H, I))).astype(np.float32),
              "experts_up": (0.2 * rng.standard_normal((E, H, I))).astype(np.float32),
              "experts_down": (0.2 * rng.standard_normal((E, I, H))).astype(np.float32)}
    if tie:  # experts 1 and 2 get equal router rows: their probabilities tie exactly
        params["router"]["kernel"][:, 2] = params["router"]["kernel"][:, 1]
    pm = MoEMLP(H, I, E, top_k=top_k, dtype=tdt, dispatch=dispatch, capacity_factor=cf)
    with torch.no_grad():
        pm.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T))
        for n in ("experts_gate", "experts_up", "experts_down"):
            getattr(pm, n).copy_(torch.from_numpy(params[n]))
    return jm, {"params": params}, pm


def _x(b=2, t=24, seed=1):
    return np.random.default_rng(seed).standard_normal((b, t, H)).astype(np.float32)


def _jax_run(jm, params, x, cot):
    """(out, aux, grads of sum(out * cot) + aux w.r.t. params and x)."""

    def f(p, xx):
        out, aux = jm.apply(p, xx)
        return jnp.sum(out.astype(jnp.float32) * cot) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    return out, aux, gp["params"], gx


def _port_run(pm, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = pm(xt)
    (torch.sum(out.float() * torch.from_numpy(cot)) + aux).backward()
    return out, aux, xt.grad


def _close(actual, ref, dtype, what):
    actual = np.asarray(actual, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    atol = F32_TOL * max(scale, 1.0) if dtype == "float32" else BF16_REL * max(scale, 1e-6)
    np.testing.assert_allclose(actual, ref, atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch,cf,tie", [
    ("dense", 1.25, False), ("sparse", 1.25, False), ("sparse", 0.5, False),
    ("dense", 1.25, True), ("sparse", 1.25, True),
], ids=["dense", "sparse", "sparse-drops", "dense-tie", "sparse-tie"])
def test_layer_matches_jax(dispatch, cf, tie, dtype):
    """Output, aux and the gradients of the router, the experts and x."""
    jm, params, pm = _layer_pair(dispatch, cf, dtype=dtype, tie=tie)
    x = _x()
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    out, aux, gp, gx = _jax_run(jm, params, x, cot)
    pout, paux, pgx = _port_run(pm, x, cot)
    _close(pout.detach().float().numpy(), out, dtype, "out")
    _close(paux.item(), aux, "float32", "aux")
    _close(pgx.numpy(), gx, dtype, "d x")
    _close(pm.router.weight.grad.numpy().T, gp["router"]["kernel"], dtype, "d router")
    for n in ("experts_gate", "experts_up", "experts_down"):
        _close(getattr(pm, n).grad.numpy(), gp[n], dtype, f"d {n}")


def test_tied_router_over_selects():
    """Two equal router rows: the dense gate keeps more than k experts for
    some tokens (JAX's ``probs >= thresh``), the same count as JAX's."""
    jm, params, pm = _layer_pair("dense", tie=True)
    x = _x()
    jg = jax.nn.softmax(jnp.asarray(x) @ params["params"]["router"]["kernel"], axis=-1)
    thresh = jax.lax.top_k(jg, K)[0][..., -1:]
    jsel = np.asarray((jg >= thresh).sum(-1))
    _, _, gates = pm.gates(torch.from_numpy(x))
    psel = (gates > 0).sum(-1).numpy()
    np.testing.assert_array_equal(psel, jsel)
    assert psel.max() > K, "the tie case selected no extra expert"


def test_capacity_drops_match_jax():
    """cf 0.5 drops assignments (router_stats says how many, as JAX's), and
    the sparse output then differs from the dense one by the dropped terms,
    where JAX's does."""
    from multimodal_concept_learning_tpu.ops.moe import router_stats as jstats
    from multimodal_concept_learning_tpu_torch.ops.moe import router_stats

    x = _x()
    _, params, pm = _layer_pair("sparse", cf=0.5)
    with torch.no_grad():
        logits, _, _ = pm.gates(torch.from_numpy(x))
    st, jst = router_stats(logits, K, 0.5), jstats(np.asarray(logits), K, 0.5)
    assert st["drop_frac"] == jst["drop_frac"] > 0
    jd, jparams, pd = _layer_pair("dense")
    js, _, _ = _layer_pair("sparse", cf=0.5)
    jdiff = np.asarray(js.apply(jparams, x)[0] - jd.apply(jparams, x)[0])
    pdiff = (pm(torch.from_numpy(x))[0] - pd(torch.from_numpy(x))[0]).detach().numpy()
    dropped_rows = np.abs(jdiff).max(-1) > 1e-3  # a dropped term is O(1), roundoff ~1e-6
    np.testing.assert_array_equal(np.abs(pdiff).max(-1) > 1e-3, dropped_rows)
    assert dropped_rows.any()


@pytest.mark.parametrize("tie", [False, True])
def test_sparse_without_drops_equals_dense(tie):
    """cf >= E / top_k: no assignment can drop, so sparse == dense."""
    _, _, pd = _layer_pair("dense", tie=tie)
    _, _, ps = _layer_pair("sparse", cf=E / K, tie=tie)
    x = torch.from_numpy(_x())
    d, s = pd(x)[0].detach(), ps(x)[0].detach()
    if not tie:
        np.testing.assert_allclose(s.numpy(), d.numpy(), atol=1e-6, rtol=0)
    else:  # an over-selected third expert is dense-only: only untied tokens agree
        _, _, gates = pd.gates(x)
        untied = ((gates > 0).sum(-1) == K).numpy()
        np.testing.assert_allclose(s.numpy()[untied], d.numpy()[untied], atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", ["layer", "stack", "list"])
def test_router_stats_matches_jax(shape):
    from multimodal_concept_learning_tpu.ops.moe import router_stats as jstats
    from multimodal_concept_learning_tpu_torch.ops.moe import router_stats

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 2, 24, E)).astype(np.float32)
    logits[1, :, :, 3] += 2.0  # one layer leans on one expert: drops at cf 1.0
    arg = {"layer": logits[1], "stack": logits, "list": list(logits)}[shape]
    targ = {"layer": torch.from_numpy(logits[1]), "stack": torch.from_numpy(logits),
            "list": [torch.from_numpy(a) for a in logits]}[shape]
    ref, got = jstats(arg, K, 1.0), router_stats(targ, K, 1.0)
    assert sorted(ref) == sorted(got)
    for key in ref:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(ref[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)


@pytest.mark.parametrize("flag", ["int8_weights", "int4_weights"])
def test_moe_refuses_quantized_weights(flag):
    """As in JAX: quantizing only the attention projections of an MoE LM is refused."""
    from multimodal_concept_learning_tpu.models.lm import LMConfig as JaxLMConfig
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig

    with pytest.raises(ValueError, match="MoE expert"):
        JaxLMConfig(**MOE, **{flag: True})
    with pytest.raises(ValueError, match="MoE expert"):
        LMConfig(**MOE, **{flag: True})
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    cfg = MLLMConfig.create(vocab_size=64, vision_preset="vit-t-8", lm_preset="nano",
                            num_vision_tokens=17, image_size=32, lm_moe_experts=4)
    with pytest.raises(ValueError, match="MoE expert"):
        cfg.quantized(**{flag.split("_")[0]: True})


def test_cast_for_compute_keeps_the_router_float32():
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEMLP

    m = cast_for_compute(MoEMLP(H, I, E), torch.bfloat16)
    assert m.router.weight.dtype == torch.float32
    assert all(getattr(m, n).dtype == torch.bfloat16
               for n in ("experts_gate", "experts_up", "experts_down"))
    assert dataclasses.is_dataclass(__import__(
        "multimodal_concept_learning_tpu_torch.ops.moe", fromlist=["MoEAux"]).MoEAux)
