"""PyTorch port: the LM and the MLLM under ``moe_experts`` vs the JAX
package (CPU, float32; the layer itself: ``tests/test_torch_moe.py``).

Tolerances: 1e-4 for the MLLM's hidden states, 1e-5 for the per-layer
aux and exact greedy tokens (dense caches, paged caches, and a full
forward a token; the train step: ``test_torch_moe_train.py``).  Both
dispatches; sparse at cf 1.0, which drops
assignments at these shapes.
"""

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


def test_pt_loads_strict_both_ways(moe_pair, tmp_path):
    """``mllm_params_to_torch``'s .pt loads into the port with strict=True,
    and the port's state dict converts back to the JAX tree."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        mllm_params_from_torch,
        mllm_params_to_torch,
        save_torch_state_dict,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM

    model, params, port = moe_pair
    path = str(tmp_path / "moe.pt")
    save_torch_state_dict(mllm_params_to_torch(params, patch_size=8), path)
    fresh = MLLM(tp.port_config(model.config))
    fresh.load_state_dict(load_state_dict(path), strict=True)
    sd = {k: v.detach().float().numpy() for k, v in port.state_dict().items()}
    assert any(".moe.experts_gate" in k for k in sd) and not any(".mlp." in k for k in sd)
    back = mllm_params_from_torch(sd, params["params"], patch_size=8)
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(params["params"])[0],
                          jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(kp))


def test_hidden_states_and_aux_match_jax(moe_pair):
    """The MLLM's hidden states (right-padded and left-padded masks) and
    its per-layer aux values, as JAX sows them."""
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux

    model, params, port = moe_pair
    cfg = model.config
    images, ids, mask = tp.prompt_batch(cfg, [5, 2, 7], seed=4)
    run = jax.jit(lambda p, *a: model.apply(p, *a, mutable=["intermediates"]))
    for m in (mask, mask[:, ::-1].copy()):
        out, inter = run(params, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(m))
        jaux = [np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(inter)
                if any(getattr(k, "key", None) == "moe_aux" for k in path)]
        rec = MoEAux()
        with torch.no_grad():
            got = port(torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(m),
                       moe_aux=rec)
        np.testing.assert_allclose(got["hidden_states"].numpy(),
                                   np.asarray(out["hidden_states"]), atol=HIDDEN_TOL, rtol=0)
        assert len(rec.aux) == len(jaux) == cfg.lm.num_layers
        np.testing.assert_allclose([a.item() for a in rec.aux], [float(a) for a in jaux],
                                   atol=F32_TOL, rtol=0)


def test_greedy_tokens_match_jax(moe_pair):
    """Greedy tokens: JAX ``greedy_generate`` == the port's dense-cache
    ``greedy_generate`` == its ``paged_generate`` == a full forward a token."""
    from multimodal_concept_learning_tpu.models.mllm import greedy_generate as jax_greedy
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate, paged_generate

    model, params, port = moe_pair
    images, ids, mask = tp.prompt_batch(model.config, [5, 2, 7], seed=6)
    n_new = 3
    ref = np.asarray(jax.jit(lambda p, *a: jax_greedy(model, p, *a, max_new_tokens=n_new))(
        params["params"], jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask)))
    t = [torch.from_numpy(a) for a in (images, ids, mask)]
    np.testing.assert_array_equal(greedy_generate(port, *t, max_new_tokens=n_new).numpy(), ref)
    np.testing.assert_array_equal(
        paged_generate(port, *t, max_new_tokens=n_new, page_size=4).numpy(), ref)
    # the full forward, one token at a time, each appended at its row's end:
    # JAX's and the port's tokens agree; under dense dispatch they are also
    # the cached decode's (sparse capacity follows the call's padded shape,
    # so a growing prompt routes differently from a one-row decode step)
    pad = np.zeros((ids.shape[0], n_new), np.int32)
    ids_f, mask_f = np.concatenate([ids, pad], 1), np.concatenate([mask, pad], 1)
    jfwd = jax.jit(lambda p, *a: model.apply(p, *a)["hidden_states"])
    toks = []
    rows = np.arange(ids.shape[0])
    for _ in range(n_new):
        lens = mask_f.sum(1)
        with torch.no_grad():
            hidden = port(t[0], torch.from_numpy(ids_f), torch.from_numpy(mask_f))["hidden_states"]
            tok = torch.argmax(port.language_model.lm_head(hidden[rows, lens - 1]), -1).numpy()
        jh = jfwd(params, jnp.asarray(images), jnp.asarray(ids_f), jnp.asarray(mask_f))
        jtok = np.asarray(jnp.argmax(model.apply(params, jh[rows, lens - 1],
                                                 method=lambda m, h: m.language_model.lm_head(h)),
                                     -1))
        np.testing.assert_array_equal(tok, jtok)
        toks.append(jtok.astype(np.int32))
        ids_f[rows, lens] = jtok
        mask_f[rows, lens] = 1
    if port.cfg.lm.moe_dispatch == "dense":
        np.testing.assert_array_equal(np.stack(toks, 1), ref)
