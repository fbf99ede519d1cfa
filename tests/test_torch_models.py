"""PyTorch port: models vs the JAX package on the same weights (CPU, float32).

Tiny seeded JAX MLLMs (vit-t-8 tower; the nano LM and a small
Gemma-3-shaped LM with qk-norm, sandwich norms, a window below the prompt
length and query_pre_attn_scalar != head_dim) are exported with the
port's ``state_dict_from_jax`` and loaded strictly into the port.
Tolerances: whole-model hidden states and logits in float32 <= 1e-4 abs
(XLA-CPU and ATen sum in different orders); greedy tokens exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

ATOL = 1e-4
LENS = [5, 2, 9]  # text tokens per row: a ragged right-padded batch


@pytest.fixture(scope="module")
def nano_pair():
    return tp.make_pair()


@pytest.fixture(scope="module")
def gemma_pair():
    return tp.make_pair(tp.GEMMA_SMALL)


@pytest.fixture(params=["nano", "gemma3-small"])
def pair(request):
    return request.getfixturevalue("nano_pair" if request.param == "nano" else "gemma_pair")


def _apply(model, params, method, *args):
    """``model.apply`` under one jit (eager flax compiles every op apart)."""
    return jax.jit(lambda p, *a: model.apply(p, *a, method=method))(params, *args)


def _prompt_embeds(model, params, images, ids):
    return np.asarray(_apply(model, params, lambda m, a, b: m.prompt_embeds(a, b),
                             jnp.asarray(images), jnp.asarray(ids)))


def test_vit_encoder_matches_jax(nano_pair):
    model, params, port = nano_pair
    images, _, _ = tp.prompt_batch(model.config, LENS)
    ref = _apply(model, params, lambda m, im: m.vision_model(im), jnp.asarray(images))
    with torch.no_grad():
        out = port.vision_model(torch.from_numpy(images))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_hidden_states_match_jax(pair):
    model, params, port = pair
    images, ids, mask = tp.prompt_batch(model.config, LENS)
    emb = _prompt_embeds(model, params, images, ids)
    kv_lens = torch.from_numpy(mask.sum(axis=1).astype(np.int32))
    with torch.no_grad():
        pemb = port.prompt_embeds(torch.from_numpy(images), torch.from_numpy(ids))
        # the right-padded mask as descriptors (kv_lens) and as a bias
        outs = [port.language_model.hidden_states(pemb, torch.from_numpy(mask), lens).numpy()
                for lens in (kv_lens, None)]
    np.testing.assert_allclose(pemb.numpy(), emb, atol=ATOL, rtol=0)
    ref = np.asarray(_apply(model, params, lambda m, e, k: m.language_model.hidden_states(e, k),
                            jnp.asarray(emb), jnp.asarray(mask)))
    valid = mask.astype(bool)  # padded positions are never read by real ones
    for out in outs:
        np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=0)


def _jax_decode_step(m, tok, pools, pt, seq_lens):
    lm = m.language_model
    h, pools = lm.decode_step_paged(lm.embed(tok[:, None]), pools, pt, seq_lens)
    return h, pools, lm.lm_head(h[:, 0])


def test_prefill_and_decode_paged_match_jax(pair):
    """prefill_paged then two decode_step_paged steps: hidden states, pools
    and logits equal to JAX's on the same page table."""
    from multimodal_concept_learning_tpu.ops.paged_kv import init_paged_kv_cache as jinit
    from multimodal_concept_learning_tpu_torch.ops.paged_kv import init_paged_kv_cache as tinit

    model, params, port = pair
    cfg = model.config
    images, ids, mask = tp.prompt_batch(cfg, LENS)
    b, t = ids.shape
    ps, np_ = 4, -(-(t + 3) // 4)
    pt = (np.random.default_rng(3).permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    jpools = jinit(cfg.lm, 1 + b * np_, ps)
    tpools = tinit(port.cfg.lm, 1 + b * np_, ps, device="cpu")
    jh, jpools = _apply(model, params, lambda m, *x: m.prefill_paged(*x), jnp.asarray(images),
                        jnp.asarray(ids), jnp.asarray(mask), jpools, jnp.asarray(pt))
    with torch.no_grad():
        th = port.prefill_paged(torch.from_numpy(images), torch.from_numpy(ids),
                                torch.from_numpy(mask), tpools, torch.from_numpy(pt))
    valid = mask.astype(bool)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], atol=ATOL, rtol=0)

    lm = port.language_model
    seq_lens = mask.sum(axis=1).astype(np.int32)
    tok = np.asarray([3, 7, 11], np.int32)
    for _ in range(2):
        jd, jpools, jlogits = _apply(model, params, _jax_decode_step, jnp.asarray(tok), jpools,
                                     jnp.asarray(pt), jnp.asarray(seq_lens))
        with torch.no_grad():
            td = lm.decode_step_paged(lm.embed(torch.from_numpy(tok)[:, None]), tpools,
                                      torch.from_numpy(pt), torch.from_numpy(seq_lens))
            tlogits = lm.lm_head(td[:, 0]).numpy()
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tlogits, np.asarray(jlogits), atol=ATOL, rtol=0)
        seq_lens = seq_lens + 1
        tok = tlogits.argmax(axis=-1).astype(np.int32)
    for layer in range(cfg.lm.num_layers):  # every page but the null page
        for kv in ("k", "v"):
            np.testing.assert_allclose(tpools[layer][kv].numpy()[1:],
                                       np.asarray(jpools[layer][kv])[1:], atol=ATOL, rtol=0)


def test_paged_generate_matches_jax(pair):
    from multimodal_concept_learning_tpu.models.mllm import paged_generate as jgen
    from multimodal_concept_learning_tpu_torch.models.mllm import paged_generate as tgen

    model, params, port = pair
    images, ids, mask = tp.prompt_batch(model.config, LENS, seed=5)
    gen = jax.jit(lambda p, *a: jgen(model, p, *a, max_new_tokens=6, page_size=8, eos_id=2))
    ref = np.asarray(gen(params["params"], jnp.asarray(images), jnp.asarray(ids),
                         jnp.asarray(mask)))
    out = tgen(port, torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
               max_new_tokens=6, page_size=8, eos_id=2)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_state_dict_from_jax_matches_torch_interop(gemma_pair):
    """Key for key and value for value the .pt layout of
    checkpoint/torch_interop.mllm_params_to_torch, and it loads strictly."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu_torch.checkpoint import state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM

    model, params, _ = gemma_pair
    patch = model.config.vision.patch_size
    ref = mllm_params_to_torch(params, patch_size=patch)
    sd = state_dict_from_jax(params, patch_size=patch)
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    port = MLLM(tp.port_config(model.config))
    port.load_state_dict(sd, strict=True)
    assert sorted(port.state_dict()) == sorted(ref)


def test_cast_for_compute_keeps_norms_and_embeddings_float32(gemma_pair):
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    model, params, _ = gemma_pair
    cfg = tp.port_config(model.config)
    cfg = MLLMConfig(vision=cfg.vision, lm=cfg.lm, num_vision_tokens=cfg.num_vision_tokens,
                     dtype=torch.bfloat16)
    port = build_mllm(cfg, state_dict_from_jax(params, 8), "cpu")
    dtypes = {n: p.dtype for n, p in port.named_parameters()}
    assert dtypes["language_model.model.layers.0.self_attn.q_proj.weight"] == torch.bfloat16
    assert dtypes["vision_model.embeddings.patch_embeddings.projection.weight"] == torch.bfloat16
    assert dtypes["projector.bias"] == torch.bfloat16
    for name in ("language_model.model.embed_tokens.weight",
                 "language_model.model.layers.0.self_attn.q_norm.weight",
                 "language_model.model.norm.weight", "vision_model.layernorm.weight",
                 "vision_model.embeddings.cls_token",
                 "vision_model.embeddings.position_embeddings"):
        assert dtypes[name] == torch.float32, name


# -- training surface ---------------------------------------------------------


def _left_padded(mask):
    """The same rows with their padding moved to the left."""
    out = np.zeros_like(mask)
    for i, n in enumerate(mask.sum(axis=1)):
        out[i, mask.shape[1] - n:] = 1
    return out


def _with_hole(mask):
    """Row 0 with two masked positions inside its text, row 2 with one."""
    out = mask.copy()
    nvt = out.shape[1] - (LENS[-1] + 2)
    out[0, nvt + 1:nvt + 3] = 0
    out[2, nvt + 4] = 0
    return out


@pytest.mark.parametrize("mask_kind", ["left_padded", "hole"])
def test_hidden_states_match_jax_on_any_mask(pair, mask_kind):
    """A mask that is not right-padded goes to attention as the JAX
    make_attention_bias bias: hidden states equal JAX's at EVERY position,
    float32, 1e-5 (the descriptor path assumed right padding and attended
    the wrong keys)."""
    model, params, port = pair
    images, ids, mask = tp.prompt_batch(model.config, LENS)
    mask = _left_padded(mask) if mask_kind == "left_padded" else _with_hole(mask)
    emb = _prompt_embeds(model, params, images, ids)
    ref = np.asarray(_apply(model, params, lambda m, e, k: m.language_model.hidden_states(e, k),
                            jnp.asarray(emb), jnp.asarray(mask)))
    with torch.no_grad():
        out = port.language_model.hidden_states(torch.from_numpy(emb),
                                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def _labels(ids, mask, answer_len=2, skip_row=None):
    """Answer-only labels: the last ``answer_len`` real tokens of each row
    (none for ``skip_row``)."""
    labels = np.full_like(ids, -100)
    for i, n in enumerate(mask.sum(axis=1)):
        if i != skip_row:
            labels[i, n - answer_len:n] = ids[i, n - answer_len:n]
    return labels


@pytest.mark.parametrize("name,dense_loss", [("nano", False), ("gemma3-small", False),
                                             ("nano", True)])
def test_mllm_forward_loss_and_grads_match_jax(request, name, dense_loss):
    """MLLM.forward's loss, and the gradients of the embedding table and the
    projector (what language_embed_only trains), == jax.grad of the JAX
    MLLM's loss, float32, 1e-5."""
    model, params, port = request.getfixturevalue(
        "nano_pair" if name == "nano" else "gemma_pair")
    images, ids, mask = tp.prompt_batch(model.config, LENS, seed=2)
    labels = _labels(ids, mask, skip_row=1)

    def loss_fn(p):
        return model.apply(p, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                           jnp.asarray(labels), dense_loss=dense_loss)["loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port.zero_grad()
    out = port(torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
               torch.from_numpy(labels), dense_loss=dense_loss)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(ref_loss), atol=1e-5, rtol=0)
    g = ref_grads["params"]
    lm = port.language_model.model
    np.testing.assert_allclose(lm.embed_tokens.weight.grad.numpy(),
                               np.asarray(g["language_model"]["embed_tokens"]["embedding"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.projector.weight.grad.numpy(),
                               np.asarray(g["projector"]["kernel"]).T, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.projector.bias.grad.numpy(),
                               np.asarray(g["projector"]["bias"]), atol=1e-5, rtol=0)
    port.zero_grad()


def test_mllm_sparse_outputs_match_jax(nano_pair):
    """The sparse-loss dict: logits at the supervised positions, positions
    (rows with fewer than A answers pad as JAX's stable sort does) and valid."""
    model, params, port = nano_pair
    images, ids, mask = tp.prompt_batch(model.config, LENS, seed=3)
    labels = _labels(ids, mask, answer_len=3, skip_row=0)
    ref = jax.jit(lambda p: model.apply(p, jnp.asarray(images), jnp.asarray(ids),
                                        jnp.asarray(mask), jnp.asarray(labels)))(params)
    with torch.no_grad():
        out = port(torch.from_numpy(images), torch.from_numpy(ids), torch.from_numpy(mask),
                   torch.from_numpy(labels))
    np.testing.assert_array_equal(out["positions"].numpy(), np.asarray(ref["positions"]))
    np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("setting", ["vision_only", "language_only", "language_embed_only"])
def test_trainable_mask_matches_jax(gemma_pair, setting):
    """requires_grad by state-dict name == the JAX optax mask, leaf for leaf
    (through the reference .pt names); the summary prints the same lines."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask

    model, params, port = gemma_pair
    as_leaves = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       jmask(params, setting), params)
    ref = {k: bool(v.all()) for k, v in mllm_params_to_torch(as_leaves, patch_size=8).items()}
    try:
        mask = trainable_mask(port, setting)
        assert mask == ref
        assert all(p.requires_grad == mask[n] for n, p in port.named_parameters())
    finally:
        for p in port.parameters():
            p.requires_grad_(True)


def test_trainable_mask_refuses_lora_and_unknown(nano_pair):
    """``language_lora`` on a model without adapters trains what JAX's mask
    trains there (the projector alone); an unknown setting raises."""
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import mllm_params_to_torch
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask

    _, params, port = nano_pair
    as_leaves = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                       jmask(params, "language_lora"), params)
    ref = {k: bool(v.all()) for k, v in mllm_params_to_torch(as_leaves, patch_size=8).items()}
    try:
        mask = trainable_mask(port, "language_lora")
        assert mask == ref
        assert sorted(n for n, t in mask.items() if t) == ["projector.bias", "projector.weight"]
    finally:
        for p in port.parameters():
            p.requires_grad_(True)
    with pytest.raises(ValueError, match="Unknown"):
        trainable_mask(port, "everything")


def test_copy_init_ood_rows_and_summary_match_jax(nano_pair, capsys):
    from multimodal_concept_learning_tpu.models.mllm import copy_init_ood_rows as jcopy
    from multimodal_concept_learning_tpu.models.mllm import print_trainable_summary as jsummary
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        copy_init_ood_rows,
        print_trainable_summary,
        trainable_mask,
    )

    model, params, _ = nano_pair
    port = build_mllm(tp.port_config(model.config), state_dict_from_jax(params, 8), "cpu")
    copy_init_ood_rows(port, 3)
    ref = jcopy(jax.tree_util.tree_map(jnp.asarray, params), 3)
    ref = ref["params"]["language_model"]["embed_tokens"]["embedding"]
    np.testing.assert_array_equal(port.language_model.model.embed_tokens.weight.detach().numpy(),
                                  np.asarray(ref))
    jsummary(params, jmask(params, "language_embed_only"), "language_embed_only")
    expected = capsys.readouterr().out
    trainable_mask(port, "language_embed_only")
    print_trainable_summary(port, "language_embed_only")
    assert capsys.readouterr().out == expected


def test_frozen_cast_once_gives_the_same_numbers(gemma_pair):
    """bf16 compute over float32 parameters (training) == the same model
    with its frozen linear weights stored in bf16 once; trained parameters
    keep float32 storage."""
    import dataclasses

    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm, state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, trainable_mask

    model, params, _ = gemma_pair
    cfg = tp.port_config(model.config)
    cfg = dataclasses.replace(
        cfg, dtype=torch.bfloat16, vision=dataclasses.replace(cfg.vision, dtype=torch.bfloat16),
        lm=dataclasses.replace(cfg.lm, dtype=torch.bfloat16))
    sd = state_dict_from_jax(params, 8)
    images, ids, mask = (torch.from_numpy(x) for x in tp.prompt_batch(model.config, LENS))
    outs = []
    for cast_once in (False, True):
        m = MLLM(cfg)
        m.load_state_dict(sd, strict=True)
        trainable_mask(m, "language_embed_only")
        if cast_once:
            cast_for_compute(m, torch.bfloat16, only_frozen=True)
            assert m.language_model.model.layers[0].self_attn.q_proj.weight.dtype == torch.bfloat16
            assert m.projector.weight.dtype == torch.float32
        with torch.no_grad():
            outs.append(m(images, ids, mask)["hidden_states"])
    assert outs[0].dtype == torch.bfloat16
    assert torch.equal(outs[0], outs[1])
    build = build_mllm(cfg, sd, "cpu")  # the serving policy: every linear weight in bf16
    with torch.no_grad():
        assert torch.equal(build(images, ids, mask)["hidden_states"], outs[0])
