"""PyTorch port: the partitioned text embedding (``ops/sparse_embed.py``)
and the partitioned CLIP against the JAX package and the dense run (CPU).

``PartitionedEmbed`` on the JAX module's numpy params, stray ids included:
bitwise (float32).  ``active_rows_from_corpus``, ``inactive_decay`` and
``merged_embedding`` (float32 and bf16 tables): equal to JAX's, bitwise.
Bad rows raise (JAX ``AssertionError``, the port ``ValueError``).  A tiny
float32 partitioned CLIP (vit-t-8 at 32 px; text 64 wide, 2 layers, 4
heads, context 16) with seeded, perturbed JAX parameters, three AdamW steps
(clipping, weight decay 0.2, lr 1e-4): the port against JAX's partitioned
run, losses rtol 1e-5, parameters rtol 2e-5 with atol 1e-5 (AdamW divides
each update by its element's gradient size, so an element whose gradient is
near zero takes a rounding-sized gradient to an update near lr: the 1e-5
bound of ``tests/test_torch_clip.py``), the key biases, whose gradient
softmax cancels exactly, 3 lr; then the port's partitioned run merged
against its dense run (one implementation) at ``tests/test_sparse_embed.py``'s
bounds, rtol 2e-5 and atol 1e-7 (key biases 3 lr), and the frozen table
bitwise unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

LR, WD = 1e-4, 0.2
CLASSES = ["r255g0b0", "r0g255b0", "r0g0b255", "r255g255b0"]
DIMS = dict(image_size=32, text_width=64, text_layers=2, text_heads=4, context_length=16,
            embed_dim=32)
KEY_BIAS = ("key.bias", ".k.bias")


def _tokenizer():
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    return ConceptTokenizer()


def _rows(tok):
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import active_rows_from_corpus

    collator = ClipCollator(tok, "a circle of color {class_name}", 16)
    return active_rows_from_corpus([collator.caption_ids(n)[0] for n in CLASSES])


def _batch(tok, seed, b=4):
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator

    rng = np.random.default_rng(seed)
    collator = ClipCollator(tok, "a circle of color {class_name}", 16)
    images = [rng.random((3, 32, 32)).astype(np.float32) for _ in range(b)]
    return collator([(im, CLASSES[(seed + i) % len(CLASSES)]) for i, im in enumerate(images)])


def test_partitioned_embed_matches_jax_bitwise():
    from multimodal_concept_learning_tpu.ops.sparse_embed import PartitionedEmbed as JEmbed
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import PartitionedEmbed

    rows = (0, 1, 2, 3, 5, 8, 13, 21, 34, 55)
    ids = np.asarray([[4, 5, 6, 63], [55, 63, 0, 13]], np.int32)  # 4, 6, 63: stray
    jmod = JEmbed(64, 16, active_rows=rows)
    params = jmod.init(jax.random.key(0), jnp.asarray(ids))["params"]
    rng = np.random.default_rng(0)
    params = {k: np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()}  # the subtable apart from its rows of the table
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    mod = PartitionedEmbed(64, 16, rows)
    mod.load_state_dict({"weight": torch.from_numpy(params["embedding"]),
                         "active": torch.from_numpy(params["active"])}, strict=True)
    got = mod(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert not mod.weight.requires_grad and mod.active.requires_grad
    got.sum().backward()
    assert mod.weight.grad is None and mod.active.grad is not None


def test_corpus_rows_decay_and_merge_match_jax():
    from multimodal_concept_learning_tpu.ops import sparse_embed as jse
    from multimodal_concept_learning_tpu_torch.ops import sparse_embed as se

    arrays = [np.asarray([[3, 1, 0]]), np.asarray([7, 1])]
    assert se.active_rows_from_corpus(arrays) == jse.active_rows_from_corpus(arrays) == (0, 1, 3, 7)
    assert se.active_rows_from_corpus([torch.tensor([9, 2])]) == (2, 9)
    lrs = np.float32(np.linspace(1e-4, 3e-3, 37))
    assert se.inactive_decay(lrs, 0.2) == jse.inactive_decay(lrs, 0.2)
    rng = np.random.default_rng(2)
    rows = (1, 4, 5, 9)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        emb = (0.02 * rng.standard_normal((12, 8))).astype(dtype)
        act = rng.standard_normal((4, 8)).astype(dtype)
        for decay in (0.99991234, 0.987654321, 1.0):
            want = jse.merged_embedding(emb, act, rows, decay)
            tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
            temb = torch.from_numpy(emb.astype(np.float32)).to(tdt)
            tact = torch.from_numpy(act.astype(np.float32)).to(tdt)
            got = se.merged_embedding(temb, tact, rows, decay)
            # the trainer casts to the table's dtype, as JAX's trainer does
            np.testing.assert_array_equal(got.to(tdt).float().numpy(),
                                          np.asarray(want).astype(dtype).astype(np.float32))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    got = se.merged_embedding(emb.astype(np.float32), act.astype(np.float32), rows)  # numpy in
    np.testing.assert_array_equal(got[list(rows)].numpy(), act.astype(np.float32))


@pytest.mark.parametrize("rows", [(3, 1), (1, 9), (), (2, 2), (-1, 2)])
def test_bad_rows_raise(rows):
    from multimodal_concept_learning_tpu.ops.sparse_embed import PartitionedEmbed as JEmbed
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import PartitionedEmbed

    with pytest.raises(AssertionError):
        JEmbed(8, 4, active_rows=rows).init(jax.random.key(0), jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(ValueError, match="active_rows"):
        PartitionedEmbed(8, 4, rows)


@pytest.fixture(scope="module")
def partitioned_pair():
    """(jax partitioned CLIPModel, its numpy params, tokenizer, rows)."""
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel

    tok = _tokenizer()
    rows = _rows(tok)
    jcfg = JConfig.create(vocab_size=len(tok), vision_preset="vit-t-8",
                          active_vocab_rows=rows, **DIMS)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32))
    model = JModel(jcfg)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)),
                                 jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        params["params"])
    return model, params, tok, rows


def _port_run(sd, rows, tok, partitioned: bool):
    """(losses, final state dict, optimizer) of three port steps from ``sd``."""
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )

    cfg = CLIPConfig.create(vocab_size=len(tok), vision_preset="vit-t-8", dtype=torch.float32,
                            active_vocab_rows=rows if partitioned else None, **DIMS)
    port = CLIPModel(cfg)
    port.load_state_dict(sd, strict=True)
    state = TrainState(model=port, optimizer=build_optimizer(port, LR, weight_decay=WD,
                                                             max_grad_norm=1.0))
    step = make_clip_train_step(port)
    losses = []
    for i in range(3):
        state, m = step(state, to_device(_batch(tok, 10 + i), "cpu"))
        losses.append(m["loss"].item())
    return losses, {k: v.clone() for k, v in port.state_dict().items()}, state.optimizer


def _held(got, want, name, atol):
    if name.endswith(KEY_BIAS):
        np.testing.assert_allclose(got, want, atol=3 * LR, rtol=0, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=atol, err_msg=name)


def test_partitioned_clip_three_steps_match_jax_and_dense(partitioned_pair):
    from multimodal_concept_learning_tpu.ops.sparse_embed import partitioned_embed_mask
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState
    from multimodal_concept_learning_tpu.train.contrastive_training import (
        make_clip_train_step as jstep_fn,
    )
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import (
        inactive_decay,
        merged_embedding,
    )

    model, params, tok, rows = partitioned_pair
    mask = partitioned_embed_mask(jax.tree_util.tree_map(lambda _: True, params))
    tx = jbuild(LR, weight_decay=WD, max_grad_norm=1.0, trainable_mask=mask)
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    jstep = jstep_fn(model, tx)
    jlosses = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(tok, 10 + i).items()}
        jstate, jm = jstep(jstate, batch, jax.random.key(0))
        jlosses.append(float(jm["loss"]))
    sd0 = clip_state_dict_from_jax(params, 8)
    assert "text.token_embedding.active" in sd0
    losses, sd, opt = _port_run(sd0, rows, tok, partitioned=True)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = clip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), 8)
    assert sorted(sd) == sorted(want)
    for name, t in sd.items():
        _held(t.numpy(), want[name].numpy(), name, atol=1e-5)
    table = "text.token_embedding.weight"
    assert torch.equal(sd[table], sd0[table])  # the frozen table never moved
    assert table not in opt.params and "text.token_embedding.active" in opt.params

    # the dense run from the same starting table (its rows the subtable's)
    dense0 = {k: v for k, v in sd0.items() if k != "text.token_embedding.active"}
    dense0[table] = merged_embedding(sd0[table], sd0["text.token_embedding.active"], rows)
    dlosses, dsd, _ = _port_run(dense0, rows, tok, partitioned=False)
    np.testing.assert_allclose(losses, dlosses, rtol=1e-5)
    merged = merged_embedding(sd[table], sd["text.token_embedding.active"], rows,
                              inactive_decay([LR] * 3, WD))
    np.testing.assert_allclose(merged.numpy(), dsd[table].numpy(), rtol=2e-5, atol=1e-7)
    for name, t in dsd.items():
        if name != table:
            _held(sd[name].numpy(), t.numpy(), name, atol=1e-7)
