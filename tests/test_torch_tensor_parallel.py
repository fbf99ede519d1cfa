"""PyTorch port: tensor, fully-sharded and expert parallelism over N-D
meshes (four Gloo ranks on the CPU) vs the JAX package's single process.

The ranks (``tests/_torch_mesh_worker.py``, suite ``tp``) start once for
the file and run every case; the JAX references are computed here while
they run, on the same seeded weights (JAX's init, converted with the
port's converter) and batches.  The counterparts of
``test_parallel.py:119-233, :366-397`` (TP, FSDP, TP + FSDP, the
classifier step, the vocab-extended embedding), ``test_lora.py:113-160``
(the LoRA step), ``test_moe.py:227-400`` (expert parallelism, dense and
sparse), ``test_multihost.py:99-133`` (the hybrid step) and the
two-process hybrid test (``test_multihost.py:185-258``: the loss within
1e-4, ``host_fetchable``, a save and resume of the shards, TP greedy
decode == single-process greedy).

Tolerances are JAX's: losses rtol 1e-5, parameters atol 1e-4, gradients
atol 2e-5.  Every train step's gradients are held before its update
(reduced over the data axes and all-gathered, against the gradients the
JAX step handed its optimizer): a gradient doubled, halved or lost fails
there, which Adam's scale invariance hides from the parameters.  The
steps run AdamW at lr 1e-2 (JAX's ``test_parallel.py``), so a parameter
left unchanged is about 1e-2 off; its first update is
``lr * g / (|g| + eps)``, which gives a gradient at float32 roundoff
(|g| < 1e-6) the noise's sign, so those elements alone are left out of
the parameter check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as tm
import _torch_parity as tp

VOCAB = 256
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
GRAD_TOL = 2e-5
LR = 1e-2
ROUNDOFF = 1e-6  # |g| below it: summation noise, whose sign Adam's first step takes
# the MLLM steps train the projector and the LM embedding (the hybrid test's
# setting); the gradients are held for every parameter
SETTING = "language_embed_only"


def _jax_mllm_cfg(lora_rank=0):
    from multimodal_concept_learning_tpu.models import LMConfig, MLLMConfig, ViTConfig

    vision = ViTConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, patch_size=8, image_size=32,
                       num_labels=0, dtype=jnp.float32)
    lm = dataclasses.replace(LMConfig.preset("nano", vocab_size=VOCAB), dtype=jnp.float32,
                             lora_rank=lora_rank)
    return MLLMConfig(vision=vision, lm=lm, num_vision_tokens=17, max_answer_tokens=4,
                      dtype=jnp.float32)


def _batch(cfg, batch=8, text_len=16, seed=0, answers=(5, 6)):
    rng = np.random.default_rng(seed)
    nvt = cfg.num_vision_tokens
    t = nvt + text_len
    images = rng.normal(size=(batch, 3, 32, 32)).astype(np.float32)
    ids = np.zeros((batch, t), dtype=np.int32)
    ids[:, nvt:] = rng.integers(4, VOCAB - 4, size=(batch, text_len))
    labels = np.full((batch, t), -100, dtype=np.int32)
    for a in answers:
        labels[:, nvt + a] = ids[:, nvt + a]
    return {"images": images, "input_ids": ids, "attention_mask": np.ones_like(ids),
            "labels": labels}


def _port_cfg(jcfg):
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    p = tp.port_config(jcfg)
    return MLLMConfig(vision=p.vision, lm=p.lm, num_vision_tokens=jcfg.num_vision_tokens,
                      max_answer_tokens=jcfg.max_answer_tokens, dtype=torch.float32)


def _recording(tx):
    """``tx`` that also keeps, in its state, the gradients it was handed."""
    import optax

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _jax_train(make_step, model, params, batch, tx):
    """One JAX train step: (loss, the updated params, the step's gradients)."""
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState

    tx = _recording(tx)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    state, m = make_step(model, tx)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    return float(m["loss"]), state.params, state.opt_state[0]


def _jax_step(model, params, batch, lr, setting=None, **hp):
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu.parallel import build_optimizer, make_mllm_train_step

    mask = trainable_mask(params, setting) if setting else None
    return _jax_train(make_mllm_train_step, model, params, batch,
                      build_optimizer(lr, trainable_mask=mask, **hp))


def _jax_sharded_contrastive(c):
    """JAX ``contrastive_loss`` with ``axis_name`` over 4 virtual devices:
    each shard's loss, and the gradients of their sum."""
    from jax.sharding import Mesh, PartitionSpec as P

    from multimodal_concept_learning_tpu.models.clip import contrastive_loss

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    per_shard = shard_map(
        lambda i, t: contrastive_loss(i, t, jnp.float32(c["scale"]), "data")[None],
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"))
    losses = per_shard(jnp.asarray(c["img"]), jnp.asarray(c["txt"]))
    grads = jax.grad(lambda i, t: per_shard(i, t).sum(), argnums=(0, 1))(
        jnp.asarray(c["img"]), jnp.asarray(c["txt"]))
    return np.asarray(losses), [np.asarray(g) for g in grads]


def _sd(params, converter):
    return {k: v.float().numpy() for k, v in converter(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from multimodal_concept_learning_tpu.models import MLLM
    from multimodal_concept_learning_tpu.models.lm import CausalLM
    from multimodal_concept_learning_tpu.models.mllm import greedy_generate
    from multimodal_concept_learning_tpu.models.vit import ViTConfig, ViTForImageClassification
    from multimodal_concept_learning_tpu.parallel import build_optimizer
    from multimodal_concept_learning_tpu.parallel import make_classifier_train_step
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        lm_state_dict_from_jax,
        state_dict_from_jax,
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.lm import LMConfig as PortLM
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig as PortViT

    workdir = tmp_path_factory.mktemp("tp")
    procs = tm.start("tp", 4, workdir)

    mllm_sd = lambda p: _sd(p, lambda q: state_dict_from_jax(q, 8))  # noqa: E731
    jcfg = _jax_mllm_cfg()
    model = MLLM(jcfg)
    batch = _batch(jcfg)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(model.init)(jax.random.key(0), j["images"], j["input_ids"],
                                 j["attention_mask"], j["labels"])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)  # the JAX steps donate their inputs
    sd = {k: torch.from_numpy(v) for k, v in mllm_sd(params).items()}
    hp = dict(weight_decay=1e-4, max_grad_norm=1.0)

    # the classifier (dropout 0: deterministic)
    ccfg = ViTConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, patch_size=8, image_size=32, num_labels=4,
                     dtype=jnp.float32)
    cmodel = ViTForImageClassification(ccfg)
    cparams = jax.tree_util.tree_map(np.asarray, jax.jit(cmodel.init)(
        jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"])
    cbatch = {"images": np.random.default_rng(0).normal(size=(16, 3, 32, 32)).astype(np.float32),
              "labels": np.arange(16, dtype=np.int32) % 4}
    port_ccfg = PortViT(**{f.name: getattr(ccfg, f.name) for f in dataclasses.fields(PortViT)
                           if f.name != "dtype"}, dtype=torch.float32)

    # LoRA
    lcfg = _jax_mllm_cfg(lora_rank=4)
    lmodel = MLLM(lcfg)
    lbatch = _batch(lcfg, seed=3, answers=(5,))
    lj = {k: jnp.asarray(v) for k, v in lbatch.items()}
    lparams = jax.jit(lmodel.init)(jax.random.key(0), lj["images"], lj["input_ids"],
                                   lj["attention_mask"], lj["labels"])["params"]
    lparams = jax.tree_util.tree_map(np.asarray, lparams)

    # expert parallelism
    ep = {}
    for case, dispatch in (("ep_dense", {}), ("ep_sparse", dict(moe_dispatch="sparse",
                                                                 moe_capacity_factor=2.0))):
        from multimodal_concept_learning_tpu.models.lm import LMConfig

        ecfg = dataclasses.replace(LMConfig.preset("nano", vocab_size=61), dtype=jnp.float32,
                                   moe_experts=4, moe_top_k=2, **dispatch)
        seed = 3 if case == "ep_dense" else 7
        ids = np.random.default_rng(seed).integers(1, 61, size=(4, 6)).astype(np.int32)
        elm = CausalLM(ecfg)
        eparams = elm.init(jax.random.key(seed), jnp.asarray(ids), jnp.ones_like(ids))["params"]
        pcfg = PortLM(**{f.name: getattr(ecfg, f.name) for f in dataclasses.fields(PortLM)
                         if f.name != "dtype"}, dtype=torch.float32)
        ep[case] = dict(model=elm, params=eparams, ids=ids, cfg=pcfg,
                        sd={k: torch.from_numpy(v) for k, v in
                            _sd(eparams, lm_state_dict_from_jax).items()})

    # CLIP: the vision tower's MLP takes TP; random captions of ragged length
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JCLIPConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JCLIP
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig

    clip_kw = dict(image_size=32, text_width=32, text_layers=1, text_heads=2, context_length=16,
                   embed_dim=16)
    jclip_cfg = JCLIPConfig.create(vocab_size=64, vision_preset="vit-t-8", **clip_kw)
    jclip_cfg = dataclasses.replace(jclip_cfg, dtype=jnp.float32, vision=dataclasses.replace(
        jclip_cfg.vision, dtype=jnp.float32))
    jclip = JCLIP(jclip_cfg)
    crng = np.random.default_rng(6)
    cmask = np.ones((8, 16), np.int32)
    for r, n in enumerate([16, 9, 12, 5, 16, 7, 14, 3]):
        cmask[r, n:] = 0
    clip_batch = {"images": crng.standard_normal((8, 3, 32, 32)).astype(np.float32),
                  "input_ids": (crng.integers(1, 64, (8, 16)) * cmask).astype(np.int32),
                  "attention_mask": cmask}
    clip_params = jax.tree_util.tree_map(np.asarray, jax.jit(jclip.init)(
        jax.random.key(4), jnp.zeros((1, 3, 32, 32)), jnp.zeros((1, 16), jnp.int32),
        jnp.ones((1, 16), jnp.int32))["params"])
    clip_hp = dict(weight_decay=0.2, max_grad_norm=1.0)

    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 8, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    clip_loss = dict(img=feats[0], txt=feats[1], scale=14.285714)

    tm.write_inputs(workdir, {
        "mllm": dict(cfg=_port_cfg(jcfg), sd=sd, batch=batch, lr=LR, hp=hp,
                     setting=SETTING),
        "classifier": dict(cfg=port_ccfg, sd={k: torch.from_numpy(v) for k, v in _sd(
            cparams, lambda q: vit_classifier_state_dict_from_jax(q, 8)).items()},
            batch=cbatch, lr=LR, hp=hp),
        "lora": dict(cfg=_port_cfg(lcfg), sd={k: torch.from_numpy(v) for k, v in
                                               mllm_sd(lparams).items()},
                     batch=lbatch, lr=LR, hp=hp),
        **{case: dict(cfg=e["cfg"], sd=e["sd"], ids=e["ids"]) for case, e in ep.items()},
        "hybrid": dict(cfg=_port_cfg(jcfg), sd=sd, batch=batch, lr=LR, hp=hp, n_new=3,
                       setting=SETTING),
        "ckpt_dir": str(workdir / "ckpt"),
        "clip_loss": clip_loss,
        "clip": dict(cfg=CLIPConfig.create(vocab_size=64, vision_preset="vit-t-8",
                                           dtype=torch.float32, **clip_kw),
                     sd=clip_state_dict_from_jax(clip_params, 8), batch=clip_batch, lr=LR,
                     hp=clip_hp),
    })

    # the JAX references, while the ranks run
    ref = {}
    ref["mllm"] = ref["hybrid"] = _jax_step(model, params, batch, LR, SETTING, **hp)

    def loss_fn(p):
        return model.apply({"params": p}, j["images"], j["input_ids"], j["attention_mask"],
                           j["labels"])["loss"]

    ref["grads"] = mllm_sd(jax.jit(jax.grad(loss_fn))(params))
    ref["decode"] = np.asarray(greedy_generate(model, params, j["images"], j["input_ids"],
                                               j["attention_mask"], 3))
    ref["lora"] = _jax_step(lmodel, lparams, lbatch, LR, "language_lora", **hp)
    ref["classifier"] = _jax_train(make_classifier_train_step, cmodel, cparams, cbatch,
                                   build_optimizer(LR, **hp))
    for case, e in ep.items():
        ids = jnp.asarray(e["ids"])

        def eloss(p, elm=e["model"], ids=ids):
            return (elm.apply({"params": p}, ids, jnp.ones_like(ids)).astype(jnp.float32)
                    ** 2).mean()

        loss, grads = jax.jit(jax.value_and_grad(eloss))(e["params"])
        ref[case] = (float(loss), _sd(grads, lm_state_dict_from_jax))
    ref["clip_loss"] = _jax_sharded_contrastive(clip_loss)
    from multimodal_concept_learning_tpu.train.contrastive_training import make_clip_train_step

    clip_loss_, clip_new, clip_grads = _jax_train(make_clip_train_step, jclip, clip_params,
                                                  clip_batch, build_optimizer(LR, **clip_hp))
    clip_sd = lambda p: _sd(p, lambda q: clip_state_dict_from_jax(q, 8))  # noqa: E731
    classifier_sd = lambda p: _sd(  # noqa: E731
        p, lambda q: vit_classifier_state_dict_from_jax(q, 8))
    ref["clip"] = (clip_loss_,)
    ref["params"] = dict(mllm=mllm_sd(ref["mllm"][1]), hybrid=mllm_sd(ref["hybrid"][1]),
                         lora=mllm_sd(ref["lora"][1]),
                         classifier=classifier_sd(ref["classifier"][1]),
                         clip=clip_sd(clip_new), lora_before=mllm_sd(lparams))
    ref["before"] = dict(mllm=mllm_sd(params), hybrid=mllm_sd(params), lora=mllm_sd(lparams),
                         classifier=classifier_sd(cparams), clip=clip_sd(clip_params))
    ref["step_grads"] = dict(mllm=mllm_sd(ref["mllm"][2]), hybrid=mllm_sd(ref["hybrid"][2]),
                             lora=mllm_sd(ref["lora"][2]),
                             classifier=classifier_sd(ref["classifier"][2]),
                             clip=clip_sd(clip_grads))
    return tm.collect(procs, workdir), ref


# each step case's JAX reference
REF = {"tp": "mllm", "fsdp": "mllm", "tp_fsdp": "mllm", "classifier": "classifier",
       "lora": "lora", "hybrid_fsdp": "hybrid", "hybrid_replica": "hybrid", "clip": "clip"}


def _close_params(got, ref, which, tol=PARAM_TOL):
    """The parameters after one step within ``tol`` of JAX's, except where
    JAX's gradient is at roundoff.  Each tensor's elements held moved by
    more than 10 ``tol`` in JAX's step, or not at all (a frozen tensor), so
    an update left out fails."""
    want, before, grads = (ref[k][which] for k in ("params", "before", "step_grads"))
    assert set(got) == set(want)
    for k in want:
        keep = np.abs(grads[k]) >= ROUNDOFF
        moved = np.abs(want[k] - before[k])[keep]
        assert np.all(moved > 10 * tol) or not moved.any(), k
        np.testing.assert_allclose(got[k][keep], want[k][keep], atol=tol, err_msg=k)


@pytest.mark.parametrize("case", ["tp", "fsdp", "tp_fsdp"])
def test_mllm_step_matches_single_device(run, case):
    """TP on (2 data x 2 model), FSDP on 4 data ranks, both on (2, 2)."""
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r[case]["loss"], ref["mllm"][0], rtol=LOSS_RTOL)
    _close_params(ranks[0][case]["params"], ref, "mllm")


def test_tensor_parallel_shards_embedding_and_mlp(run):
    ranks, _ = run
    specs = ranks[0]["tp"]["specs"]
    model_sharded = [n for n, s in specs.items() if "model" in str(s)]
    assert any("embed_tokens" in n for n in model_sharded)
    assert any("gate_proj" in n for n in model_sharded)
    assert ranks[0]["tp"]["emb_tp"] and ranks[0]["tp"]["emb_rows"] == VOCAB // 2


def test_fsdp_holds_a_quarter_of_the_embedding(run):
    ranks, _ = run
    specs = ranks[0]["fsdp"]["specs"]
    assert "data" in str(specs["language_model.model.embed_tokens.weight"])
    assert any("gate_proj" in n and "data" in str(s) for n, s in specs.items())
    assert all(r["fsdp"]["emb_rows"] == VOCAB // 4 for r in ranks)


def test_fsdp_composes_with_tensor_parallel_and_extends_vocab(run):
    ranks, _ = run
    specs = ranks[0]["tp_fsdp"]["specs"]
    gate = specs["language_model.model.layers.0.mlp.gate_proj.weight"]
    assert "model" in str(gate) and "data" in str(gate)
    assert specs["language_model.model.embed_tokens.weight"] == (("model", "data"), None)
    assert all(r["tp_fsdp"]["emb_rows"] == VOCAB // 4 for r in ranks)


def test_sharded_gradients_match_jax(run):
    ranks, ref = run
    got, want = ranks[0]["grads"], ref["grads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL, err_msg=k)


def test_classifier_step_runs_sharded(run):
    ranks, ref = run
    for r in ranks:
        assert r["classifier"]["count"] == 16 and r["classifier"]["tp"]
        np.testing.assert_allclose(r["classifier"]["loss"], ref["classifier"][0], rtol=LOSS_RTOL)
    _close_params(ranks[0]["classifier"]["params"], ref, "classifier")


def test_lora_step_sharded_matches_single_device(run):
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["lora"]["loss"], ref["lora"][0], rtol=LOSS_RTOL)
    got, before = ranks[0]["lora"]["params"], ref["params"]["lora_before"]
    _close_params(got, ref, "lora")
    moved = [k for k in got if "_lora." in k and np.abs(got[k] - before[k]).max() > 0]
    frozen = [k for k in got if "_lora." not in k and not k.startswith("projector")]
    assert moved and all(np.array_equal(got[k], before[k]) for k in frozen)


@pytest.mark.parametrize("case", ["ep_dense", "ep_sparse"])
def test_expert_parallel_matches_single_device(run, case):
    ranks, ref = run
    loss, grads = ref[case]
    for r in ranks:
        assert r[case]["local_experts"] == 2  # 4 experts over a 2-way model axis
        np.testing.assert_allclose(r[case]["loss"], loss, rtol=LOSS_RTOL)
    got = ranks[0][case]["grads"]
    for k in grads:
        np.testing.assert_allclose(got[k], grads[k], atol=GRAD_TOL, err_msg=k)


def test_hybrid_mesh_shape_axes_and_stripes(run):
    ranks, _ = run
    one, two = ranks[0]["hybrid_fsdp"], ranks[0]["hybrid_replica"]
    assert one["axes"] == two["axes"] == ("replica", "data", "model")
    assert one["shape"] == (1, 2, 2) and two["shape"] == (2, 1, 2)
    assert one["dp_axes"] == two["dp_axes"] == ("replica", "data")
    # ranks (r, d, m) row-major: the stripe is the (replica, data) index
    assert [r["hybrid_replica"]["stripe"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert [r["hybrid_fsdp"]["stripe"] for r in ranks] == [(0, 2), (0, 2), (1, 2), (1, 2)]


@pytest.mark.parametrize("case", ["hybrid_fsdp", "hybrid_replica"])
def test_hybrid_step_matches_single_device(run, case):
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r[case]["loss"], ref["hybrid"][0], rtol=LOSS_RTOL)
    _close_params(ranks[0][case]["params"], ref, "hybrid")


def test_multi_rank_hybrid_training_save_and_decode(run):
    """The two-process hybrid test's counterpart: the loss within 1e-4,
    full finite leaves, the shards saved by rank 0 and restored bitwise,
    TP greedy decode == single-process greedy."""
    ranks, ref = run
    for r in ranks:
        assert abs(r["hybrid_fsdp"]["loss"] - ref["hybrid"][0]) < 1e-4
        sr = r["save_restore"]
        assert sr["finite"] and sr["step"] == 1 and sr["bitwise"] and sr["shapes_kept"]
        np.testing.assert_array_equal(r["decode"], ref["decode"])


def test_collectives_are_counted(run):
    ranks, _ = run
    counts = ranks[0]["counts"]
    for op in ("all_reduce", "all_gather", "reduce_scatter"):
        assert counts.get(op, 0) > 0, counts


def test_contrastive_loss_over_a_striped_batch(run):
    """``contrastive_loss(..., group)``: each rank's rows against the
    gathered global batch equal JAX's per-shard loss under ``axis_name``,
    and the gradients the gather's backward sums equal JAX's."""
    ranks, ref = run
    losses, (img_grad, txt_grad) = ref["clip_loss"]
    for r, res in enumerate(ranks):
        got = res["clip_loss"]
        np.testing.assert_allclose(got["loss"], losses[r], rtol=1e-6)
        np.testing.assert_allclose(got["img_grad"], img_grad[2 * r:2 * r + 2], atol=1e-6)
        np.testing.assert_allclose(got["txt_grad"], txt_grad[2 * r:2 * r + 2], atol=1e-6)


def test_clip_step_runs_sharded(run):
    """``make_clip_train_step`` on (2 data x 2 model) with FSDP: the vision
    tower's MLP tensor parallel, InfoNCE over the gathered data stripes."""
    ranks, ref = run
    for r in ranks:
        np.testing.assert_allclose(r["clip"]["loss"], ref["clip"][0], rtol=LOSS_RTOL)
    _close_params(ranks[0]["clip"]["params"], ref, "clip")


@pytest.mark.parametrize("case", sorted(REF))
def test_step_gradients_match_jax(run, case):
    """The gradients each sharded train step handed its optimizer (summed
    over the data axes, the partial sums of a replicated LoRA ``b`` over
    the model axis, all-gathered) equal those of JAX's step, tensor by
    tensor: the trained ones, none missing."""
    ranks, ref = run
    got, want = ranks[0][case]["step_grads"], ref["step_grads"][REF[case]]
    moved = {k for k, v in ref["params"][REF[case]].items() if k not in ref["before"][REF[case]]
             or not np.array_equal(v, ref["before"][REF[case]][k])}
    assert got and set(got) <= set(want) and moved <= set(got)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL, err_msg=k)
