"""PyTorch port: data-parallel training over ``torch.distributed`` (CPU,
two Gloo ranks) vs the JAX package's single process at the global batch.

The pair of rank processes (``tests/_torch_dp_worker.py``) is started once
for the file and runs every case; the JAX references are computed here
while they run.  Cases:
- one update of each trainer step on the ranks' stripes equals JAX's step
  on the global batch: the MLLM with MoE (dense dispatch, language_only,
  two micro-steps of one accumulated update, answers of 1 token on rank
  0's rows and 3 on rank 1's, the aux's routing means reduced globally),
  the vision classifier at dropout 0, CLIP over the gathered logits;
  losses within 1e-5, parameters within 1e-4; the eval steps on a padded
  global batch (the MLLM's with no valid row on rank 1);
- the ranks' parameters are bitwise equal after every case;
- the DeviceMesh, ``process_local_loader_args``, the divisibility check,
  ``global_batch_from_local``'s check of the non-batch leaves, the
  collectives;
- the three CLIs under the group: only rank 0 writes files; a SIGTERM to
  rank 1 stops both ranks at the same step, and the rerun resumes that
  step on both and ends with equal parameters.
In this process: ``BatchLoader``'s stripes equal the JAX loader's
``process_shard`` stripes, and ``init_distributed`` is a no-op in a plain
process and loud with bad explicit arguments.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
WORLD = 2
HERE = os.path.dirname(os.path.abspath(__file__))
COLORS = [[255, 0, 0], [0, 255, 0], [255, 32, 0], [0, 255, 32]]
NAMES = ["r255g0b0", "r0g255b0", "r255g32b0", "r0g255b32"]
VIT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
           patch_size=8, image_size=32, num_labels=4)
CLIP = dict(image_size=32, text_width=32, text_layers=1, text_heads=2, context_length=16,
            embed_dim=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    noise = lambda x: 0.05 * rng.standard_normal(x.shape).astype(np.float32)  # noqa: E731
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32) + noise(x), params)


# -- the inputs: weights and global batches ---------------------------------------


def _mllm_inputs():
    model, params, port = tp.make_pair(dict(moe_experts=4, moe_top_k=2))
    cfg = model.config
    batches = []
    for i in range(2):
        images, ids, mask = tp.prompt_batch(cfg, [5, 2, 7, 4], seed=20 + i)
        labels = np.full_like(ids, -100)
        for r, m in enumerate(mask.sum(axis=1)):
            n = 1 if r < 2 else 3  # rank 0's rows answer in 1 token, rank 1's in 3
            labels[r, m - n:m] = ids[r, m - n:m]
        batches.append({"images": images, "input_ids": ids, "attention_mask": mask,
                        "labels": labels, "valid": np.ones(4, bool)})
    eval_batch = dict(batches[0], valid=np.asarray([True, True, False, False]))
    hp = dict(weight_decay=1e-2, max_grad_norm=1.0, accumulation_steps=2)
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    return (model, params), dict(cfg=port.cfg, sd=sd, setting="language_only", lr=1e-4, hp=hp,
                                 batches=batches, eval_batch=eval_batch)


def _vision_inputs():
    from multimodal_concept_learning_tpu.models.vit import ViTConfig as JConfig
    from multimodal_concept_learning_tpu.models.vit import ViTForImageClassification as JModel
    from multimodal_concept_learning_tpu_torch.checkpoint import (
        vit_classifier_state_dict_from_jax,
    )
    from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig

    model = JModel(JConfig(**VIT, dtype=jnp.float32))
    params = _perturbed(jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 3, 32, 32))), 1)
    rng = np.random.default_rng(7)
    batch = {"images": rng.standard_normal((4, 3, 32, 32)).astype(np.float32),
             "labels": np.asarray([0, 1, 2, 3], np.int32), "valid": np.ones(4, bool)}
    eval_batch = {"images": rng.standard_normal((6, 3, 32, 32)).astype(np.float32),
                  "labels": np.asarray([1, 0, 3, 2, 1, 0], np.int32),
                  "valid": np.asarray([True, True, True, True, False, False])}
    sd = vit_classifier_state_dict_from_jax(params, VIT["patch_size"])
    return (model, params), dict(cfg=ViTConfig(**VIT, dtype=torch.float32), sd=sd, lr=1e-4,
                                 hp=dict(weight_decay=1e-2, max_grad_norm=1.0),
                                 label_smoothing=0.1, batch=batch, eval_batch=eval_batch)


def _clip_inputs():
    from multimodal_concept_learning_tpu.models.clip import CLIPConfig as JConfig
    from multimodal_concept_learning_tpu.models.clip import CLIPModel as JModel
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig
    from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

    tok = ConceptTokenizer()
    jcfg = JConfig.create(vocab_size=len(tok), vision_preset="vit-t-8", **CLIP)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32,
                               vision=dataclasses.replace(jcfg.vision, dtype=jnp.float32))
    model = JModel(jcfg)
    params = _perturbed(jax.jit(model.init)(jax.random.key(2), jnp.zeros((1, 3, 32, 32)),
                                            jnp.zeros((1, 16), jnp.int32),
                                            jnp.ones((1, 16), jnp.int32))["params"], 2)
    rng = np.random.default_rng(9)
    collator = ClipCollator(tok, "a circle of color {class_name}", 16)
    batch = collator([(rng.random((3, 32, 32)).astype(np.float32), n) for n in NAMES])
    batch["valid"] = np.ones(4, bool)
    cfg = CLIPConfig.create(vocab_size=len(tok), vision_preset="vit-t-8", dtype=torch.float32,
                            **CLIP)
    return (model, params), dict(cfg=cfg, sd=clip_state_dict_from_jax(params, 8), lr=1e-4,
                                 hp=dict(weight_decay=0.2, max_grad_norm=1.0), batch=batch)


def _yaml(path, trainer, data_dir, results, **over):
    common = dict(results_dir=str(results), seed=0, batch_size=4, effective_batch_size=8,
                  epochs=1, train_transforms=["ToTensor"], val_transforms=["ToTensor"])
    if trainer == "vision":
        cfg = dict(model_name="vit", hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=2, patch_size=8, image_size=32, num_labels=4,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1, data_dir=data_dir,
                   dataset_name="color", mapping_path=data_dir, learning_rate=1e-3,
                   weight_decay=0.1, num_workers=1, disable_wandb=True)
    elif trainer == "mllm":
        mapping = os.path.join(os.path.dirname(data_dir), "ood.json")
        cfg = dict(mapping_path=os.path.join(data_dir, "train_mapping.csv"),
                   image_root=data_dir, labels_mapping_path=mapping,
                   prompt_template="Is the color of the circle {class_name}?",
                   dataset_name="color_multimodal", vision_model_name="vit-t-8",
                   language_model_name="nano", num_vision_tokens=17, image_size=32,
                   trainable_params_setting="language_only", learning_rate=5e-4,
                   num_workers=1, use_wandb=False, lm_moe_experts=4)
    else:
        cfg = dict(mapping_path=os.path.join(data_dir, "train_mapping.csv"),
                   image_root=data_dir, caption_template="a circle of color {class_name}",
                   vision_model_name="vit-t-8", image_size=32, text_width=32, text_layers=1,
                   text_heads=2, context_length=16, embed_dim=16, learning_rate=1e-3,
                   warmup_steps=1000)
    cfg.update(common, **over)
    path.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in cfg.items()) + "\n")
    return str(path)


def _cli_inputs(root):
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )

    cfg = ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32, "colors": COLORS, "radius_range": [4, 10],
        "n_images_per_color": 7, "train_val_test_split": [0.6, 0.2, 0.2],
        "data_dir": str(root / "data"), "seed": 0})
    data_dir = generate_color_dataset(cfg, verbose=False)
    (root / "data" / "ood.json").write_text(
        json.dumps({n: f"<ood {i + 1}>" for i, n in enumerate(NAMES)}))
    cli = {t: [_yaml(root / f"{t}_{r}.yaml", t, data_dir, root / f"{t}_r{r}")
               for r in range(WORLD)] for t in ("mllm", "vision", "clip")}
    cli["resume"] = _yaml(root / "resume.yaml", "mllm", data_dir, root / "resume", epochs=2,
                          resume=True)
    return cli


# -- the JAX references -------------------------------------------------------------


def _jax_steps(step_fn, model, params, tx, batches):
    from multimodal_concept_learning_tpu.parallel.train_step import TrainState as JState

    state = JState.create(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = step_fn(model, tx)
    losses = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
        losses.append(m)
    return state, losses


def _references(mllm, vision, clip, mllm_in, vision_in, clip_in):
    from multimodal_concept_learning_tpu.checkpoint.torch_interop import (
        mllm_params_to_torch,
        vit_classifier_params_to_torch,
    )
    from multimodal_concept_learning_tpu.models.mllm import trainable_mask as jmask
    from multimodal_concept_learning_tpu.parallel import train_step as jts
    from multimodal_concept_learning_tpu.parallel.optimizer import build_optimizer as jbuild
    from multimodal_concept_learning_tpu.train.contrastive_training import make_clip_train_step
    from multimodal_concept_learning_tpu_torch.checkpoint import clip_state_dict_from_jax

    ref = {}
    model, params = mllm
    p = params["params"]
    tx = jbuild(1e-4, trainable_mask=jmask(p, "language_only"), **mllm_in["hp"])
    state, ms = _jax_steps(jts.make_mllm_train_step, model, p, tx, mllm_in["batches"])
    ref["mllm_losses"] = [float(m["loss"]) for m in ms]
    ref["mllm_params"] = mllm_params_to_torch(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), state.params), patch_size=8)
    ev = jts.make_mllm_eval_step(model)(state.params, {k: jnp.asarray(v)
                                                       for k, v in mllm_in["eval_batch"].items()})
    ref["mllm_eval_loss"] = float(ev["loss"])

    model, params = vision
    tx = jbuild(1e-4, **vision_in["hp"])
    state, ms = _jax_steps(
        lambda m, t: jts.make_classifier_train_step(m, t, label_smoothing=0.1), model,
        params["params"], tx, [vision_in["batch"]])
    ref["vision_loss"], ref["vision_correct"] = float(ms[0]["loss"]), int(ms[0]["correct"])
    ref["vision_params"] = vit_classifier_params_to_torch(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), state.params), 8)
    ev = jts.make_classifier_eval_step(model, 0.1)(
        state.params, {k: jnp.asarray(v) for k, v in vision_in["eval_batch"].items()})
    ref["vision_eval"] = (float(ev["loss"]), int(ev["correct"]), int(ev["count"]))

    model, params = clip
    tx = jbuild(1e-4, weight_decay=0.2, max_grad_norm=1.0)
    state, ms = _jax_steps(make_clip_train_step, model, params, tx, [clip_in["batch"]])
    ref["clip_loss"] = float(ms[0]["loss"])
    ref["clip_params"] = clip_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), 8)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's results, the JAX references, workdir)."""
    root = tmp_path_factory.mktemp("dp")
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dp_worker.py"),
                               str(r), str(WORLD), port, str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]  # they start up while the inputs are made
    try:
        mllm, mllm_in = _mllm_inputs()
        vision, vision_in = _vision_inputs()
        clip, clip_in = _clip_inputs()
        torch.save({"mllm": mllm_in, "vision": vision_in, "clip": clip_in,
                    "cli": _cli_inputs(root)}, root / "inputs.tmp")
        os.replace(root / "inputs.tmp", root / "inputs.pt")
        ref = _references(mllm, vision, clip, mllm_in, vision_in, clip_in)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs, errors = [], []
    for r in range(WORLD):
        path = root / f"rank{r}.pt"
        out = torch.load(path, weights_only=False) if path.exists() else {"error": "no results"}
        if "error" in out:
            errors.append(f"rank {r}:\n{out['error']}\n{logs[r][-4000:]}")
        outs.append(out)
    assert not errors, "\n".join(errors)
    return outs[0], outs[1], ref, root


# -- the steps against JAX's global batch -------------------------------------------


def _params_close(got, want, what, tol=PARAM_TOL, loose=()):
    assert sorted(got) == sorted(want), what
    for name, p in got.items():
        t = 3e-4 if name.endswith(loose) else tol  # see test_torch_clip's key-bias note
        np.testing.assert_allclose(p.numpy(), np.asarray(want[name], np.float32), atol=t,
                                   rtol=0, err_msg=f"{what} {name}")


def _bitwise_equal(a, b, what):
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), f"{what} {name} differs across ranks"


def test_mllm_moe_step_matches_jax_global_batch(runs):
    r0, r1, ref, _ = runs
    for out in (r0, r1):
        np.testing.assert_allclose(out["mllm_losses"], ref["mllm_losses"], atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(out["mllm_eval_loss"], ref["mllm_eval_loss"], atol=LOSS_TOL,
                                   rtol=0)
    _params_close(r0["mllm_params"], ref["mllm_params"], "mllm")
    _bitwise_equal(r0["mllm_params"], r1["mllm_params"], "mllm")


def test_vision_step_matches_jax_global_batch(runs):
    r0, r1, ref, _ = runs
    for out in (r0, r1):
        np.testing.assert_allclose(out["vision_loss"], ref["vision_loss"], atol=LOSS_TOL, rtol=0)
        assert out["vision_correct"] == ref["vision_correct"]
        np.testing.assert_allclose(out["vision_eval"][0], ref["vision_eval"][0], atol=LOSS_TOL,
                                   rtol=0)
        assert out["vision_eval"][1:] == ref["vision_eval"][1:]
    _params_close(r0["vision_params"], ref["vision_params"], "vision")
    _bitwise_equal(r0["vision_params"], r1["vision_params"], "vision")


def test_clip_step_matches_jax_global_batch(runs):
    r0, r1, ref, _ = runs
    for out in (r0, r1):
        np.testing.assert_allclose(out["clip_loss"], ref["clip_loss"], atol=LOSS_TOL, rtol=0)
    want = {k: v.numpy() for k, v in ref["clip_params"].items()}
    _params_close(r0["clip_params"], want, "clip", loose=("key.bias", ".k.bias"))
    _bitwise_equal(r0["clip_params"], r1["clip_params"], "clip")


def test_mesh_and_collectives(runs):
    r0, r1, _, _ = runs
    assert r0["mesh"] == r1["mesh"] == ((0, 1), ("data",))
    assert r0["loader_args"] == (4, (0, 2)) and r1["loader_args"] == (4, (1, 2))
    assert "must divide across 2 processes" in r0["odd_batch"]
    assert r0["same_leaves"] == (2, 4, 4, 3)
    for out in (r0, r1):
        assert "non-batch leaves differ across ranks: ['norm_mean']" in out["differing_leaves"]
        assert out["any_rank"] == (True, False) and out["broadcast"] == "from rank 0"


# -- the CLIs under the group -------------------------------------------------------


def _files(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


@pytest.mark.parametrize("trainer,expect", [
    ("mllm", ["models/best_model.pt", "models/initial_model.pt", "models/training_config.json"]),
    ("vision", ["models/best_model.pt", "models/final_model.pt"]),
    ("clip", ["checkpoints/step_4.pt"]),
])
def test_only_rank_zero_writes(runs, trainer, expect):
    """Each rank ran the CLI with its own results dir: rank 1's holds
    nothing; both ranks end with the same weights; rank 0 alone logs."""
    r0, r1, _, root = runs
    assert not os.path.exists(root / f"{trainer}_r1") or _files(root / f"{trainer}_r1") == []
    files = _files(root / f"{trainer}_r0")
    assert all(f in files for f in expect), files
    (s0, p0, log0), (s1, p1, log1) = r0[f"cli_{trainer}"], r1[f"cli_{trainer}"]
    assert s0 == s1 == 4 and "distributed: process 0/2" in log0
    _bitwise_equal(p0, p1, trainer)
    assert "Epoch 1/1 completed" in log0 and "Epoch 1/1 completed" not in log1


def test_sigterm_to_one_rank_stops_both_and_resume_agrees(runs):
    r0, r1, _, root = runs
    (res0, steps0, log0), (res1, steps1, log1) = r0["preempted"], r1["preempted"]
    assert res0 == res1 == {"preempted": True} and steps0 == steps1 == 2
    meta = r0["preempted_meta"]  # as the preempted run left it
    assert meta["preempt_epoch"] == 0 and meta["step_in_epoch"] == 2
    (s0, p0, log0), (s1, p1, log1) = r0["resumed"], r1["resumed"]
    for log in (log0, log1):
        assert "(mid-epoch: skipping 2 batches)" in log
    assert s0 == s1 == 8  # 2 epochs of 4 global batches
    _bitwise_equal(p0, p1, "resumed mllm")


# -- in this process ----------------------------------------------------------------


class _Items:
    """A map-style dataset of (index image, index label)."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return np.full((1, 2, 2), i, np.float32), i


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_loader_stripes_match_jax(shuffle, drop_last):
    from multimodal_concept_learning_tpu.data.pipeline import BatchLoader as JLoader
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader

    for rank in range(WORLD):
        kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last, seed=5, num_workers=1,
                  process_shard=(rank, WORLD))
        ref, out = JLoader(_Items(), **kw), BatchLoader(_Items(), **kw)
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            out.set_epoch(epoch)
            rb, ob = list(ref), list(out)
            assert len(ob) == len(rb) == len(out) == len(ref)
            for a, b in zip(rb, ob):
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    with pytest.raises(ValueError, match="not in"):
        BatchLoader(_Items(), 2, process_shard=(2, 2))


def test_init_distributed_single_process_and_bad_arguments(monkeypatch):
    from multimodal_concept_learning_tpu_torch.parallel import multihost
    from multimodal_concept_learning_tpu_torch.train.common import (
        mesh_for_batch,
        process_local_loader_args,
    )

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed("cpu") is False
    assert not multihost.is_distributed() and multihost.is_main_process()
    assert process_local_loader_args(8) == (8, None) and mesh_for_batch(3) is None
    with pytest.raises(ValueError, match=r"rank 5 not in \[0, 2\)"):
        multihost.init_distributed("cpu", init_method="tcp://localhost:1", world_size=2, rank=5)
    with pytest.raises(ValueError, match="device_type"):
        multihost.init_distributed("tpu", world_size=1, rank=0)
    with pytest.raises(Exception, match="rendezvous"):
        multihost.init_distributed("cpu", init_method="bogus://x", world_size=1, rank=0)
    assert not multihost.is_distributed()
    x = torch.ones(3)
    assert multihost.all_reduce_sum(x) is x and multihost.gather_rows(x) is x
    assert multihost.any_rank(True) and multihost.broadcast(7) == 7


@pytest.mark.parametrize("shape,shards,factor", [
    ((8, 3), 4, 1), ((6,), 4, 1), ((3,), 2, 2), ((), 2, 1), ((0, 2), 2, 1), ((5, 2), 5, 1),
])
def test_batch_leaf_policy_matches_jax(shape, shards, factor):
    """``mesh.is_batch_leaf`` / ``leaf_sharding``: the JAX shard-or-replicate rule."""
    from multimodal_concept_learning_tpu.parallel.mesh import is_batch_leaf as jax_rule
    from multimodal_concept_learning_tpu_torch.parallel.mesh import is_batch_leaf, leaf_sharding

    leaf = np.zeros(shape, np.float32)
    want = jax_rule(leaf, shards, global_rows_factor=factor)
    assert is_batch_leaf(leaf, shards, global_rows_factor=factor) == want
    if factor == 1:
        assert leaf_sharding(leaf, shards) == ("shard" if want else "replicate")
