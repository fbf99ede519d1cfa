"""PyTorch port: resume and preemption (``train/common.py``,
``checkpoint_io.py``) in the three trainer CLIs (CPU, toy sizes).

Each trainer (the vision classifier with dropout 0.1, the MLLM, CLIP) with
``resume: true``, 4 micro-steps an epoch, 2 an update:
- epoch-granular: the MLLM and CLIP train 2 epochs, then the config is
  extended to 4 (their schedules do not depend on the epoch count here: a
  constant rate, a warm-up past the run); the vision classifier's cosine
  schedule does, so its 4-epoch run is killed right after the second
  epoch's checkpoint instead.  The rerun logs "Resuming from epoch 1
  checkpoint", epochs 3 and 4 and no "Epoch 1/4", and its final model and
  optimizer are bitwise those of an uninterrupted 4-epoch run;
- mid-epoch: a preemption after the third micro-step of epoch 2 (between
  the two micro-steps of an accumulation) saves, logs JAX's line and
  returns ``{"preempted": True}``; the rerun skips 3 batches and ends
  bitwise where the uninterrupted run ends.
The MLLM runs map every class to an ``<ood N>`` answer, which draws no
random question.  With yes/no questions a resumed MLLM run draws the
questions of a fresh process, as JAX does (ROADMAP.md, queue C): shown
against the JAX collator.  Also: a torn temporary file is never restored
and the next save deletes it, ``keep`` collects old steps, the
``ResumeManager`` round trip (``tests/test_preemption.py``'s), and a
preemption before the first checkpoint, where JAX raises and the port saves
(queue C).  Preemption is triggered in-process by the guard's flag.
"""

import contextlib
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

COLORS = [[255, 0, 0], [0, 255, 0], [255, 32, 0], [0, 255, 32]]
NAMES = ["r255g0b0", "r0g255b0", "r255g32b0", "r0g255b32"]
TRAINERS = ("vision", "mllm", "clip")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(dataset dir, all-OOD labels mapping, yes/no labels mapping)."""
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )

    root = tmp_path_factory.mktemp("resume")
    cfg = ColorDatasetConfig.from_params({
        "dataset_name": "tiny", "image_size": 32, "colors": COLORS, "radius_range": [4, 10],
        "n_images_per_color": 7, "train_val_test_split": [0.6, 0.2, 0.2],
        "data_dir": str(root), "seed": 0})
    data_dir = generate_color_dataset(cfg, verbose=False)
    ood, yes_no = root / "ood.json", root / "yes_no.json"
    ood.write_text(json.dumps({n: f"<ood {i + 1}>" for i, n in enumerate(NAMES)}))
    yes_no.write_text(json.dumps(dict(zip(NAMES, ["red", "green", "<ood 1>", "<ood 2>"]))))
    return data_dir, str(ood), str(yes_no)


@pytest.fixture(autouse=True)
def _sigterm_restored():
    """A run cut short by an exception leaves its guard's handler behind."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _yaml(path, trainer, data, results, mapping=None, **over):
    data_dir, ood, _ = data
    common = dict(results_dir=str(results), seed=0, batch_size=4, effective_batch_size=8,
                  epochs=4, resume=True, train_transforms=["ToTensor"],
                  val_transforms=["ToTensor"])
    if trainer == "vision":
        cfg = dict(model_name="vit", hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                   num_attention_heads=2, patch_size=8, image_size=32, num_labels=4,
                   hidden_dropout_prob=0.1, attention_dropout_prob=0.1, data_dir=data_dir,
                   dataset_name="color", mapping_path=data_dir, learning_rate=1e-3,
                   weight_decay=0.1, num_workers=2, disable_wandb=True)
    elif trainer == "mllm":
        cfg = dict(mapping_path=os.path.join(data_dir, "train_mapping.csv"),
                   image_root=data_dir, labels_mapping_path=mapping or ood,
                   prompt_template="Is the color of the circle {class_name}?",
                   dataset_name="color_multimodal", vision_model_name="vit-t-8",
                   language_model_name="nano", num_vision_tokens=17, image_size=32,
                   trainable_params_setting="language_embed_only", learning_rate=5e-4,
                   num_workers=2, use_wandb=False)
    else:
        cfg = dict(mapping_path=os.path.join(data_dir, "train_mapping.csv"),
                   image_root=data_dir, caption_template="a circle of color {class_name}",
                   vision_model_name="vit-t-8", image_size=32, text_width=32, text_layers=1,
                   text_heads=2, context_length=16, embed_dim=16, learning_rate=1e-3,
                   warmup_steps=1000)
    cfg.update(common, **over)
    path.write_text("\n".join(f"{k}: {json.dumps(v)}" for k, v in cfg.items()) + "\n")
    return str(path)


def _main(trainer):
    from multimodal_concept_learning_tpu_torch.train import (
        contrastive_training,
        multimodal_training,
        vision_training,
    )

    return {"vision": vision_training, "mllm": multimodal_training,
            "clip": contrastive_training}[trainer]


def _run(trainer, path):
    """(the CLI's return value, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = _main(trainer).main(["--config_path", path, "--device", "cpu"])
    return out, buf.getvalue()


def _state(trainer, out) -> dict:
    """The final model's and optimizer's tensors and counters, flat."""
    state = out[0] if trainer == "mllm" else out["state"]
    flat = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for key in ("mu", "nu", "master", "acc"):
        flat.update({f"{key}.{n}": t for n, t in (opt[key] or {}).items()})
    flat["counters"] = torch.tensor([opt["count"], opt["mini_step"], state.step])
    return flat


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ[:5]


class _Killed(Exception):
    pass


@pytest.mark.parametrize("trainer", TRAINERS)
def test_epoch_resume_equals_uninterrupted(trainer, data, tmp_path, monkeypatch):
    from multimodal_concept_learning_tpu_torch.checkpoint_io import wait_for_checkpoints
    from multimodal_concept_learning_tpu_torch.train.common import ResumeManager

    ref, _ = _run(trainer, _yaml(tmp_path / "a.yaml", trainer, data, tmp_path / "a"))
    path = _yaml(tmp_path / "b.yaml", trainer, data, tmp_path / "b")
    if trainer == "vision":  # killed right after epoch 2's checkpoint
        save = ResumeManager.save

        def save_then_die(self, state, epoch, meta):
            save(self, state, epoch, meta)
            if epoch == 1:
                wait_for_checkpoints()  # killed once epoch 2's checkpoint is on disk
                raise _Killed

        monkeypatch.setattr(ResumeManager, "save", save_then_die)
        with pytest.raises(_Killed):
            _run(trainer, path)
        monkeypatch.undo()
    else:  # 2 epochs, then the same config extended to 4
        _run(trainer, _yaml(tmp_path / "b2.yaml", trainer, data, tmp_path / "b", epochs=2))
    assert sorted(os.listdir(tmp_path / "b" / "resume")) == ["loop_meta.json", "step_0.pt",
                                                             "step_1.pt"]
    out, text = _run(trainer, path)
    assert f"Resuming from epoch 1 checkpoint in {tmp_path / 'b' / 'resume'}\n" in text
    assert "Epoch 3/4" in text and "Epoch 4/4" in text and "Epoch 1/4" not in text
    assert "mid-epoch" not in text
    _assert_bitwise(_state(trainer, out), _state(trainer, ref))


def _guard_after(polls: int):
    """A PreemptionGuard whose flag rises at its ``polls``-th read."""
    from multimodal_concept_learning_tpu_torch.train.common import PreemptionGuard

    class Guard(PreemptionGuard):
        reads = 0

        @property
        def preempted(self):
            Guard.reads += 1
            return Guard.reads >= polls

        @preempted.setter
        def preempted(self, value):
            pass

    return Guard


@pytest.mark.parametrize("trainer", TRAINERS)
def test_mid_epoch_preemption_equals_uninterrupted(trainer, data, tmp_path, monkeypatch):
    ref, _ = _run(trainer, _yaml(tmp_path / "a.yaml", trainer, data, tmp_path / "a", epochs=2))
    path = _yaml(tmp_path / "b.yaml", trainer, data, tmp_path / "b", epochs=2)
    module = _main(trainer)
    with monkeypatch.context() as m:
        m.setattr(module, "PreemptionGuard", _guard_after(4 + 3))  # epoch 2, micro-step 3
        out, text = _run(trainer, path)
    assert out == {"preempted": True}
    assert ("Preempted (SIGTERM): saved mid-epoch checkpoint (epoch 2, batch 3); exiting"
            in text) and "Epoch 2/2" not in text
    resume_dir = tmp_path / "b" / "resume"
    meta = json.loads((resume_dir / "loop_meta.json").read_text())
    assert meta["preempt_epoch"] == 1 and meta["step_in_epoch"] == 3
    saved = torch.load(resume_dir / "step_1.pt", weights_only=True)
    assert saved["optimizer"]["mini_step"] == 1 and saved["step"] == 7  # mid-accumulation
    assert (saved["generator"] is not None) == (trainer == "vision")
    out, text = _run(trainer, path)
    assert (f"Resuming from epoch 1 checkpoint in {resume_dir} (mid-epoch: skipping 3 "
            f"batches)\n") in text
    assert "Epoch 2/2" in text and "Epoch 1/2" not in text
    _assert_bitwise(_state(trainer, out), _state(trainer, ref))
    meta = json.loads((resume_dir / "loop_meta.json").read_text())
    assert "preempt_epoch" not in meta and "step_in_epoch" not in meta


def test_mllm_resume_draws_a_fresh_processes_questions(data, tmp_path, monkeypatch):
    """The collator's question stream (``PCG64(seed)``, made once a process,
    shared by the three loaders) is no part of the checkpoint, in JAX as in
    the port: a run resumed at epoch 2 draws the questions a fresh JAX
    collator draws for epoch 2's samples, not the uninterrupted run's, so its
    final state differs from it."""
    from multimodal_concept_learning_tpu.data.collator import MultimodalCollator as JCollator
    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer

    calls = []
    call = MultimodalCollator.__call__

    def spy(self, batch):
        out = call(self, batch)
        calls.append(([name for _, name in batch], out["input_ids"].copy()))
        return out

    monkeypatch.setattr(MultimodalCollator, "__call__", spy)
    _, _, yes_no = data
    ref, _ = _run("mllm", _yaml(tmp_path / "a.yaml", "mllm", data, tmp_path / "a", yes_no,
                                epochs=2))
    uninterrupted = calls[:]
    _run("mllm", _yaml(tmp_path / "b1.yaml", "mllm", data, tmp_path / "b", yes_no, epochs=1))
    del calls[:]
    out, text = _run("mllm", _yaml(tmp_path / "b.yaml", "mllm", data, tmp_path / "b", yes_no,
                                   epochs=2))
    assert "Resuming from epoch 0 checkpoint" in text
    resumed = calls[:]
    # the resumed process's calls are the uninterrupted run's from epoch 2 on
    # (its train and val batches, then the test batches), with the same samples
    offset = len(uninterrupted) - len(resumed)
    assert offset == 4 + 2 and [n for n, _ in resumed] == [n for n, _ in uninterrupted[offset:]]
    with open(tmp_path / "b.yaml") as f:
        config = MultimodalTrainingConfig.from_params(miniyaml.safe_load(f))
    tokenizer, mapping = build_tokenizer(config)
    fresh = JCollator(tokenizer=tokenizer, num_vision_tokens=17,
                      prompt_template=config.prompt_template, all_class_names=NAMES,
                      labels_mapping=mapping, seed=config.seed)
    image = np.zeros((3, 32, 32), np.float32)
    for names, ids in resumed:
        np.testing.assert_array_equal(ids, fresh([(image, n) for n in names])["input_ids"])
    assert any(not np.array_equal(a, b)
               for (_, a), (_, b) in zip(resumed, uninterrupted[offset:]))
    got, want = _state("mllm", out), _state("mllm", ref)
    assert any(not torch.equal(got[k], want[k]) for k in want)


def test_torn_save_is_ignored_and_keep_collects(tmp_path):
    from multimodal_concept_learning_tpu_torch import checkpoint_io as io_

    d = str(tmp_path / "ck")
    for step in range(5):
        io_.save_checkpoint(d, {"w": torch.full((3,), float(step)), "step": step}, step, keep=3)
    io_.wait_for_checkpoints()
    assert sorted(os.listdir(d)) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    torn = os.path.join(d, "step_9.pt.tmp-4242")
    with open(torn, "wb") as f:
        f.write(b"\x80\x02 torn by a kill")
    state, step = io_.restore_checkpoint(d)
    assert step == 4 and torch.equal(state["w"], torch.full((3,), 4.0)) and state["step"] == 4
    state, step = io_.restore_checkpoint(d, step=2)
    assert step == 2 and torch.equal(state["w"], torch.full((3,), 2.0))
    w = torch.zeros(3)
    io_.save_checkpoint(d, {"w": w}, 5, keep=3)
    w.fill_(7.0)  # the save holds a copy taken when it was called
    io_.wait_for_checkpoints()
    assert sorted(os.listdir(d)) == ["step_3.pt", "step_4.pt", "step_5.pt"]
    assert torch.equal(io_.restore_checkpoint(d)[0]["w"], torch.zeros(3))
    assert io_.restore_checkpoint(str(tmp_path / "none")) == (None, None)


def _toy_state(seed: int):
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import TrainState

    torch.manual_seed(seed)
    model = torch.nn.Linear(3, 2)
    opt = build_optimizer(model, 1e-2, weight_decay=0.1, accumulation_steps=2)
    return TrainState(model=model, optimizer=opt, generator=torch.Generator().manual_seed(seed))


def _advance(state, steps: int):
    for _ in range(steps):
        state.model(torch.randn(4, 3, generator=state.generator)).sum().backward()
        state.optimizer.step()
        state.step += 1
    return state


def test_resume_manager_round_trip(tmp_path):
    """save_preempted -> restore returns the same epoch and skip count and
    the saved state (model, optimizer mid-accumulation, generator); an
    epoch-end save then clears the preemption keys."""
    from multimodal_concept_learning_tpu_torch.train.common import ResumeManager

    rm = ResumeManager(str(tmp_path), enabled=True)
    rm.save(_advance(_toy_state(0), 2), 1, {"best_loss": 0.5})
    late = _advance(_toy_state(0), 3)
    rm.save_preempted(late, 2, 3, {"best_loss": 0.4})
    fresh = _toy_state(1)
    restored, start_epoch, meta = ResumeManager(str(tmp_path), enabled=True).restore(fresh)
    assert restored is fresh and start_epoch == 2 and meta["skip_batches"] == 3
    assert meta["best_loss"] == 0.4 and restored.step == 3
    assert restored.optimizer.mini_step == 1 and restored.optimizer.count == 1
    for a, b in zip(restored.model.parameters(), late.model.parameters()):
        assert torch.equal(a, b)
    for name, t in late.optimizer.acc.items():
        assert torch.equal(restored.optimizer.acc[name], t)
    assert torch.equal(torch.randn(5, generator=restored.generator),
                       torch.randn(5, generator=late.generator))
    rm.save(restored, 2, {"best_loss": 0.3, "skip_batches": 3})
    rm.finalize()
    _, start_epoch, meta = ResumeManager(str(tmp_path), enabled=True).restore(_toy_state(2))
    assert start_epoch == 3 and meta == {"best_loss": 0.3}
    off = ResumeManager(str(tmp_path), enabled=False)
    state = _toy_state(3)
    assert off.restore(state) == (state, 0, {}) and off.save_preempted(state, 0, 1, {}) is False


def test_preemption_before_the_first_checkpoint(tmp_path):
    """Reference, not reproduced (queue C): JAX's ``save_preempted`` writes
    its meta before its directory exists, so a preemption in the first
    epoch raises; the port saves."""
    import jax.numpy as jnp

    from multimodal_concept_learning_tpu.train.common import ResumeManager as JResume
    from multimodal_concept_learning_tpu_torch.train.common import ResumeManager

    with pytest.raises(FileNotFoundError):
        JResume(str(tmp_path / "j"), enabled=True).save_preempted({"w": jnp.zeros(2)}, 0, 1, {})
    rm = ResumeManager(str(tmp_path / "p"), enabled=True)
    assert rm.save_preempted(_toy_state(0), 0, 1, {})
    _, start_epoch, meta = rm.restore(_toy_state(1))
    assert start_epoch == 0 and meta["skip_batches"] == 1
