"""A whole run at tiny sizes on the CPU (the look for a card skipped), once
sound and once with the timed path broken underneath in each way the cell
can be: ``correct`` comes out true, then false."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tiny import TINY_LIMITS, tiny_config


def _run(name, seed=13):
    man = harness.manifest()
    cfg = tiny_config(harness.workload(man, name)["config"])
    return harness.run(name, seed, 0.2, False, "cpu", time.perf_counter(), man, cfg,
                       TINY_LIMITS[name])


def _frozen(monkeypatch):
    """A step that returns its state unchanged: the optimizer takes the
    gradients and updates nothing."""
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import Optimizer

    def step(self):
        for p in self.params.values():
            p.grad = None
        return False

    monkeypatch.setattr(Optimizer, "step", step)


def _half_batch(monkeypatch, maker):
    """Half of each batch left out, the mean taken over the rest."""
    from multimodal_concept_learning_tpu_torch.parallel import train_step

    make = getattr(train_step, maker)

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(state, batch, *rest):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()}, *rest)
        return half

    monkeypatch.setattr(train_step, maker, broken)


def _row_altered(monkeypatch, cls, method):
    """The first row's answer replaced by the second's, where it is made."""
    original = getattr(cls, method)

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        return torch.cat([out[1:2], out[1:]])

    monkeypatch.setattr(cls, method, altered)


TRAIN = [("clip_b32_train", "make_clip_train_step"),
         ("vit_b16_train", "make_classifier_train_step")]


@pytest.mark.parametrize("name", [n for n, _ in TRAIN] + ["vit_b16_eval", "clip_b32_zeroshot"])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert [k for k in r if not k.startswith("_")][-1] == "check"


@pytest.mark.parametrize("name", [n for n, _ in TRAIN])
def test_train_state_unchanged_is_not_correct(name, monkeypatch):
    _frozen(monkeypatch)
    r = _run(name)
    assert not r["correct"]
    assert r["check"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name,maker", TRAIN + [("vit_b16_eval", "make_classifier_eval_step"),
                                                ("clip_b32_zeroshot", "make_zero_shot_step")])
def test_half_batch_is_not_correct(name, maker, monkeypatch):
    _half_batch(monkeypatch, maker)
    assert not _run(name)["correct"]


def test_classifier_answer_altered_is_not_correct(monkeypatch):
    from multimodal_concept_learning_tpu_torch.models.vit import ViTForImageClassification

    _row_altered(monkeypatch, ViTForImageClassification, "forward")
    assert not _run("vit_b16_eval")["correct"]


def test_zero_shot_answer_altered_is_not_correct(monkeypatch):
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel

    _row_altered(monkeypatch, CLIPModel, "encode_image")
    assert not _run("clip_b32_zeroshot")["correct"]
