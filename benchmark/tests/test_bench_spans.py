"""The readers of the program's spans and counters (``spans.py`` and the
five ``metrics/`` files that use it): on a traced run at tiny sizes on the
CPU each gives a finite value; on the card (``chip``) the sync counter
reads 1 for each planted kind of host sync, and 0 where none is planted."""

import math
import time

import pytest
import torch

from benchmark import harness
from benchmark.tiny import TINY_LIMITS, tiny_config

READERS = ["forward_ms_per_step", "backward_ms_per_step", "optimizer_ms_per_step",
           "attention_host_ms_per_step", "host_syncs_per_step"]


@pytest.fixture
def recorder(monkeypatch):
    from multimodal_concept_learning_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "recorder", rec)
    return rec


@pytest.mark.parametrize("name", ["clip_b32_train", "vit_b16_train", "vit_b16_eval",
                                  "clip_b32_zeroshot"])
def test_readers_give_finite_values_on_a_traced_rehearsal(name, recorder):
    man = harness.manifest()
    cfg = tiny_config(harness.workload(man, name)["config"])
    result = harness.run(name, 2 ** 31 + 9, 0.2, True, "cpu", time.perf_counter(), man, cfg,
                         TINY_LIMITS[name])
    traffic = harness.load_json(harness.HERE, "traffic",
                                f"{harness.workload(man, name)['traffic']}.json")
    assert recorder.sessions() == {1: traffic["trace_steps_card"], 2: traffic["trace_steps_host"]}
    mode = ".train" if traffic["kind"] == "train" else ".eval"
    for reader in READERS:
        metric = reader + mode
        listed = [m for m in man["per_layer"] if m["name"] == metric]
        assert bool(listed) == (mode == ".train" or reader not in (
            "backward_ms_per_step", "optimizer_ms_per_step")), metric
        if listed:
            value = result["metrics"][metric]["value"]
            assert math.isfinite(value) and value >= 0.0, (metric, value)
    assert result["metrics"]["host_syncs_per_step" + mode]["value"] == 0.0


class _ItemInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g * 2


@pytest.mark.chip
@pytest.mark.parametrize("plant", ["none", "item_in_forward", "pageable_copy",
                                   "item_in_backward"])
def test_planted_host_sync_is_counted_once(plant, card, recorder):
    from multimodal_concept_learning_tpu_torch.utils import profiling

    x = torch.randn(256, 256, device=card, requires_grad=True)
    torch.cuda.synchronize()
    with profiling.recording():
        with profiling.span("step", 0):
            with profiling.span("forward"):
                y = x @ x
                if plant == "item_in_forward":
                    y.sum().item()
                elif plant == "pageable_copy":
                    y = y + torch.tensor(1.0).to(card)
                elif plant == "item_in_backward":
                    y = _ItemInBackward.apply(y)
                loss = y.float().square().mean()
            with profiling.span("backward"):
                loss.backward()
    torch.cuda.synchronize()
    (row,) = recorder.rows()
    assert row["counters"]["host_syncs"] == (0 if plant == "none" else 1), row
    assert torch.cuda.get_sync_debug_mode() == 0
