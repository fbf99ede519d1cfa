"""PyTorch port: the program's spans and counters (``utils/profiling.py``)
on the CPU.  With nothing listening a span opens no profiler range and
records nothing; under the profiler the train steps give one row each,
whose spans are the profiler's events around the ops they ran, on the
profiler's clock; sessions, nesting, the optimizer's phases, the data
wait, the launch and sync counters; ``trace`` writes ``spans.json``; and
the spans leave the benchmark's aten op count as it was.
"""

import json
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_concept_learning_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test (spans and the profiler's start hook
    read the module's)."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "recorder", rec)
    return rec


def _classifier_step(accumulation=1):
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_classifier_train_step,
    )

    torch.manual_seed(0)
    model = ViTForImageClassification(ViTConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
        patch_size=8, image_size=16, num_labels=3, dtype=torch.float32))
    state = TrainState(model=model, optimizer=build_optimizer(
        model, 1e-3, 0.1, max_grad_norm=1.0, accumulation_steps=accumulation))
    step = make_classifier_train_step(model, torch.Generator().manual_seed(0))
    batch = {"images": torch.randn(2, 3, 16, 16), "labels": torch.tensor([0, 2])}
    return lambda: step(state, batch), state


def _clip_step():
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )

    torch.manual_seed(0)
    model = CLIPModel(CLIPConfig.create(vocab_size=40, vision_preset="vit-t-8", image_size=16,
                                        text_width=32, text_layers=1, text_heads=2,
                                        context_length=8, embed_dim=16, dtype=torch.float32))
    state = TrainState(model=model, optimizer=build_optimizer(model, 1e-3, 0.2,
                                                              max_grad_norm=1.0))
    step = make_clip_train_step(model)
    batch = {"images": torch.randn(3, 3, 16, 16),
             "input_ids": torch.randint(1, 40, (3, 8), dtype=torch.int32),
             "attention_mask": torch.ones(3, 8, dtype=torch.int32)}
    return lambda: step(state, batch), state


def test_span_with_nothing_listening_is_one_shared_no_op(recorder, monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_range", lambda name: opened.append(name))
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    call, _ = _classifier_step()
    call()
    profiling.count("probe")
    assert profiling.span("a") is profiling.span("b", 3)
    assert opened == [] and recorder.rows() == [] and recorder.sessions() == {}


@pytest.mark.parametrize("make", [_classifier_step, _clip_step], ids=["classifier", "clip"])
def test_a_train_step_under_the_profiler_gives_one_row(recorder, make):
    call, state = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    (row,) = recorder.rows()
    assert row["step"] == 0 and state.step == 1 and row["session"] == recorder.session == 1
    for name in ("step", "forward", "backward", "optimizer", "optimizer.clip",
                 "optimizer.update", "attention"):
        assert row["host_ms"][name] > 0.0 and row["self_ms"][name] >= 0.0, name
    assert "optimizer.accumulate" not in row["host_ms"]
    assert row["host_ms"]["step"] >= row["host_ms"]["forward"] + row["host_ms"]["backward"]
    events = prof.events()
    for name in ("forward", "backward", "optimizer"):
        (ev,) = [e for e in events if e.name == name]
        inside, stack = set(), list(ev.cpu_children)
        while stack:
            e = stack.pop()
            inside.add(e.id)
            stack.extend(e.cpu_children)
        ops = {e.id for e in events if e.name.startswith("aten::") and e.thread == ev.thread
               and ev.time_range.start <= e.time_range.start <= ev.time_range.end}
        assert ops and ops <= inside, name


def test_each_profiler_start_begins_a_session(recorder):
    call, _ = _classifier_step()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            call()
            call()
    call()  # nothing listens
    with profiling.recording():
        call()
    assert recorder.sessions() == {1: 2, 2: 2, 3: 1}
    assert [r["step"] for r in recorder.rows()] == [0, 1, 2, 3, 5]
    assert [r["step"] for r in recorder.rows(2)] == [2, 3]


def test_recorded_times_lie_on_the_profilers_clock(recorder, tmp_path):
    call, _ = _classifier_step()
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            call()
            time.sleep(0.002)
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("name") in ("step", "forward", "backward"):
            events.setdefault(e["name"], []).append(
                (base + float(e["ts"]) * 1e3, base + (float(e["ts"]) + float(e["dur"])) * 1e3))
    rows = recorder.rows()
    assert len(rows) == 3 and set(events) == {"step", "forward", "backward"}
    for name, found in events.items():
        mine = sorted((s["start_ns"], s["end_ns"]) for r in rows for s in r["spans"]
                      if s["name"] == name)
        assert len(mine) == len(found) == 3
        gaps = sorted(max(abs(a - c), abs(b - d)) for (a, b), (c, d) in zip(mine, sorted(found)))
        # the typical span within 50 us; a thread descheduled between the
        # event's start and the recorder's read can widen one, never all
        assert gaps[1] < 50e3 and gaps[-1] < 5e6, (name, gaps)


def test_trace_writes_spans_json(recorder, tmp_path):
    with profiling.trace(str(tmp_path)):
        for i in range(2):
            with profiling.span("step", i):
                with profiling.span("forward"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
                    profiling.count("probe", 2)
    rows = json.loads((tmp_path / "spans.json").read_text())["rows"]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert r["counters"] == {"host_syncs": 0, "probe": 2}
        assert [(s["name"], s["parent"]) for s in r["spans"]] == [("step", -1), ("forward", 0)]
        step, fwd = r["spans"]
        own = ((step["end_ns"] - step["start_ns"]) - (fwd["end_ns"] - fwd["start_ns"])) * 1e-6
        assert r["self_ms"]["step"] == pytest.approx(own, abs=1e-4)
        assert r["self_ms"]["forward"] == pytest.approx(r["host_ms"]["forward"])


def test_nested_spans_of_one_name_count_once(recorder):
    with profiling.recording():
        with profiling.span("step", 7):
            with profiling.span("attention"):
                with profiling.span("attention"):
                    with profiling.span("inner"):
                        time.sleep(0.001)
    (row,) = recorder.rows()
    assert [(s["name"], s["parent"]) for s in row["spans"]] == [
        ("step", -1), ("attention", 0), ("inner", 1)]
    assert row["step"] == 7
    assert row["self_ms"]["attention"] == pytest.approx(
        row["host_ms"]["attention"] - row["host_ms"]["inner"])


class _Sync(torch.autograd.Function):
    """A stand-in for an op that syncs, in its forward and its backward."""

    @staticmethod
    def forward(ctx, x):
        warnings.warn(profiling.SYNC_WARNING)
        return x * 2

    @staticmethod
    def backward(ctx, g):
        warnings.warn(profiling.SYNC_WARNING)
        return g * 2


def test_sync_counter_counts_the_warnings_it_is_fed(recorder):
    x = torch.ones(3, requires_grad=True)
    with profiling.recording():
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            with profiling.span("step", 0):
                _Sync.apply(x).sum().backward()
                warnings.warn(profiling.SYNC_WARNING)
                warnings.warn("not a sync")
            warnings.warn(profiling.SYNC_WARNING)  # outside a step: shown, not counted
            with profiling.span("step", 1):
                pass
    first, second = recorder.rows()
    assert first["counters"]["host_syncs"] == 3 and second["counters"]["host_syncs"] == 0
    assert sum(first["host_sync_sites"].values()) == 3
    assert all(site.startswith("test_torch_tracing.py:") for site in first["host_sync_sites"])
    assert [str(w.message) for w in shown] == ["not a sync", profiling.SYNC_WARNING]


def test_launch_counters_are_the_wrappers_counts(recorder):
    from multimodal_concept_learning_tpu_torch.ops import attention_core, flash_attention

    before = flash_attention.flash_attention.launches
    try:
        with profiling.recording():
            with profiling.span("step", 0):
                flash_attention.flash_attention.launches += 2
                attention_core.attention_core_bwd.launches += 1
                attention_core.attention_core_bwd.launches -= 1
    finally:
        flash_attention.flash_attention.launches = before
    (row,) = recorder.rows()
    assert row["counters"] == {"host_syncs": 0, "launches.flash_attention": 2}


def test_optimizer_spans_follow_accumulation(recorder):
    call, state = _classifier_step(accumulation=2)
    with profiling.recording():
        call()
        call()
    first, second = recorder.rows()
    assert {n for n in first["host_ms"] if n.startswith("optimizer")} == {
        "optimizer", "optimizer.accumulate"}
    assert {n for n in second["host_ms"] if n.startswith("optimizer")} == {
        "optimizer", "optimizer.accumulate", "optimizer.clip", "optimizer.update"}
    assert state.optimizer.count == 1


def test_data_wait_goes_into_the_next_step_row(recorder):
    from multimodal_concept_learning_tpu_torch.data.pipeline import prefetch_to_device

    batches = ({"x": np.full((2,), i, np.float32)} for i in range(3))
    seen = []
    with profiling.recording():
        for i, batch in enumerate(prefetch_to_device(batches, "cpu", size=2)):
            with profiling.span("step", i):
                seen.append(float(batch["x"][0]))
    rows = recorder.rows()
    assert seen == [0.0, 1.0, 2.0] and [r["step"] for r in rows] == [0, 1, 2]
    assert [sum(s["name"] == "data.wait" for s in r["spans"]) for r in rows] == [2, 1, 1]
    assert all(r["host_ms"]["data.wait"] > 0.0 for r in rows)


def test_recorder_keeps_the_last_rows(monkeypatch):
    rec = profiling.Recorder(max_rows=3)
    monkeypatch.setattr(profiling, "recorder", rec)
    with profiling.recording():
        for i in range(5):
            with profiling.span("step", i):
                pass
    assert [r["step"] for r in rec.rows()] == [2, 3, 4]


@pytest.mark.parametrize("cell", ["clip_b32_train", "vit_b16_train", "vit_b16_eval",
                                  "clip_b32_zeroshot"])
def test_spans_leave_the_harness_aten_op_count_as_it_was(recorder, monkeypatch, cell):
    """The benchmark's traced windows on ``benchmark/tiny.py``'s sizes count
    the same aten ops a step with the program's spans (inside the
    harness's ``bench.attention`` and ``bench.optimizer``) as without."""
    from benchmark import harness
    from benchmark.inputs import streams
    from benchmark.tiny import tiny_config
    from benchmark.trace import profile_windows

    man = harness.manifest()
    w = harness.workload(man, cell)
    cfg = tiny_config(w["config"])
    kind = harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json")["kind"]
    prog = harness.module("families", cfg["family"]).Program(cfg, streams(5), "cpu", kind, 2)
    opt = prog.state.optimizer if kind == "train" else None
    for i in range(4):  # past the first updates, whose ops differ from later ones
        prog.call(i)
    with_spans, _ = profile_windows(prog.call, 4, 1, 2, "cpu", opt)
    assert recorder.rows()
    monkeypatch.setattr(profiling, "_profiler_on", lambda: False)
    without, _ = profile_windows(prog.call, 7, 1, 2, "cpu", opt)
    assert with_spans.aten_ops == without.aten_ops > 0
