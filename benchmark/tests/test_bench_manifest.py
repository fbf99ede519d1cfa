"""BENCHMARK.json against the contract, and every file it leads to."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
          "experts_per_tok", "width", "embed")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_top_level_keys_and_paths(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert 1 <= len(man["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in man["command"])
    assert man["command"][1].startswith(man["paths"][0] + "/")
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    # a full check with 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_entries(man):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
        for e in man[group]:
            assert set(e) == allowed and NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_configs_files_and_reductions(man):
    for c in man["configs"]:
        assert c["file"].startswith(man["paths"][0] + "/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank", "_size")) or key == "vocab_size"
            assert not any(w in key for w in WIDTHS), key
        assert any(w["config"] == c["name"] for w in man["workloads"])


def test_every_cell_finds_its_files_and_reports_enough(man):
    four = sum(1 for w in man["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(man["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(man["workloads"])
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for w in man["workloads"]:
        cfg = harness.config(w["config"])
        traffic = harness.load_json(harness.HERE, "traffic", f"{w['traffic']}.json")
        harness.module("families", cfg["family"])
        harness.module("drivers", traffic["kind"])
        harness.module("counts", w["config"])
        limits = harness.load_json(harness.HERE, "limits", f"{w['name']}.json")
        assert limits and all(isinstance(v, float) for v in limits.values())
        reported = [m["name"] for m in harness.cell_metrics(man, w["name"], False)]
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(man, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in reported and m["moves"] in e2e
            harness.reader(m["name"])
        for name in reported:
            harness.reader(name)


def test_metric_workload_lists_are_cells(man):
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in man["per_layer"]:
        moved = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    layers = {m["layer"] for m in man["per_layer"]}
    perf = open(os.path.join(harness.ROOT, "PERF.md")).read()
    for layer in layers:
        assert layer in perf, f"layer {layer!r} is not in PERF.md's list of layers"
