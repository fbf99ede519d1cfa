"""One run of one cell, driven by the files that ``BENCHMARK.json`` names.

A workload names a configuration and a traffic mix.  The harness finds by
name, with no table of its own:

- ``configs/<config>.json``: the sizes and training knobs as run; its
  ``family`` names ``families/<family>.py`` (the program's side and the
  reference's) and its ``dataset`` names ``datasets/<dataset>.json``;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
  ``drivers/<kind>.py``, which runs set-up, the window and the check;
- ``counts/<config>.py``: the FLOPs and bytes of a step;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
- ``metrics/<metric>.py`` (or ``metrics/<part before the first dot>.py``):
  a reader ``read(ctx)`` of one metric, returning None where it finds
  nothing to read;
- ``peaks.json``: the chip's peak rates by device name.

The result is the contract's last line: {"correct", "attempted",
"failed", "metrics", "device", ["breakdown"], "check"}, the compared
numbers last, and also as the last lines of standard error.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_concept_learning_tpu")


def load_json(*parts: str) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(man: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of workload ``name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        return [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in cell_metrics(man, name, False)}
    return [m for m in man["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported else [])]


def module(kind: str, name: str):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(name: str):
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader metrics/{name}.py for metric {name!r}")


def config(name: str) -> dict:
    from benchmark.inputs import load_dataset

    cfg = load_json(HERE, "configs", f"{name}.json")
    cfg["data"] = load_dataset(cfg["dataset"])
    return cfg


@dataclasses.dataclass
class Context:
    """What a driver fills and the metric readers read."""
    name: str
    cfg: dict
    traffic: dict
    family: Any
    counts: Any
    seeds: Dict[str, int]
    seconds: float
    trace: bool
    device: Any
    t_start: float
    setup_s: float = 0.0
    window: Any = None
    summary: Any = None
    work: Any = None
    images_per_step: int = 0
    numbers: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    peak: Optional[dict] = None

    def log(self, what: str) -> None:
        """A set-up mark on standard error: seconds since the process began."""
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {what}", file=sys.stderr,
              flush=True)

    @property
    def mode(self) -> str:
        return self.traffic["kind"]

    def mean_work(self, what: str) -> float:
        """The mean over the pool's batches of a ``counts`` quantity."""
        values = [getattr(s, what)() for s in self.work]
        return sum(values) / len(values)


def device_info(device, ctx: Context) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(ctx.window.memory_peak_bytes)}
    if ctx.summary is not None:
        info["busy_s"] = ctx.summary.busy_s
        info["window_s"] = ctx.summary.window_s
    return info


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".", 1)[0] in FORBIDDEN)


def run(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        man: Optional[dict] = None, cfg: Optional[dict] = None,
        limits: Optional[dict] = None) -> dict:
    """Run workload ``name`` once; return the result (without printing).
    ``man``, ``cfg`` and ``limits`` replace the files (tests)."""
    from benchmark.inputs import streams

    man = man or manifest()
    cell = workload(man, name)
    cfg = cfg or config(cell["config"])
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    limits = limits if limits is not None else load_json(HERE, "limits", f"{name}.json")
    ctx = Context(name=name, cfg=cfg, traffic=traffic, family=module("families", cfg["family"]),
                  counts=module("counts", cell["config"]), seeds=streams(seed),
                  seconds=seconds, trace=trace, device=device, t_start=t_start)
    module("drivers", traffic["kind"]).run(ctx)
    dev = device_info(device, ctx)
    ctx.peak = load_json(HERE, "peaks.json").get(dev["kind"])

    metrics = {}
    for m in cell_metrics(man, name, trace):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    from benchmark.check import judge
    correct, rows = judge(ctx.numbers, limits)
    result = {"correct": correct, "attempted": ctx.window.steps,
              "failed": sum(1 for _, v, lim, _ in rows if lim is None or not v <= lim),
              "metrics": metrics, "device": dev}
    if trace and ctx.summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.summary.device_ops],
                               "idle_gaps": [list(x) for x in ctx.summary.idle_gaps]}
    result["check"] = {n: {"value": _finite(v), "limit": lim} for n, v, lim, _ in rows}
    result["_check_rows"] = rows
    result["_notes"] = _trace_notes(ctx)
    return result


def _trace_notes(ctx: Context) -> str:
    """What the traced windows found, and how far the card-only trace
    stretched a step's wall time against the measured window's."""
    s, w = ctx.summary, ctx.window
    if s is None:
        return ""
    if s.steps_a <= 0 or w.steps <= 0:
        return s.notes
    traced, measured = 1e3 * s.window_s / s.steps_a, 1e3 * w.wall_s / w.steps
    return (f"{s.notes}; window A {traced:.3f} ms a step against the measured window's "
            f"{measured:.3f} (stretch {traced / measured:.3f})")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300
