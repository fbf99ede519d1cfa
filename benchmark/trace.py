"""The traced part of a ``--trace 1`` run: two ``torch.profiler`` windows
after the measured one, and their reduction to a ``Summary``.

Window A traces the card only, over more steps than B, so that its edges
weigh little: the device's busy time (the union of the intervals of its
kernels, copies and fills), the window's wall time, and the operations
that took most device time.  Its tracing still slows the host's side of a
step; the run notes that stretch on standard error.  Window B traces host and card
with the harness's spans, for what needs the host's side: aten ops a step,
the device time of the attention and of the matrix products, and the idle
gaps by what the host was doing.

Spans (``torch.profiler.record_function``, opened by the harness around
calls into the program; the program itself has none):

- ``bench.step`` around each step call;
- ``bench.optimizer`` around ``Optimizer.step`` (an instance wrapper);
- ``bench.attention`` around each call of an attention entry point of the
  port (``ATTENTION_ENTRIES``, wrapped where the port's modules name them
  while window B runs).  The backward of what ran inside such a span is
  found through autograd's sequence numbers: every forward op records its
  node's number, and the backward node's ``evaluate_function`` event
  carries the same number and the forward thread.  So the attention's
  device time is that of the kernels launched inside the spans and inside
  those backward nodes, whatever kernel a later version launches there.

The matrix products' device time is that of the kernels whose names mark
a library product (``PRODUCT_KERNELS``), less those inside the attention.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.window import sync

PACKAGE = "multimodal_concept_learning_tpu_torch"
SPAN_STEP, SPAN_OPT, SPAN_ATTN = "bench.step", "bench.optimizer", "bench.attention"
ATTENTION_ENTRIES = ("multi_head_attention", "attention_core_padded", "attention_core",
                     "flash_attention")
PRODUCT_KERNELS = ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitkreduce", "cublas")
BACKWARD = "autograd::engine::evaluate_function:"
TOP = 10


@dataclasses.dataclass
class Summary:
    steps_a: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    steps_b: int = 0
    aten_ops: int = 0
    attention_s: float = 0.0
    products_s: float = 0.0
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    notes: str = ""  # what window B found, for standard error


def _is_kernel(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench."))


def is_product(name: str) -> bool:
    low = name.lower()
    return any(tag in low for tag in PRODUCT_KERNELS)


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


@contextlib.contextmanager
def attention_spans():
    """Wrap every attention entry point that a loaded port module names."""
    saved = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not (mod_name == PACKAGE or mod_name.startswith(PACKAGE + ".")):
            continue
        for attr in ATTENTION_ENTRIES:
            fn = mod.__dict__.get(attr)
            if callable(fn) and getattr(fn, "__module__", "").startswith(PACKAGE):
                saved.append((mod, attr, fn))
                setattr(mod, attr, _spanned(fn, SPAN_ATTN))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _spanned(fn: Callable, name: str) -> Callable:
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def optimizer_span(optimizer):
    if optimizer is None:
        yield
        return
    optimizer.step = _spanned(optimizer.step, SPAN_OPT)
    try:
        yield
    finally:
        del optimizer.step  # the class's method again


def _run(call, start: int, steps: int, device, activities, span: bool):
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for j in range(steps):
            if span:
                with torch.profiler.record_function(SPAN_STEP):
                    call(start + j)
            else:
                call(start + j)
        sync(device)
        wall = time.perf_counter() - t0
    return prof.events(), wall


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def _attention_scopes(cpu) -> Tuple[list, list]:
    """(the outermost attention spans, the backward nodes of what ran in
    them)."""
    spans = [e for e in cpu if e.name == SPAN_ATTN
             and not any(a.name == SPAN_ATTN for a in _ancestors(e))]
    fwd_keys = set()
    for s in spans:
        stack = list(s.cpu_children)
        while stack:
            x = stack.pop()
            if x.sequence_nr >= 0:
                fwd_keys.add((x.thread, x.sequence_nr))
            stack.extend(x.cpu_children)
    nodes = [e for e in cpu
             if e.name.startswith(BACKWARD) and (e.fwd_thread, e.sequence_nr) in fwd_keys]
    return spans, nodes


def _attention_time(cpu, kernels) -> Tuple[float, float, str]:
    """(all, products) device microseconds of the attention's kernels, and
    how they were found.  A kernel belongs to the attention when the host
    call that launched it (the runtime event of the same correlation id)
    falls inside a span or one of its backward nodes.  A kernel with no
    such launch event is not counted: where none has one, the attention's
    time is 0 and its metric falls silent."""
    spans, nodes = _attention_scopes(cpu)
    scopes = union([(e.time_range.start, e.time_range.end) for e in spans + nodes])
    starts = [lo for lo, _ in scopes]
    launch = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu")}
    total = prods = 0.0
    matched = 0
    for k in kernels:
        t = launch.get(k.id)
        if t is None:
            continue
        matched += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= scopes[i][1]:
            d = k.time_range.end - k.time_range.start
            total += d
            if is_product(k.name):
                prods += d
    return total, prods, (f"{len(spans)} attention spans, {len(nodes)} backward nodes, "
                          f"{matched} of {len(kernels)} device ops tied to their launch")


def _innermost(host, starts, t):
    """The innermost event of one thread's sorted events that holds time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    op = host[i] if i >= 0 else None
    while op is not None and op.time_range.end < t:
        op = op.cpu_parent
    return op


def _idle_gaps(cpu, kernels) -> List[Tuple[str, float]]:
    """Idle gaps between the device's busy intervals, summed by what the
    host was doing when each began: the innermost op then on any thread
    (the step's or autograd's), under its harness span or backward node
    ("python" where no op was open, between ops)."""
    busy = union(kernels)
    threads = defaultdict(list)
    for e in cpu:
        threads[e.thread].append(e)
    hosts = []
    for events in threads.values():
        events.sort(key=lambda e: e.time_range.start)
        hosts.append((events, [e.time_range.start for e in events]))
    by_name: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        found = [op for op in (_innermost(h, s, a) for h, s in hosts) if op is not None]
        op = max(found, key=lambda e: e.time_range.start, default=None)
        scope = "step"
        for x in ([op, *_ancestors(op)] if op is not None else []):
            if x.name.startswith("bench."):
                scope = x.name[len("bench."):]
                break
            if x.name.startswith(BACKWARD):
                scope = "backward"
                break
        name = ("python" if op is None or op.name.startswith(("bench.", BACKWARD))
                else op.name)
        by_name[f"{scope}:{name}"] += (b - a) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]


def profile_windows(call: Callable[[int], object], start: int, steps_a: int, steps_b: int,
                    device, optimizer=None) -> Tuple[Summary, int]:
    """Trace window A of ``steps_a`` calls from call ``start``, then window
    B of ``steps_b``; returns the summary and the next call's index."""
    from torch.profiler import ProfilerActivity

    out = Summary(steps_a=steps_a, steps_b=steps_b)
    card = torch.device(device).type == "cuda"
    device_only = [ProfilerActivity.CUDA] if card else [ProfilerActivity.CPU]  # CPU: rehearsal
    events, out.window_s = _run(call, start, steps_a, device, device_only, False)
    kernels = [e for e in events if _is_kernel(e)]
    out.busy_s = sum(hi - lo for lo, hi in union(
        [(e.time_range.start, e.time_range.end) for e in kernels])) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    start += steps_a

    with attention_spans(), optimizer_span(optimizer):
        events, _ = _run(call, start, steps_b, device,
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA], True)
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in events if _is_kernel(e)]
    out.aten_ops = sum(1 for e in cpu if e.name.startswith("aten::"))
    attn, attn_prods, how = _attention_time(cpu, kernels)
    out.attention_s = attn * 1e-6
    all_prods = sum(e.time_range.end - e.time_range.start for e in kernels if is_product(e.name))
    out.products_s = (all_prods - attn_prods) * 1e-6
    out.notes = (f"trace: {len(kernels)} device ops, {out.aten_ops} aten ops in {steps_b} steps; "
                 f"{how}; attention {attn * 1e-3:.3f} ms, products outside it "
                 f"{out.products_s * 1e3:.3f} ms")
    out.idle_gaps = _idle_gaps(cpu, [(e.time_range.start, e.time_range.end) for e in kernels])
    return out, start + steps_b


__all__ = ["Summary", "attention_spans", "is_product", "profile_windows", "union"]
