"""The program's spans and counters, and a profiler wrapper (counterpart of
multimodal_concept_learning_tpu/utils/profiling.py).

- ``span(name, step=None)``: a named interval of the host's time.  When
  nothing listens it returns one shared no-op context manager after one
  flag check.  Something listens while a ``torch.profiler`` runs or
  ``recording()`` is open; then a span opens a profiler range of its name
  (so it appears in a profiler trace beside the ops and kernels it ran)
  and ``recorder`` keeps its name, parent, start and end, read on the
  clock the profiler maps its events onto (``time.time_ns``).  A span
  opened inside an open span of the same name adds nothing: only the
  outermost of a nest counts.
- ``count(name, n=1)``: adds ``n`` to a counter of the open root span
  while something listens.
- ``recording()``: listen without a profiler.
- ``recorder``: one row per closed root ``step`` span, the last
  ``MAX_ROWS``: the step id, the session (a new one each time listening
  starts: each profiler start, seen through ``torch.autograd.profiler``'s
  start hook, and each outermost ``recording()``), the host time and self
  time of each span name inside the step (self time: the span's time less
  its child spans'), and the step's counters: ``host_syncs`` (operations
  that made the host wait for the card while the step ran, the backward's
  included: CUDA's sync debug mode set to warn for the step, its warnings
  counted and their Python lines kept, the previous mode restored) and
  ``launches.<kernel>`` (the change in each kernel wrapper's
  ``.launches`` over the step).  A root span of another name (``data.wait``)
  goes into the next step's row.
- ``trace(logdir)``: ``torch.profiler.profile`` over the CPU (and the card
  when there is one); writes ``logdir/trace.json`` (a Chrome trace) and
  ``logdir/spans.json`` (the rows recorded under it, with each span).

The program's spans: ``step`` (each train and eval step of
``parallel/train_step.py``), ``forward``, ``backward``, ``optimizer``
(``Optimizer.step``) with ``optimizer.reduce`` (under a process group),
``optimizer.accumulate``, ``optimizer.clip`` and ``optimizer.update``,
``attention`` (``multi_head_attention``, ``flash_attention``,
``attention_core`` and through it ``attention_core_padded``), and
``data.wait`` (``data/pipeline.prefetch_to_device``'s wait for a batch).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

STEP = "step"
MAX_ROWS = 512
SYNC_WARNING = "called a synchronizing CUDA operation"
_PORT = "multimodal_concept_learning_tpu_torch"
# every kernel wrapper that counts its calls in ``.launches``, by module
LAUNCH_COUNTERS = (
    ("ops.attention_core", ("attention_core_fwd", "attention_core_bwd",
                            "attention_core_bd_fwd", "attention_core_bd_bwd")),
    ("ops.flash_attention", ("flash_attention", "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")),
    ("ops.fused_attention_block", ("fused_attention_fwd", "fused_bwd_attn")),
    ("ops.int4", ("int4_matmul", "v3a_matmul", "v3b_matmul")),
    ("ops.paged_attention_kernel", ("paged_decode_attention",)),
    ("ops.paged_attention_mp_kernel", ("paged_decode_attention_mp",)),
)

_profiler_on = torch._C._autograd._profiler_enabled
# the profiler maps its events' times onto this clock (CLOCK_REALTIME): a
# span's start and end lie on the trace's timeline
_clock = time.time_ns
# the profiler range a span opens: a record_function without its Python
# wrapper's cost, the same event in the trace
_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()
_SYNC_FILTER = None


class _Root:
    """A root span's row while it is open."""

    __slots__ = ("name", "step", "session", "spans", "counters", "sites", "launches",
                 "sync_mode", "shown")

    def __init__(self, name: str, step: Optional[int], session: int):
        self.name, self.step, self.session = name, step, session
        self.spans: List[list] = []  # [name, parent index or -1, start, end] in opening order
        self.counters: Dict[str, int] = {}
        self.sites: Dict[str, int] = collections.Counter()
        self.launches = self.sync_mode = self.shown = None


class Recorder:
    """The rows of the closed ``step`` spans, newest last (see the module
    docstring); times in ns since the epoch, as the profiler's trace
    gives them."""

    def __init__(self, max_rows: int = MAX_ROWS):
        self.depth = 0  # open recording() contexts
        self.session = 0
        self._rows = collections.deque(maxlen=max_rows)
        self._waits = collections.deque(maxlen=max_rows)  # closed roots not yet in a row
        self._local = threading.local()

    def start_session(self) -> None:
        self.session += 1

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, step: Optional[int]):
        """The (root, index) of a new span whose times are yet to be taken,
        or None inside a span of its name."""
        stack = self._stack()
        if stack:
            root = stack[0][0]
            if any(root.spans[i][0] == name for _, i in stack):
                return None
        else:
            root = _Root(name, step, self.session)
            if name == STEP:
                self._watch(root)
        root.spans.append([name, stack[-1][1] if stack else -1, 0, 0])
        frame = (root, len(root.spans) - 1)
        stack.append(frame)
        return frame

    def _close(self, frame) -> None:
        root = frame[0]
        stack = self._stack()
        stack.pop()
        if stack:
            return
        if root.name != STEP:
            self._waits.append((root.session, root.spans))
            return
        self._unwatch(root)
        spans = []
        for session, part in [*self._waits, (root.session, root.spans)]:
            if session == root.session:
                base = len(spans)
                spans += [[n, p + base if p >= 0 else -1, t0, t1] for n, p, t0, t1 in part]
        self._waits.clear()
        self._rows.append((root.step, root.session, spans, root.counters, dict(root.sites)))

    def _watch(self, root: _Root) -> None:
        root.launches = _launch_counts()
        root.counters["host_syncs"] = 0
        _show_every_sync_warning()
        root.shown = warnings.showwarning
        warnings.showwarning = functools.partial(_on_warning, root, root.shown)
        if torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() == 0:
            root.sync_mode = 0
            torch.cuda.set_sync_debug_mode("warn")

    def _unwatch(self, root: _Root) -> None:
        if root.sync_mode is not None:
            torch.cuda.set_sync_debug_mode(root.sync_mode)
        warnings.showwarning = root.shown
        for name, n in _launch_counts().items():
            if n != root.launches.get(name, 0):
                root.counters[f"launches.{name}"] = n - root.launches.get(name, 0)

    def sessions(self) -> Dict[int, int]:
        """Rows kept, by session."""
        return dict(collections.Counter(r[1] for r in self._rows))

    def rows(self, session: Optional[int] = None) -> List[dict]:
        """The kept rows (of ``session``, or all), oldest first, each
        {step, session, start_ns, end_ns, host_ms, self_ms, counters,
        host_sync_sites, spans: [{name, parent, start_ns, end_ns}]}."""
        out = []
        for step, s, spans, counters, sites in self._rows:
            if session is not None and s != session:
                continue
            child = [0] * len(spans)
            for _, parent, t0, t1 in spans:
                if parent >= 0:
                    child[parent] += t1 - t0
            host: Dict[str, float] = collections.defaultdict(float)
            own: Dict[str, float] = collections.defaultdict(float)
            for (name, _, t0, t1), inner in zip(spans, child):
                host[name] += (t1 - t0) * 1e-6
                own[name] += (t1 - t0 - inner) * 1e-6
            top = next(x for x in spans if x[0] == STEP and x[1] == -1)
            out.append({"step": step, "session": s, "start_ns": top[2], "end_ns": top[3],
                        "host_ms": dict(host), "self_ms": dict(own), "counters": dict(counters),
                        "host_sync_sites": sites,
                        "spans": [{"name": n, "parent": p, "start_ns": t0, "end_ns": t1}
                                  for n, p, t0, t1 in spans]})
        return out


def _launch_counts() -> Dict[str, int]:
    counts = {}
    for mod_name, names in LAUNCH_COUNTERS:
        mod = sys.modules.get(f"{_PORT}.{mod_name}")
        for name in names if mod is not None else ():
            n = getattr(getattr(mod, name, None), "launches", None)
            if n is not None:
                counts[name] = n
    return counts


def _show_every_sync_warning() -> None:
    """Put a filter that shows every sync warning ahead of the others, if
    it is not there (the default shows a warning once a line; a filter
    outside the steps changes nothing where no sync debug mode is set)."""
    global _SYNC_FILTER
    if _SYNC_FILTER is None or _SYNC_FILTER not in warnings.filters:
        warnings.filterwarnings("always", message=SYNC_WARNING)
        _SYNC_FILTER = warnings.filters[0]


def _on_warning(root: _Root, shown, message, category, filename, lineno, file=None,
                line=None):
    """``warnings.showwarning`` for a step: counts the sync warnings (and
    where in Python each came from), shows the others as before."""
    if not str(message).startswith(SYNC_WARNING):
        shown(message, category, filename, lineno, file, line)
        return
    root.counters["host_syncs"] += 1
    frame = sys._getframe(1)
    torch_dir = os.path.dirname(torch.__file__)
    while frame is not None and (frame.f_code.co_filename.startswith(torch_dir)
                                 or frame.f_code.co_filename.endswith("warnings.py")):
        frame = frame.f_back
    if frame is not None:
        code = frame.f_code
        root.sites[f"{os.path.basename(code.co_filename)}:{frame.f_lineno} {code.co_name}"] += 1


class _Span:
    __slots__ = ("name", "step", "range", "frame")

    def __init__(self, name: str, step: Optional[int]):
        self.name, self.step, self.range, self.frame = name, step, None, None

    def __enter__(self):
        self.frame = recorder._open(self.name, self.step)
        if self.frame is not None:
            self.range = _range(self.name)
            self.range.__enter__()
            self.frame[0].spans[self.frame[1]][2] = _clock()
        return self

    def __exit__(self, *exc):
        if self.frame is not None:
            self.frame[0].spans[self.frame[1]][3] = _clock()
            self.range.__exit__(None, None, None)
            recorder._close(self.frame)
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager around one named interval of the program (see
    the module docstring); ``step`` is a root ``step`` span's id."""
    if not recorder.depth and not _profiler_on():
        return _NULL
    return _Span(name, step)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open root span, if something
    listens and a span is open on this thread."""
    if not recorder.depth and not _profiler_on():
        return
    stack = recorder._stack()
    if stack:
        counters = stack[0][0].counters
        counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Listen (record spans and counters in ``recorder``) without a
    profiler; the outermost one starts a new session unless a profiler
    already listens.  Yields the recorder."""
    if recorder.depth == 0 and not _profiler_on():
        recorder.start_session()
    recorder.depth += 1
    try:
        yield recorder
    finally:
        recorder.depth -= 1


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write ``logdir/trace.json`` and
    ``logdir/spans.json``.  Yields the profiler, whose
    ``key_averages()`` give the time by op."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = recorder.session + 1
    with profile(activities=activities) as prof:
        if recorder.session < first:  # no session started with the profiler
            recorder.start_session()
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    rows = [r for r in recorder.rows() if r["session"] >= first]
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"rows": rows}, f)
    print(f"Profiler trace written to {logdir}")


def _start_sessions_with_the_profiler() -> None:
    """Make each profiler start begin a new session, through the hook
    that ``torch.autograd.profiler`` calls as a profiler starts."""
    from torch.autograd import profiler as autograd_profiler

    start = getattr(autograd_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "starts_a_session", False):
        return

    def on_start(*args, **kwargs):
        recorder.start_session()
        return start(*args, **kwargs)

    on_start.starts_a_session = True
    autograd_profiler._run_on_profiler_start = on_start


recorder = Recorder()
_start_sessions_with_the_profiler()

__all__ = ["LAUNCH_COUNTERS", "MAX_ROWS", "Recorder", "count", "recorder", "recording", "span",
           "trace"]
