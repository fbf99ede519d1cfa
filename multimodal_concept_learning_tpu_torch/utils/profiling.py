"""Tracing and step timing (counterpart of
multimodal_concept_learning_tpu/utils/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (the CPU, and the card when there is one) that writes a Chrome trace,
  ``logdir/trace.json`` (Perfetto and chrome://tracing read it); it yields
  the profiler, whose ``key_averages()`` give the time by op.
- ``annotate(name)``: a named span in that trace (``record_function``).
- ``StepTimer``: fenced per-step wall times and the JAX summary keys
  (steps, mean_s, p50_s, p99_s, total_s).  The fence reads one element of
  the given tensor (``.item()``), which waits for the work that made it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    print(f"Profiler trace written to {logdir}")


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates fenced per-step wall times; reports mean/p50/p99."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, fence_array=None):
        """End the step; ``fence_array``: a tensor (or array) of the step,
        e.g. its loss, one element of which is read to wait for the step."""
        if fence_array is not None:
            if isinstance(fence_array, torch.Tensor):
                fence_array.detach().reshape(-1)[:1].item()
            else:
                float(np.asarray(fence_array).ravel()[0])
        assert self._t0 is not None, "StepTimer.stop() without start()"
        self.times.append(time.time() - self._t0)
        self._t0 = None

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
            "total_s": float(arr.sum()),
        }


__all__ = ["StepTimer", "annotate", "trace"]
