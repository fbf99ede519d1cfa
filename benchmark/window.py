"""The measured window: a closed loop of the program's step calls, back to
back, for a fixed number of seconds of the host's clock.

The window opens after a ``synchronize``; after each call the host checks
the clock, and once ``seconds`` have passed it stops calling, synchronizes
again and closes.  Every call of the window is counted, and the wall time
runs to the close, so a rate is all the work over all the time.  On the
card an event is recorded on the step's stream after every call; the gaps
between consecutive events (read after the close, so nothing waits in the
loop) are the steps' times as the device saw them, idle time included.
The host's own time in each call (no sync) is kept beside them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import torch


@dataclasses.dataclass
class Window:
    steps: int
    wall_s: float
    step_ms: List[float]  # device time between consecutive step boundaries
    host_ms: List[float]  # host time inside each call
    start_index: int
    memory_peak_bytes: int


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(call: Callable[[int], object], start: int, seconds: float, device) -> Window:
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    events, host_ms, stamps = [], [], []
    t0 = time.perf_counter()
    if cuda:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        events.append(first)
    i = start
    while True:
        h0 = time.perf_counter()
        call(i)
        h1 = time.perf_counter()
        host_ms.append(1e3 * (h1 - h0))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            stamps.append(h1)
        i += 1
        if h1 - t0 >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - t0
    if cuda:
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        peak = torch.cuda.max_memory_allocated(device)
    else:
        step_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
        peak = 0
    return Window(steps=i - start, wall_s=wall, step_ms=step_ms, host_ms=host_ms,
                  start_index=start, memory_peak_bytes=peak)
