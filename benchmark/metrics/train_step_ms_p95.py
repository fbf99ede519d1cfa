"""train_step_ms_p95: the 95th percentile (nearest rank) of the window's
micro-step times, each the gap between the events recorded on the step's
stream at consecutive step boundaries, idle time included.  Read as
``train_step_ms_p95.host_paced`` (a per-layer metric) in a cell whose step
the host paces, where the tail spreads too widely from run to run for an
end-to-end bound."""

import math


def read(ctx):
    times = sorted(ctx.window.step_ms)
    if ctx.mode != "train" or not times:
        return None
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
