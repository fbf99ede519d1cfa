"""host_ms_per_step: the median host wall time of a step call in the
measured window (the harness's clock around each call, no sync): the
host's dispatch of one step, or its wait where the launch queue is full."""

import statistics


def read(ctx):
    return statistics.median(ctx.window.host_ms) if ctx.window.host_ms else None
