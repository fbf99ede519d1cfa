"""optimizer_ms_per_step: the host time a micro-step of the program's
``optimizer`` span (``Optimizer.step``: accumulation every micro-step,
clipping and the AdamW update on each update's), the mean over the steps
of the traced window with the most, in ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms("optimizer")
