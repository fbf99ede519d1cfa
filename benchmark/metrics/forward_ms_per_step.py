"""forward_ms_per_step: the host time a step of the program's ``forward``
span (the model call and the loss; in evaluation also the argmax), the
mean over the steps of the traced window with the most, in ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms("forward")
