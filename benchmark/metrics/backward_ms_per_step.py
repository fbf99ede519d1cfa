"""backward_ms_per_step: the host time a step of the program's
``backward`` span (``loss.backward()``: the host waits there while
autograd's thread runs the backward), the mean over the steps of the
traced window with the most, in ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms("backward")
