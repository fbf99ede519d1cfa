"""attention_host_ms_per_step: the host time a step of the program's
outermost ``attention`` spans (the port's attention entry points: the
forward only, the backward runs on autograd's thread unspanned), the mean
over the steps of the traced window with the most, in ms."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms("attention")
