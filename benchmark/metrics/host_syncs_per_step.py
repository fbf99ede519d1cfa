"""host_syncs_per_step: the program's ``host_syncs`` counter a step, the
operations in a step that made the host wait for the card (CUDA's sync
debug warnings, the backward's included), the mean over the steps of the
traced window with the most."""

from benchmark.spans import counter


def read(ctx):
    return counter("host_syncs")
