"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the measured
window (reset as it opens), in GiB."""


def read(ctx):
    peak = ctx.window.memory_peak_bytes
    return peak / 2 ** 30 if peak else None
