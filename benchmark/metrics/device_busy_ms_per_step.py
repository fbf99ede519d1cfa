"""device_busy_ms_per_step: the union of the device's kernel, copy and
fill intervals in the card-only traced window, over its steps, in ms.
Unlike the idle share it leaves out the host's side, which tracing
stretches."""


def read(ctx):
    s = ctx.summary
    if s is None or s.steps_a <= 0 or s.busy_s <= 0:
        return None
    return 1e3 * s.busy_s / s.steps_a
