"""device_idle_share: 100 x (1 - the union of the device's kernel, copy
and fill intervals over the card-only traced window's wall time)."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
