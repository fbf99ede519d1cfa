"""aten_ops_per_step: ``aten::`` events a step in the host-and-card
profiler window, nested ones included."""


def read(ctx):
    s = ctx.summary
    return s.aten_ops / s.steps_b if s is not None and s.aten_ops else None
