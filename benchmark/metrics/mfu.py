"""mfu: the model's FLOPs a step (``counts``: forward products and valid
attention pairs, times 3 in training) times the window's steps, over its
wall time and the peak bf16 rate, in percent; from the measured window,
outside the profiler."""


def read(ctx):
    if ctx.peak is None:
        return None
    flops = ctx.mean_work("model_flops") * ctx.window.steps
    return 100.0 * flops / ctx.window.wall_s / ctx.peak["bf16_flops_per_s"]
