"""train_images_per_s: every image of the micro-steps run in the window
over the window's wall time (host clock, closed by a synchronize)."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.window.steps * ctx.images_per_step / ctx.window.wall_s
