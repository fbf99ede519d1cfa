"""gemm_roofline: the linear layers' and heads' product FLOPs a step
(forward, and in training the weights' and inputs' gradients) over the
peak bf16 rate, over the device time of the library's matrix-product
kernels outside the attention, in percent."""


def read(ctx):
    s, peak = ctx.summary, ctx.peak
    if s is None or peak is None or s.products_s <= 0:
        return None
    flops = ctx.mean_work("product_flops") * s.steps_b
    return 100.0 * flops / peak["bf16_flops_per_s"] / s.products_s
