"""attn_roofline: the attention's least time a step by the bound rule
(``counts/transformer.py``: valid query-key pairs over the peak bf16
rate, or bf16 q, k, v and output bytes over the peak bandwidth, forward
and, in training, backward) over the device time of the kernels launched
inside the attention's spans and their backward nodes, in percent."""


def read(ctx):
    s, peak = ctx.summary, ctx.peak
    if s is None or peak is None or s.attention_s <= 0:
        return None
    bound = sum(st.attention_bound_s(peak["bf16_flops_per_s"], peak["hbm_bytes_per_s"])
                for st in ctx.work) / len(ctx.work)
    return 100.0 * bound * s.steps_b / s.attention_s
