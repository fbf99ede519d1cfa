"""Evaluation traffic: a closed loop of the eval step (the classifier's
validation pass, CLIP's zero-shot test), back to back, over a pool of
distinct batches on the device, cycled in order; every row valid.

Set-up builds the program and runs ``warmup_passes`` passes over the
pool.  The program's outputs (each batch's latest in the window) are
compared, once the window has closed and the program's state is freed,
with the reference's on the same batches.

Traffic keys: ``pool_batches``, ``warmup_passes``,
``trace_steps_card`` (traced window A), ``trace_steps_host`` (window B).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.reference.numerics import Numerics, full_float32
from benchmark.trace import profile_windows
from benchmark.window import measure, sync


def run(ctx) -> None:
    fam, cfg, traffic, device = ctx.family, ctx.cfg, ctx.traffic, ctx.device
    pool = traffic["pool_batches"]
    ctx.log("imports done")
    prog = fam.Program(cfg, ctx.seeds, device, "eval", pool)
    ctx.log("program built")
    start = traffic["warmup_passes"] * pool
    for i in range(start):
        prog.call(i)
    sync(device)
    ctx.setup_s = time.perf_counter() - ctx.t_start
    ctx.log("set-up done; the window opens")
    ctx.window = measure(prog.call, start, ctx.seconds, device)
    ctx.images_per_step = prog.images_per_step
    if ctx.trace:
        ctx.summary, _ = profile_windows(prog.call, start + ctx.window.steps,
                                         traffic["trace_steps_card"], traffic["trace_steps_host"],
                                         device)
    ctx.work = ctx.counts.steps(cfg, "eval", fam.work_shapes(cfg, prog.batches))
    batches, results = prog.batches, prog.results()
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ctx.log("window closed; the reference runs")
    with full_float32():
        ref = fam.reference_eval(cfg, ctx.seeds, batches, device, Numerics("float32"))
    ctx.numbers = fam.eval_numbers(results, ref)
