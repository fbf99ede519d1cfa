"""Training traffic: a closed loop of the train step's micro-steps, back to
back, over a pool of distinct batches on the device, cycled in order.

Set-up builds the one training state (model and optimizer) and drives it
through its first ``checked_updates`` updates with the window's own call,
on rows that all differ; the program's readings for ``correct`` come from
those steps and from the optimizer's state.  The same state then runs the
measured window (and, with ``--trace 1``, the traced windows).  Once the
window has closed and the program's state is freed, the reference
follows the checked steps from the same weights, batches and dropout seed.

Traffic keys: ``pool_batches``, ``checked_updates``,
``trace_steps_card`` (traced window A), ``trace_steps_host`` (window B).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import check
from benchmark.reference.numerics import Numerics, full_float32
from benchmark.trace import profile_windows
from benchmark.window import measure, sync


def program_readings(prog, micro_steps: int, k: int) -> dict:
    """Run micro-steps 0..micro_steps-1 and read {"losses", "grad_norms"
    (the first update's gradient as the optimizer holds it, from its first
    moment after the first update), "change_norms" (the parameters' change
    over the micro-steps), "first_outputs" (what a family taps from the
    first step's forward, if anything)}."""
    opt = prog.state.optimizer
    before = {n: p.detach().clone() for n, p in opt.params.items()}
    losses, grad_norms = [], None
    for i in range(micro_steps):
        losses.append(prog.call(i))
        if i == k - 1:
            grad_norms = check.norms({n: mu / (1.0 - opt.b1) for n, mu in opt.mu.items()})
    change = check.norms({n: p.detach() - before[n] for n, p in opt.params.items()})
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change, "first_outputs": getattr(prog, "first_outputs", {})}


def readings_of_reference(ref: dict) -> dict:
    """A reference run's outputs read as the program's are (the control
    and the planted faults, put in the program's place)."""
    return {"losses": ref["losses"], "grad_norms": check.norms(ref["first_grads"]),
            "change_norms": check.norms({n: ref["after"][n] - ref["before"][n]
                                         for n in ref["after"]}),
            "first_outputs": ref.get("first_outputs", {})}


def run(ctx) -> None:
    fam, cfg, traffic, device = ctx.family, ctx.cfg, ctx.traffic, ctx.device
    ctx.log("imports done")
    prog = fam.Program(cfg, ctx.seeds, device, "train", traffic["pool_batches"])
    ctx.log("program built")
    k = fam.accumulation(cfg)
    checked = traffic["checked_updates"] * k
    readings = program_readings(prog, checked, k)
    sync(device)
    ctx.setup_s = time.perf_counter() - ctx.t_start
    ctx.log("set-up done; the window opens")
    ctx.window = measure(prog.call, checked, ctx.seconds, device)
    ctx.images_per_step = prog.images_per_step
    if ctx.trace:
        ctx.summary, _ = profile_windows(prog.call, checked + ctx.window.steps,
                                         traffic["trace_steps_card"], traffic["trace_steps_host"],
                                         device, prog.state.optimizer)
    ctx.work = ctx.counts.steps(cfg, "train", fam.work_shapes(cfg, prog.batches))
    batches = prog.batches
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ctx.log("window closed; the reference runs")
    with full_float32():
        ref = fam.reference_train(cfg, ctx.seeds, batches, checked, device, Numerics("float32"))
    ctx.numbers = check.train_numbers(readings, ref)
