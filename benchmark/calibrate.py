"""The readings that the limits of ``correct`` are set from (not run by
the benchmark's own runs).

    python3 benchmark/calibrate.py --workload clip_b32_train --seeds 1,2,3 \\
        --what program,control,half_batch,row_altered [--out FILE]

For each seed, one JSON line a reading: the cell's numbers for

- ``program``: the program as a run drives it, without the measured window
  (training: set-up's checked steps; evaluation: one pass over the pool);
- ``control``: the reference computed with float8 products
  (``reference/numerics.py``) put in the program's place;
- ``half_batch``, ``row_altered`` (training): the float32 reference with
  that fault planted, put in the program's place (half of each batch left
  out and the mean taken over the rest; the first image row's output
  replaced by the second's).  A step that returns its state unchanged
  reads 1 by the ``grad`` and ``change`` measure and needs no run.

Each against the float32 reference of the same seed, at the cell's own
sizes.  ``--tiny`` runs ``tiny.py``'s sizes on ``--device cpu``.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(name: str, seed: int, what, device, cfg=None):
    import torch

    from benchmark import check, harness
    from benchmark.drivers.train import program_readings, readings_of_reference
    from benchmark.inputs import streams
    from benchmark.reference.numerics import Numerics, full_float32

    man = harness.manifest()
    cell = harness.workload(man, name)
    cfg = cfg or harness.config(cell["config"])
    traffic = harness.load_json(harness.HERE, "traffic", f"{cell['traffic']}.json")
    fam = harness.module("families", cfg["family"])
    seeds = streams(seed)
    pool = traffic["pool_batches"]
    train = traffic["kind"] == "train"
    k = fam.accumulation(cfg) if train else 1
    steps = traffic.get("checked_updates", 0) * k
    out = {}
    t0 = time.perf_counter()
    if "program" in what:
        prog = fam.Program(cfg, seeds, device, traffic["kind"], pool)
        if train:
            got = program_readings(prog, steps, k)
        else:
            for i in range(pool):
                prog.call(i)
            got = prog.results()
        batches = prog.batches
        del prog
        gc.collect()
    else:
        batches = fam.make_batches(cfg, pool, seeds["images"], device, traffic["kind"])
    if device != "cpu":
        torch.cuda.empty_cache()
    with full_float32():
        if train:
            ref = fam.reference_train(cfg, seeds, batches, steps, device, Numerics("float32"))
        else:
            ref = fam.reference_eval(cfg, seeds, batches, device, Numerics("float32"))

        def numbers(got_):
            if train:
                return check.train_numbers(got_, ref)
            return fam.eval_numbers(got_, ref)

        if "program" in what:
            out["program"] = numbers(got)
        if train:
            out["program" if "program" in what else "reference"] = dict(
                out.get("program", {}), first_norm=(ref.get("first_norm", 0.0), ""))
        if "control" in what:
            if train:
                low = fam.reference_train(cfg, seeds, batches, steps, device, Numerics("fp8"))
                out["control"] = numbers(readings_of_reference(low))
            else:
                low = fam.reference_eval(cfg, seeds, batches, device, Numerics("fp8"))
                out["control"] = numbers(fam.results_of_reference(low))
        for fault in ("half_batch", "row_altered"):
            if fault in what and train:
                bad = fam.reference_train(cfg, seeds, batches, steps, device,
                                          Numerics("float32"), fault=fault)
                out[fault] = numbers(readings_of_reference(bad))
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--what", default="program,control,half_batch,row_altered")
    parser.add_argument("--others-on", type=int, default=0,
                        help="read all but the program on the first N seeds only (0: all)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    what = args.what.split(",")
    cfg = None
    if args.tiny:
        from benchmark import harness
        from benchmark.tiny import tiny_config
        cfg = tiny_config(harness.workload(harness.manifest(), args.workload)["config"])
    sink = open(args.out, "a") if args.out else None
    for index, seed in enumerate(int(s) for s in args.seeds.split(",")):
        these = what if not args.others_on or index < args.others_on else ["program"]
        got, seconds = readings(args.workload, seed, these, args.device, cfg)
        for kind, numbers in got.items():
            line = json.dumps({"workload": args.workload, "seed": seed, "reading": kind,
                               "seconds": round(seconds, 2),
                               "numbers": {n: v for n, (v, _) in numbers.items()},
                               "worst": {n: d for n, (_, d) in numbers.items() if d}})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
