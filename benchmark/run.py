"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload clip_b32_train --seed 7 --seconds 30 --trace 0

from the root of a checkout, on a machine with the card(s) the cell asks
for (``BENCHMARK.json``).  The last line of standard output is the
result's JSON object; the numbers that decided ``correct`` are also the
last lines of standard error.  With ``--trace 1`` the metrics are the
cell's per-layer ones.  Exits non-zero, printing no result, without
enough CUDA devices, or if JAX or the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    man = harness.manifest()
    cell = harness.workload(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         T_START, man)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    rows = result.pop("_check_rows")
    notes = result.pop("_notes")
    if notes:
        print(notes, file=sys.stderr)
    for name, value, limit, detail in rows:
        print(f"check {name} {value!r} limit {limit!r} {detail}".rstrip(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
