"""A/B of the int4 decode-matmul kernel variants on the card (counterpart
of scripts/bench_int4_kernel.py of the JAX package).

    python -m multimodal_concept_learning_tpu_torch.scripts.bench_int4_kernel \\
        --variants v2,v3a,v3b,int8 [--device cuda]

Times one decode step's worth of LM matmuls (26 layers x the 7 projection
shapes of gemma3-1b, batch 8, seeded numpy weights) under each variant,
chained as the JAX script chains them (each projection's input carries a
1e-30 multiple of the previous outputs, so nothing can be hoisted):

  v2     the port's K5 (``ops/int4.int4_matmul``, ``csrc/int4_matmul.cu``):
         the weight dequantized to bf16 (code x scale) before one product
  v3a    K5v3a (``ops/int4.v3a_matmul``): unscaled codes, a bf16
         tensor-core product a group, the group scale applied after it
  v3b    K5v3b (``ops/int4.v3b_matmul``): x quantized to int8 per (row,
         group) inside the kernel, an int8 tensor-core product a group,
         both scales after it (lossy in x: a different function)
  int8   the port's ``ops/quant.int8_matmul`` on int8 weights (cuBLAS
         ``torch._int_mm``) as the floor

On the card a step is captured once in a CUDA graph and replayed, so the
time is the device's, without the wrappers' host work; each variant
prints its min and median ms over 5 replays.  ``--device cpu`` runs one
eager step of the plain versions and times it on the host clock (a
rehearsal, not a device number).  A variant that raises prints FAILED, as
in the JAX script, and the run then exits non-zero.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.device import resolve_device, set_reference_numerics
from multimodal_concept_learning_tpu_torch.ops import int4 as i4
from multimodal_concept_learning_tpu_torch.ops import quant

# gemma3-1b per-layer projections: (d_in, d_out)
SHAPES = [(1152, 1024), (1152, 256), (1152, 256), (1024, 1152),
          (1152, 6912), (1152, 6912), (6912, 1152)]
LAYERS = 26
B = 8
# variant -> (matmul, whether it takes the int4 weights and is a kernel
# wrapper of the port with a launch count; int8 runs cuBLAS on int8 weights)
MATMULS = {"v2": (i4.int4_matmul, True), "v3a": (i4.v3a_matmul, True),
           "v3b": (i4.v3b_matmul, True), "int8": (quant.int8_matmul, False)}
VARIANTS = tuple(MATMULS)


def make_weights(device, shapes=SHAPES, seed: int = 0):
    """(int4 weights [(packed, scale)], int8 weights [(w_q, scale)], x0 [B,
    1152] bf16) from ``numpy.random.default_rng(seed)``, in the JAX script's
    order of draws."""
    rng = np.random.default_rng(seed)
    w4, w8 = [], []
    for di, do in shapes:
        w = torch.from_numpy(rng.normal(size=(di, do)).astype(np.float32)).to(device)
        w4.append(i4.quantize_weight_int4(w))
        w8.append(quant.quantize_weight(w))
    x0 = torch.from_numpy(rng.normal(size=(B, shapes[0][0])).astype(np.float32))
    return w4, w8, x0.to(device).to(torch.bfloat16)


def decode_step(mm, weights, x0, shapes=SHAPES, layers: int = LAYERS) -> torch.Tensor:
    """One decode step's matmuls, chained: returns the carried float32 scalar."""
    c = torch.zeros((), dtype=torch.float32, device=x0.device)
    x = x0
    for _ in range(layers):
        for (di, _do), wpair in zip(shapes, weights):
            xi = x if di == x0.shape[1] else (
                x[:, :1].expand(x.shape[0], di) + c.to(x.dtype))
            y = mm(xi, *wpair)
            c = c + y[:, :1].float().sum() * 1e-30
        x = x0 + c.to(x0.dtype)  # carry dependency, stable value
    return c


def _time_graph(step, reps: int = 5):
    """(ms per replay of ``step`` captured in one CUDA graph) x ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def run(variants, device, shapes=SHAPES, layers: int = LAYERS) -> dict:
    """{variant: {"ms", "median_ms", "calls", "launches", "r"} or {"error"}};
    ``launches`` is the variant's kernel-wrapper count over one eager step
    (None for int8), ``calls`` the matmuls of a step."""
    dev = resolve_device(device)
    w4, w8, x0 = make_weights(dev, shapes)
    results = {}
    for name in variants:
        if name not in MATMULS:
            raise ValueError(f"unknown variant {name!r}; choose from {VARIANTS}")
        mm, int4 = MATMULS[name]
        weights = w4 if int4 else w8
        calls = [0]

        def counted(*args, mm=mm):
            calls[0] += 1
            return mm(*args)

        try:
            before = mm.launches if int4 else 0
            t0 = time.perf_counter()
            with torch.inference_mode():
                r = float(decode_step(counted, weights, x0, shapes, layers))
            first_s = time.perf_counter() - t0
            launches = mm.launches - before if int4 else None
            print(f"[{name}] first step {first_s:.1f} s (r={r:.3e})", file=sys.stderr)
            if dev.type == "cuda":
                with torch.inference_mode():
                    times = _time_graph(lambda: decode_step(mm, weights, x0, shapes, layers))
                where = "device, CUDA graph replay"
            else:
                times = [1e3 * first_s]
                where = "cpu plain versions, host clock"
            results[name] = {"ms": min(times), "median_ms": statistics.median(times),
                             "calls": calls[0], "launches": launches, "r": r}
            print(f"[{name}] decode-step matmuls: {min(times):.4f} ms (median "
                  f"{statistics.median(times):.4f}; {where}; {calls[0]} matmuls, kernel "
                  f"launches {launches})", flush=True)
        except Exception as e:  # noqa: BLE001 - reported as the JAX script does, then exit 1
            results[name] = {"error": repr(e)}
            print(f"[{name}] FAILED: {repr(e)[:300]}", flush=True)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", type=str, default=",".join(VARIANTS))
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    set_reference_numerics()
    if args.device == "cuda":
        print(f"device: {torch.cuda.get_device_name(resolve_device('cuda'))}", flush=True)
    results = run(args.variants.split(","), args.device)
    if any("error" in r for r in results.values()):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
