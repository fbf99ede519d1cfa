"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, on a line of their own;
2. build: compile the port's CUDA kernels from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving and training paths' shapes (max abs
   error, and kernel vs plain time from CUDA events); the build fails if
   ptxas reports spill stores in a tensor-core attention kernel (the bf16
   K1, K2 and K2-bd forwards, the bf16 backward pair of K2, K2-bd and K6,
   K1's bf16 backward pair);
4. parity: float32 MLLM at full width and reduced depth, ``paged_generate``
   on the card (through both kernels) must give exactly the greedy tokens
   of the same weights on the CPU plain path;
5. slice: a seeded random-init results dir of the full ``12_colors_3k``
   configuration, served by the port's paged server (``make_server``):
   16 requests from 16 threads, ``/healthz`` and ``/metrics`` over HTTP,
   launch counts of both kernels;
6. training parity: float32 MLLM at full width and reduced depth, three
   micro-steps with accumulation 2 on the card and on the CPU plain path:
   the same losses and trained tensors, frozen tensors bitwise unchanged;
7. training slice: the port's trainer CLI (``multimodal_training.main``)
   trains the full ``12_colors_3k`` model (seeded random init) for one epoch
   on a small generated 12-color dataset; launch counts of the K1 forward,
   dQ and dK/dV kernels per micro-step, finite losses, trained tensors
   moved, frozen tensors bitwise those of ``initial_model.pt``, the full
   results layout, and micro-steps/s and samples/s;
8. CLIP training parity: float32 CLIP at full width (ViT-B/32, 512-wide
   text tower) and 2 + 2 layers, batch 8, on the card (K2 kernels) and on
   the CPU plain path: the same first gradients, then three train steps
   with the same losses and parameters;
9. CLIP slice: the port's contrastive CLI (``contrastive_training.main``)
   trains the full ``experiments/contrastive/color/12_colors_3k.yaml`` CLIP
   (batch 256) for one epoch on a generated 12-color dataset (108 images per
   color); exact K2 launch counts, finite loss, zero-shot accuracy, every
   tensor moved, steps/s, images/s and peak memory;
10. quantized parity (run after phase 4): phase 4's model quantized by the
    serving loader, greedy tokens on the card == on the CPU, with int4 LM
    weights under ``MCL_PAGED_KERNEL=2`` (K5 and K4 launched, K3 not) and
    with int8 LM and vision weights;
11. quantized slice (run after phase 5, on its results dir): the paged
    server with ``int4=True`` under ``MCL_PAGED_KERNEL=2`` (K5 launches
    exactly 7 x 26 per decode step, K4 > 0, K3 0), then with
    ``int8=True, int8_vision=True``, 16 requests each; requests/s, tokens/s
    and p50 latency beside phase 5's;
12. variant parity (run after phase 8): phase 8 under
    ``MCL_ATTN_CORE_BD=1``, (a) with ``fused_attention=True`` in the vision
    tower (K6 there, K2-bd in the text tower) and (b) in the default layout
    (K2-bd in both towers); exact launch counts, K2 never launched;
13. variant slice (run after phase 9, on its data): the full CLIP with
    ``vision.fused_attention=True`` under ``MCL_ATTN_CORE_BD=1``, one epoch
    through ``make_clip_train_step``, then zero-shot; exactly 12 K6
    forward, 12 K6 backward, 12 K2-bd forward and 12 K2-bd backward
    launches a step, K2 0; steps/s, images/s, peak memory and a steady step
    on a fixed device batch beside phase 9's;
14. generation parity (run after phase 10): phase 4's model with a window
    of 64 on its sliding layer, ``greedy_generate`` on dense KV caches on
    the card == on the CPU plain path == ``paged_generate`` on the card,
    float and with int4 LM weights; exact launch counts (K1 per prefill
    and decode step, K5 7 x 2 per int4 decode step); the prefill,
    decode_step and decode_chunk hidden states CUDA vs CPU (1e-4);
15. answer slice (run after phase 7, on its results dir and generated
    data): the port's answer CLI (``generate_answers.main``) on the full
    ``12_colors_3k`` model, float, ``--int4`` and ``--int8 --int8_vision``,
    16 samples of 8 tokens at batch 8; the accuracy lines, the JSONL rows,
    exact launch counts (K1: 38 a prefill and 26 a decode step; K5 7 x 26
    a decode step under ``--int4``, else 0), samples/s and tokens/s;
16. A/B (run last): the port's int4 A/B entry point
    (``scripts/bench_int4_kernel.py``) at the JAX script's shapes (gemma3-1b's
    7 projections x 26 layers, batch 8): K5, K5v3a, K5v3b and the int8
    product, 182 launches of each kernel a step, ms a step by CUDA graph
    replay.

Phase 3 also holds K2-bd (the block-diagonal attention core: the CLIP
shapes, T 37, t_real < T, a sample with no valid key whose rows must be
exactly 0, 3 tokens a sample; the backward at three merges of samples) and
K6 (the fused attention sublayer: the vision shape, T 197, 37, t_real < T
and 320) to their plain versions, and the bf16 vision sublayer's gradients
(``fused_attention_sublayer`` on the card against the same autograd run on
CPU copies), the bf16 backwards of K2, K2-bd and K6 past the float32
kernels' 640 rows, one CLIP text block's bf16 gradients (causal, caption
masks; through K2, then K2-bd) against the same autograd run on CPU
copies, K1's backward in every case in float32 (the CUDA-core kernels)
and bf16 (the tensor-core pair; two calls bitwise equal), one gemma3-1b
decoder layer's bf16 gradients at the training batch against CPU
autograd, times K2-bd beside K2 at both CLIP shapes, K6's backward and
K1's backward beside SDPA's (all by CUDA graph replay), and K6's forward beside the
unfused library composition
(``F.layer_norm`` + ``F.linear`` + SDPA + ``F.linear`` + add); then K5
(int4 decode matmul; x in float32 and bf16, limits 1e-5 and 8e-3 of the
reference's max |value|) and K4 (multi-page paged
decode; pages_per_block 1, 3, 8) to their plain versions, and times each
kernel's path-shape case in bf16 beside its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, whichever is larger) and one PyTorch library
call computing the same function (SDPA, or its backward;
``torch._weight_int4pack_mm`` for K5 and K5v3a; none for K3, K4 and
K5v3b).  It also holds K5v3a and K5v3b (x float32 and bf16, rows 1, 8 and
16, gemma3-1b's seven projections; K5's limits) and times them cold at
up_proj beside K5, and holds K2, K2-bd and K6 at head dims 16 (vit-t-8
widths, T 17) and 32 in fp32 and bf16.  K1's forward is held at the ViT,
LM prefill, LM training and dense decode shapes (one query against a
269-slot cache under the float32 cache bias), a window, a bias, Tq < Tk
and head dim 128; K2's at the CLIP shapes and T 15 and 65 among others.
K5, K4 and the K1 and K2 forwards (with their SDPA calls) are timed by
CUDA graph replay (device time without the wrapper's host work), K5 with
its weights cycled past the L2 cache; phase 3 also times K4 beside K3 at
4 kv heads, ~1k context, pages of 16 and 64.  ``python3 chip_smoke.py
--profile`` builds the kernels and profiles the full CLIP train step
instead, on the default path and on the kernel variants (``torch.profiler``:
idle share, aten ops and device time by kernel).  ``python3 chip_smoke.py
--time-forwards ROOT`` builds the kernels of the checkout at ROOT and times
only the K1 and K2 forwards at their path shapes beside SDPA, and
``--time-variants ROOT`` K2-bd's forward and backward (beside K2) at both
CLIP shapes, K6's backward at the vision shape and K1's backward at the
LM training shape beside SDPA (an A/B between two checkouts runs either
on each in turns).  ``python3 chip_smoke.py --profile-mllm [ROOT]``
profiles the full MLLM micro-step with the port package of ROOT (default
this checkout): device busy, idle share, aten ops and K1's forward, dQ and
dK/dV in ms a micro-step.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max abs error vs the plain version, unit-scale inputs
D16 = "vit-t-8 head dim 16"  # K2, K2-bd and K6 at the tests' preset: hidden 64, 4 heads, T 17
D32 = "head dim 32"  # the third built head dim (no preset has it): hidden 128, 4 heads, T 17
LM_TRAIN_T = 197 + 24  # vision tokens + the collator's pad_to for 12_colors_3k
DECODE_CACHE = 269  # the answer CLI's dense cache: prompt (vision tokens + question) + 8 tokens
NEG = -1e30  # the JAX package's finite mask value, as the cache bias holds it


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, stream=None) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so the wrapper's host work is not timed (the
    event loop of ``cuda_time_ms`` times it where the host is slower).
    ``stream``: the capturing stream (an autograd backward runs its ops on
    the stream of its forward, so that forward must have run there)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores


def bound(nbytes: float, flops: float, ops_per_s: float = BF16_FLOPS_PER_S) -> dict:
    """The least time the card could take for a function that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops`` at ``ops_per_s`` (default: bf16): the larger of the two
    times, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / ops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    return out


TC_KERNELS = ("core_fwd_tc_kernel", "flash_fwd_tc_kernel", "bd_fwd_tc_kernel",
              "bwd_dq_tc_kernel", "bwd_dkv_tc_kernel")  # the tensor-core attention kernels
# K1 forward at D 64/128/256; K2 forward and K2-bd forward at D 16/32/64; the
# shared backward pair (dQ, dK/dV) at D 16/32/64 in five configurations: K6's
# and K2's four (causal or not x kv_mask or not); K1's backward pair
# (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel) at D 64/128/256
TC_INSTANTIATIONS = 3 + 3 + 3 + 2 * 3 * 5 + 2 * 3


def spill_stores(log: str) -> dict:
    """{mangled kernel name: bytes of spill stores} from ptxas's ``-v``
    report, for the entry functions (kernels) it compiled."""
    entries = set(re.findall(r"Compiling entry function '([^']+)'", log))
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name in entries:
            spills[name] = int(m.group(1))
        if m:
            name = None
    return spills


def phase_build(check_spills: bool = True) -> None:
    from multimodal_concept_learning_tpu_torch.ops import _build

    info = _build.build()
    _build.kernels()
    print(f"[build] {info['path']} in {info['seconds']:.1f} s", flush=True)
    for line in info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "properties")):
            print(f"[build] ptxas: {line.strip()}", flush=True)
    if not (check_spills and info["log"]):  # a reused library has no report
        return
    tc = {n: b for n, b in spill_stores(info["log"]).items() if any(k in n for k in TC_KERNELS)}
    print(f"[build] tensor-core attention kernels: {len(tc)} instantiations, spill stores "
          f"{sorted(set(tc.values()))} bytes", flush=True)
    if len(tc) != TC_INSTANTIATIONS or any(tc.values()):
        fail(f"tensor-core attention kernels: expected {TC_INSTANTIATIONS} instantiations "
             f"without spills, got {tc}")


def _flash_cases(torch, gen, dev):
    """(name, q, k, v, kwargs) at the K1 forward's path shapes: the ViT, LM
    prefill (serving, answering), the LM at the training batch, the answer
    CLI's dense decode step (one query a row against the whole cache under
    the float32 cache bias, a few slots masked), then a window, a float32
    bias, Tq < Tk under causal, and head dim 128."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    b, t = 8, LM_TRAIN_T
    lens = torch.randint(197, 262, (b,), generator=gen, device=dev).to(torch.int32)
    lens[0] = 261
    lm = dict(scale=1 / 16, kv_lens=lens, causal=True)
    train = dict(scale=1 / 16, kv_lens=torch.tensor([t, t - 9], dtype=torch.int32, device=dev),
                 causal=True)
    s = DECODE_CACHE
    cache_bias = torch.zeros(b, 1, 1, s, device=dev)
    cache_bias[:, :, :, -5:] = NEG  # slots not yet written
    cache_bias[1, :, :, 3:40] = NEG  # a row's left padding
    return [
        ("vit [8,197,12,64]", randn(b, 197, 12, 64), randn(b, 197, 12, 64),
         randn(b, 197, 12, 64), {}),
        ("lm [8,261,4/1,256] causal+kv_lens", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), lm),
        (f"lm train [2,{t},4/1,256] causal+kv_lens", randn(2, t, 4, 256), randn(2, t, 1, 256),
         randn(2, t, 1, 256), train),
        (f"decode [8,1,4/1,256] vs cache {s} + bias [8,1,1,{s}]", randn(b, 1, 4, 256),
         randn(b, s, 1, 256), randn(b, s, 1, 256), dict(scale=1 / 16, bias=cache_bias)),
        ("lm window 64", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, window=64)),
        ("lm + bias [8,1,261,261]", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, bias=randn(b, 1, 261, 261))),
        ("Tq 37 < Tk 100 causal [2,37,4/1,256]", randn(2, 37, 4, 256), randn(2, 100, 1, 256),
         randn(2, 100, 1, 256), dict(scale=1 / 16, causal=True)),
        ("d 128 [2,100,8/8,128] causal", randn(2, 100, 8, 128), randn(2, 100, 8, 128),
         randn(2, 100, 8, 128), dict(causal=True)),
    ]


K1_TIMED = ("vit [", "lm [", "lm train [", "decode [")  # K1 forward cases on a main path


def _flash_bwd_cases(torch, gen, dev):
    """(name, q, k, v, kwargs, bias needs grad) at the training path's K1
    shapes: the LM at batch 2 (4q/1kv heads of 256, causal + kv_lens, scale
    1/16), with a window, with a float32 bias that needs a gradient, and
    the ViT (12 heads of 64, no mask); then one case at head dim 128 and a
    ragged one at 256 (T 300: a partial last tile of keys and of rows, a
    row of padding past one tile)."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    t = LM_TRAIN_T
    lens = torch.tensor([t, t - 9], dtype=torch.int32, device=dev)
    lm = dict(scale=1 / 16, kv_lens=lens, causal=True)
    lm_qkv = lambda: (randn(2, t, 4, 256), randn(2, t, 1, 256), randn(2, t, 1, 256))  # noqa: E731
    return [
        (f"lm [2,{t},4/1,256] causal+kv_lens", *lm_qkv(), lm, False),
        ("lm window 64", *lm_qkv(), dict(lm, window=64), False),
        (f"lm + bias [2,1,{t},{t}] (dbias)", *lm_qkv(), dict(lm, bias=randn(2, 1, t, t)), True),
        ("vit [2,197,12,64]", randn(2, 197, 12, 64), randn(2, 197, 12, 64),
         randn(2, 197, 12, 64), {}, False),
        # the kernels' third head dim, group 4 over 2 kv heads, a per-head bias
        ("d 128 [2,100,8/2,128] causal + window 37 + bias [2,8,100,100]",
         randn(2, 100, 8, 128), randn(2, 100, 2, 128), randn(2, 100, 2, 128),
         dict(causal=True, window=37, bias=randn(2, 8, 100, 100)), True),
        ("ragged [2,300,4/1,256] causal + kv_lens [300, 251]", randn(2, 300, 4, 256),
         randn(2, 300, 1, 256), randn(2, 300, 1, 256),
         dict(scale=1 / 16, causal=True,
              kv_lens=torch.tensor([300, 251], dtype=torch.int32, device=dev)), False),
    ]


def _k1_pairs(torch, fa, q, k, mask: dict) -> int:
    """(query, key) pairs K1 computes for these inputs, over all q heads."""
    b, tq, hq, _ = q.shape
    ok = fa.key_mask(b, tq, k.shape[1], device=q.device, **mask)
    if ok is None:
        return b * hq * tq * k.shape[1]
    return int(ok.sum()) * (b if ok.shape[0] == 1 else 1) * hq


def _sdpa_k1(torch, fa, q, k, v, kw, grad_out=None, stream=None):
    """One ``scaled_dot_product_attention`` call (its backward with
    ``grad_out``, the forward run on ``stream``) on the same [B, T, H, D]
    tensors, mask and bias, as a yardstick."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = {key: kw[key] for key in ("kv_lens", "causal", "window") if key in kw}
    ok = fa.key_mask(q.shape[0], q.shape[1], k.shape[1], device=q.device, **mask)
    if kw.get("bias") is not None:  # a float mask: the bias, -inf where the descriptors mask
        bias = kw["bias"].to(q.dtype)
        ok = bias if ok is None else bias.masked_fill(~ok, float("-inf"))
    scale = kw.get("scale", q.shape[-1] ** -0.5)
    if grad_out is None:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: sdpa(qh, kh, vh, attn_mask=ok, scale=scale, enable_gqa=True)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad(), torch.cuda.stream(stream or torch.cuda.current_stream()):
        out = sdpa(*(x.transpose(1, 2) for x in leaves), attn_mask=ok, scale=scale,
                   enable_gqa=True)
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)
    go = grad_out.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, go, retain_graph=True)


def time_k1_bwd(torch, fa, name: str, q, k, v, do, kw, bias_grad: bool = False) -> dict:
    """K1's backward at one shape, bf16: the dQ and dK/dV kernels and SDPA's
    backward (its forward run on the capturing stream) by CUDA graph replay,
    the bounds (this run's attendable pairs; each kernel's own inputs read
    and outputs written once).  Prints and returns them."""
    mask = {key: kw[key] for key in ("kv_lens", "causal", "window") if key in kw}
    scale, bias = kw.get("scale", q.shape[-1] ** -0.5), kw.get("bias")
    o, lse = fa._launch(q, k, v, bias, scale, mask.get("kv_lens"), mask.get("causal", False),
                        mask.get("window"), with_lse=True)

    def dq_call():
        return fa.flash_attention_bwd_dq(q, k, v, o, lse, do, bias, scale=scale,
                                         need_ds=bias_grad, **mask)

    dq, delta, _ = dq_call()

    def dkv_call():
        return fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias, scale=scale, **mask)

    dk, dv = dkv_call()
    pairs = _k1_pairs(torch, fa, q, k, mask)
    d, stats = q.shape[-1], nbytes(lse, delta, kw.get("kv_lens"))
    side = torch.cuda.Stream()
    r = {"dq_ms": graph_time_ms(dq_call), "dkv_ms": graph_time_ms(dkv_call),
         "sdpa_ms": graph_time_ms(_sdpa_k1(torch, fa, q, k, v, kw, grad_out=do, stream=side),
                                  stream=side),
         "dq_bound": bound(nbytes(q, k, v, o, do, dq) + stats, 6 * d * pairs),
         "dkv_bound": bound(nbytes(q, k, v, do, dk, dv) + stats, 8 * d * pairs)}
    print(f"[kernels] K1 bwd {name} bf16 (graph replay): dq kernel {r['dq_ms']:.4f} ms, dkv "
          f"kernel {r['dkv_ms']:.4f} ms, together {r['dq_ms'] + r['dkv_ms']:.4f} ms; SDPA "
          f"backward {r['sdpa_ms']:.4f} ms; bound dq {r['dq_bound']['bound_ms']:.5f} ms, dkv "
          f"{r['dkv_bound']['bound_ms']:.5f} ms ({r['dkv_bound']['bound_by']})", flush=True)
    return r


def _phase_flash_bwd(torch, fa, gen, dev, report: dict) -> None:
    """Each backward kernel against the plain backward on the same saved
    (q, k, v, o, lse, dO): float32 (the CUDA-core kernels) <= 1e-4 abs,
    bf16 (the tensor-core pair) <= 2e-2 of the reference's max |value|, and
    two bf16 calls bitwise equal.  At the LM training shape in bf16 the
    kernels and SDPA's backward are timed by CUDA graph replay, the plain
    backward by the event loop."""
    kdq = report.setdefault("flash_attention_bwd_dq", {"max_abs_err": 0.0})
    kdkv = report.setdefault("flash_attention_bwd_dkv", {"max_abs_err": 0.0})
    for name, q, k, v, kw, bias_grad in _flash_bwd_cases(torch, gen, dev):
        do = torch.randn(q.shape, generator=gen, device=dev)
        mask = {key: kw[key] for key in ("kv_lens", "causal", "window") if key in kw}
        scale = kw.get("scale", q.shape[-1] ** -0.5)
        bias = kw.get("bias")
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, dod = (x.to(dtype) for x in (q, k, v, do))
            o, lse = fa._launch(qd, kd, vd, bias, scale, mask.get("kv_lens"),
                                mask.get("causal", False), mask.get("window"), with_lse=True)
            ref = fa.flash_attention_backward_reference(
                qd.float(), kd.float(), vd.float(), o.float(), lse, dod.float(), bias,
                scale=scale, **mask)

            def dq_call():
                return fa.flash_attention_bwd_dq(qd, kd, vd, o, lse, dod, bias, scale=scale,
                                                 need_ds=bias_grad, **mask)

            dq, delta, ds = dq_call()

            def dkv_call():
                return fa.flash_attention_bwd_dkv(qd, kd, vd, dod, lse, delta, bias,
                                                  scale=scale, **mask)

            dk, dv = dkv_call()
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            pairs = {"dq": (dq, ref[0]), "dk": (dk, ref[1]), "dv": (dv, ref[2])}
            if bias_grad:
                pairs["dbias"] = (fa._unbroadcast(ds, bias), ref[3])
            errs, ok = {}, True
            for g, (got, want) in pairs.items():
                errs[g] = (got.float() - want.float()).abs().max().item()
                limit = TOL[tag] if dtype is torch.float32 else TOL[tag] * want.abs().max().item()
                ok = ok and errs[g] <= limit
            same = True
            if dtype is torch.bfloat16:  # deterministic: no atomics, fixed order of sums
                again = dq_call()
                same = all(torch.equal(x, y) for x, y in
                           zip((dq, delta, ds, *dkv_call()),
                               (again[0], again[1], again[2], dk, dv)) if x is not None)
            dq_ms = cuda_time_ms(dq_call)
            dkv_ms = cuda_time_ms(dkv_call)
            plain_ms = cuda_time_ms(lambda: fa.flash_attention_backward_reference(
                qd, kd, vd, o, lse, dod, bias, scale=scale, **mask))
            print(f"[kernels] K1 bwd {name} {tag}: max_abs_err "
                  + " ".join(f"{g} {e:.3e}" for g, e in errs.items())
                  + f"; dq kernel {dq_ms:.4f} ms, dkv kernel {dkv_ms:.4f} ms, "
                  f"plain backward {plain_ms:.4f} ms"
                  + ("; two calls bitwise equal" if dtype is torch.bfloat16 and same else ""),
                  flush=True)
            if not ok:
                fail(f"K1 bwd {name} {tag}: errors {errs}")
            if not same:
                fail(f"K1 bwd {name} {tag}: two calls gave different gradients")
            kdq["max_abs_err"] = max(kdq["max_abs_err"], errs["dq"], errs.get("dbias", 0.0))
            kdkv["max_abs_err"] = max(kdkv["max_abs_err"], errs["dk"], errs["dv"])
            if name.startswith("lm [") and dtype is torch.bfloat16:
                r = time_k1_bwd(torch, fa, name, qd, kd, vd, dod, kw, bias_grad)
                kdq.update(ms=r["dq_ms"], plain_ms=plain_ms, library_ms=r["sdpa_ms"],
                           **r["dq_bound"])
                kdkv.update(ms=r["dkv_ms"], plain_ms=plain_ms, library_ms=r["sdpa_ms"],
                            **r["dkv_bound"])


CLIP_CONFIG = os.path.join(REPO, "experiments/contrastive/color/12_colors_3k.yaml")
CLIP_CAPTION = "a circle of color {class_name}"  # the config's caption_template
CLIP_BATCH = 256


def _color_names() -> list:
    """The 12_colors_3k class names (r{R}g{G}b{B}), in the dataset's order."""
    from multimodal_concept_learning_tpu_torch import miniyaml

    with open(os.path.join(REPO, "experiments/datasets/color/12_colors_3k.yaml")) as f:
        colors = miniyaml.safe_load(f)["colors"]
    return [f"r{r}g{g}b{b}" for r, g, b in colors]


def _caption_masks(b: int) -> np.ndarray:
    """[b, 77] int32 caption masks of the CLIP slice (row i: class i % 12)."""
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    collator = ClipCollator(load_tokenizer("concept-tokenizer"), CLIP_CAPTION, 77)
    masks = [collator.caption_ids(n)[1] for n in _color_names()]
    return np.stack([masks[i % len(masks)] for i in range(b)])


def _core_cases(torch, gen, dev):
    """(name, qkv, heads, t_real, causal, kv_mask, on the path): the CLIP
    path's two K2 shapes, then ViT-B/16, ViT-L/14, a kv_mask with holes,
    t_real below T (keys at or past it masked) with and without a mask, T
    15 and 65 (around the forward's 16-row warp and 64-row tiles) with and
    without causal + holes, and head dims 16 and 32."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    holes = (torch.rand(16, 77, generator=gen, device=dev) < 0.5).to(torch.int32)
    holes[:, 0] = 1  # every causal row keeps a valid key
    captions = torch.from_numpy(_caption_masks(CLIP_BATCH)).to(dev)
    return [
        ("vision [256,50,12x64]", randn(CLIP_BATCH, 50, 3 * 768), 12, 50, False, None, True),
        ("text [256,77,8x64] causal + caption mask", randn(CLIP_BATCH, 77, 3 * 512), 8, 77, True,
         captions, True),
        ("vit-b/16 [8,197,12x64]", randn(8, 197, 3 * 768), 12, 197, False, None, False),
        ("vit-l/14 [8,257,16x64]", randn(8, 257, 3 * 1024), 16, 257, False, None, False),
        ("kv_mask with holes [16,77,8x64] causal", randn(16, 77, 3 * 512), 8, 77, True, holes,
         False),
        ("t_real 41 of 64 [16,64,12x64]", randn(16, 64, 3 * 768), 12, 41, False, None, False),
        ("t_real 60 of 80 [16,80,8x64] causal + holes", randn(16, 80, 3 * 512), 8, 60, True,
         torch.nn.functional.pad(holes, (0, 3)), False),
        ("T 15 [16,15,8x64]", randn(16, 15, 3 * 512), 8, 15, False, None, False),
        ("T 15 [16,15,8x64] causal + holes", randn(16, 15, 3 * 512), 8, 15, True,
         holes[:, :15].contiguous(), False),
        ("T 65 [16,65,8x64]", randn(16, 65, 3 * 512), 8, 65, False, None, False),
        ("T 65 [16,65,8x64] causal + holes", randn(16, 65, 3 * 512), 8, 65, True,
         holes[:, :65].contiguous(), False),
        (f"{D16} [16,17,4x16]", randn(16, 17, 3 * 64), 4, 17, False, None, False),
        (f"{D16} [16,17,4x16] causal + holes", randn(16, 17, 3 * 64), 4, 17, True,
         holes[:, :17].contiguous(), False),
        (f"{D32} [16,17,4x32]", randn(16, 17, 3 * 128), 4, 17, False, None, False),
        (f"{D32} [16,17,4x32] causal + holes", randn(16, 17, 3 * 128), 4, 17, True,
         holes[:, :17].contiguous(), False),
    ]


def _k2_bytes(qkv, kvm, t_real: int, *moved) -> int:
    """Bytes the K2 function must move: the q columns of every row, the k
    and v columns of each sample's rows up to its last valid key (below
    ``t_real``, kept by ``kvm``), the mask, and the tensors ``moved`` (dA
    read, the output or dqkv written), each once."""
    import torch

    b, t, hd3 = qkv.shape
    hd, elt = hd3 // 3, qkv.element_size()
    keys = min(t, t_real)
    if kvm is None:
        kv_rows = b * keys
    else:  # one past each sample's last kept key, 0 for a sample with none
        pos = torch.arange(1, keys + 1, device=kvm.device)
        kv_rows = int(((kvm[:, :keys] != 0) * pos).amax(dim=1).sum())
    return b * t * hd * elt + 2 * kv_rows * hd * elt + nbytes(kvm, *moved)


def _sdpa_core(torch, ac, qkv, heads, causal, kvm, grad_out=None, stream=None):
    """``scaled_dot_product_attention`` (its backward with ``grad_out``, the
    forward run on ``stream``) on the [B, H, T, D] views of the packed qkv,
    the mask as a boolean ``attn_mask``: a yardstick of one library call."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, t, _ = qkv.shape
    ok = None if not causal and kvm is None else ac.key_ok(b, t, t, causal, kvm, qkv.device)

    def heads_of(x):
        return [p.transpose(1, 2) for p in x.view(b, t, 3, heads, -1).unbind(2)]

    if grad_out is None:
        q, k, v = heads_of(qkv)
        return lambda: sdpa(q, k, v, attn_mask=ok)
    leaf = qkv.detach().requires_grad_(True)
    with torch.enable_grad(), torch.cuda.stream(stream or torch.cuda.current_stream()):
        out = sdpa(*heads_of(leaf), attn_mask=ok)
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)
    go = grad_out.view(b, t, heads, -1).transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaf, go, retain_graph=True)


def sdpa_bwd_ms(torch, ac, qkv, heads, causal, kvm, grad_out) -> float:
    """SDPA's backward on the packed qkv by CUDA graph replay, its forward
    run on the capturing stream."""
    side = torch.cuda.Stream()
    return graph_time_ms(_sdpa_core(torch, ac, qkv, heads, causal, kvm, grad_out, stream=side),
                         stream=side)


def _phase_core(torch, gen, dev, report: dict) -> None:
    """K2 forward and backward against their plain versions on the same
    inputs: float32 <= 1e-4 abs (outputs, lse, dqkv), bf16 outputs and
    dqkv <= 2e-2 of the reference's max |value| (lse <= 1e-4); times at the
    path's shapes in bf16 beside the bound and SDPA (each kernel and SDPA
    call by CUDA graph replay, the plain versions by the event loop)."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac

    kf = report.setdefault("attention_core_fwd", {"max_abs_err": 0.0})
    kb = report.setdefault("attention_core_bwd", {"max_abs_err": 0.0})
    for name, qkv32, heads, t_real, causal, kvm, on_path in _core_cases(torch, gen, dev):
        b, t, hd3 = qkv32.shape
        da32 = torch.randn(b, t, hd3 // 3, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            qkv, da = qkv32.to(dtype), da32.to(dtype)

            def fwd():
                return ac.attention_core_fwd(qkv, heads, t_real, causal, kvm, with_lse=True)

            out, lse = fwd()
            # the bf16 backward recomputes lse from qkv and dA: it takes neither
            saved = (out, lse) if dtype is torch.float32 else (None, None)

            def bwd():
                return ac.attention_core_bwd(qkv, saved[0], da, saved[1], heads, t_real, causal,
                                             kvm)

            dqkv = bwd()
            ref, ref_lse = ac.attention_core_reference(qkv.float(), heads, t_real, causal, kvm,
                                                       return_lse=True)
            ref_d = ac.attention_core_backward_reference(qkv.float(), da.float(), heads, t_real,
                                                         causal, kvm)
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            err = (out.float() - ref).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            err_d = (dqkv.float() - ref_d).abs().max().item()
            # bf16: a fraction of the reference's largest value, outputs and gradients alike
            limit = TOL[tag] * (1.0 if dtype is torch.float32 else ref.abs().max().item())
            limit_d = TOL[tag] * (1.0 if dtype is torch.float32 else ref_d.abs().max().item())
            # the forward as a training step runs it: lse only where the backward reads it
            ms = graph_time_ms(lambda: ac.attention_core_fwd(qkv, heads, t_real, causal, kvm,
                                                             with_lse=dtype is torch.float32))
            bwd_ms = cuda_time_ms(bwd)
            plain_ms = cuda_time_ms(lambda: ac.attention_core_reference(qkv, heads, t_real,
                                                                        causal, kvm))
            plain_bwd_ms = cuda_time_ms(lambda: ac.attention_core_backward_reference(
                qkv, da, heads, t_real, causal, kvm))
            print(f"[kernels] K2 {name} {tag}: max_abs_err out {err:.3e} lse {err_lse:.3e} "
                  f"dqkv {err_d:.3e}; fwd kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
                  f"bwd kernel {bwd_ms:.4f} ms plain {plain_bwd_ms:.4f} ms", flush=True)
            if not (err <= limit and err_lse <= TOL["float32"] and err_d <= limit_d):
                fail(f"K2 {name} {tag}: errors out {err}, lse {err_lse}, dqkv {err_d}")
            kf["max_abs_err"] = max(kf["max_abs_err"], err)
            kb["max_abs_err"] = max(kb["max_abs_err"], err_d)
            if not (on_path and dtype is torch.bfloat16):
                continue
            ok = ac.key_ok(b, t, t, causal, kvm, qkv.device)
            pairs = int(ok.sum()) * (b if ok.shape[0] == 1 else 1) * heads
            d = hd3 // (3 * heads)
            lib_ms = graph_time_ms(_sdpa_core(torch, ac, qkv, heads, causal, kvm))
            lib_bwd_ms = sdpa_bwd_ms(torch, ac, qkv, heads, causal, kvm, da)
            bwd_ms = graph_time_ms(bwd)
            # the function's bytes: the port's saved out and lse are left out,
            # since the TPU backward takes only qkv and dA (and recomputes P)
            fb = bound(_k2_bytes(qkv, kvm, t, out), 4 * d * pairs)
            bb = bound(_k2_bytes(qkv, kvm, t, da, dqkv), 10 * d * pairs)
            print(f"[kernels] K2 {name} bf16: fwd bound {fb['bound_ms']:.5f} ms "
                  f"({fb['bound_by']}), SDPA {lib_ms:.4f} ms; bwd kernel {bwd_ms:.4f} ms and SDPA "
                  f"backward {lib_bwd_ms:.4f} ms, bound {bb['bound_ms']:.5f} ms "
                  f"({bb['bound_by']})", flush=True)
            if name.startswith("vision"):  # the JSON line's numbers: the vision tower's shape
                kf.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **fb)
                kb.update(ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms, **bb)


def _phase_past_cap(torch, gen, dev) -> None:
    """The bf16 backward kernels past 640 rows, where only float32 keeps the
    cap (its [rows, D] dQ tile): K2 at T 700 (causal, holes, t_real 690),
    K2-bd at 9 text samples a block (693 merged rows, causal, captions) and
    K6 at 13 vision samples a block (650 rows), each held to its plain
    version at 2e-2 of the reference's max |value| (the bf16 pair groups
    rows in slots of one sample and does not read bblk: the merges show
    that the wrappers let them through); K2 in float32 at T 700 must raise
    ValueError."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import fused_attention_block as fb

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    bf16 = torch.bfloat16
    holes = (torch.rand(2, 700, generator=gen, device=dev) < 0.5).to(torch.int32)
    holes[:, 0] = 1
    qkv, da = randn(2, 700, 3 * 128).to(bf16), randn(2, 700, 128).to(bf16)
    args = (2, 690, True, holes)
    errs = {"K2 T 700 [2,700,2x64] causal + holes, t_real 690": _held(
        ac.attention_core_bwd(qkv, None, da, None, *args),
        ac.attention_core_backward_reference(qkv.float(), da.float(), *args), bf16,
        "K2 bwd T 700")}
    out, lse = ac.attention_core_fwd(qkv.float(), *args, with_lse=True)
    try:
        ac.attention_core_bwd(qkv.float(), out, da.float(), lse, *args)
        fail("K2 float32 backward at T 700 was not refused")
    except ValueError:
        pass
    captions = torch.from_numpy(_caption_masks(18)).to(dev)
    qkv, da = randn(18, 77, 3 * 512).to(bf16), randn(18, 77, 512).to(bf16)
    args = (8, 77, True, captions)
    errs["K2-bd text [18,77,8x64] bblk 9 (693 rows)"] = _held(
        ac.attention_core_bd_bwd(qkv, None, da, None, *args, bblk=9),
        ac.attention_core_bd_backward_reference(qkv.float(), da.float(), *args), bf16,
        "K2-bd bwd bblk 9")
    qkv, da = randn(26, 50, 3 * 768).to(bf16), randn(26, 50, 768).to(bf16)
    errs["K6 vision [26,50,12x64] bblk 13 (650 rows)"] = _held(
        fb.fused_bwd_attn(qkv, da, 12, 50, bblk=13),
        fb.fused_bwd_attn_reference(qkv, da, 12, 50), bf16, "K6 bwd bblk 13")
    torch.cuda.synchronize()
    print("[kernels] bf16 backward past 640 rows: max_abs_err "
          + "; ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + "; K2 float32 at T 700 refused", flush=True)


def _phase_text_block_grads(torch, gen, dev) -> None:
    """One CLIP text block (width 512, 8 heads, bf16 compute: causal, the
    slice's caption masks at T 77) on the card against the same autograd run
    on CPU copies (the plain versions), through K2 and then K2-bd
    (``MCL_ATTN_CORE_BD=1``): dx and every parameter gradient within 2e-2 of
    its own reference's max |value|, but for the key bias's: that is zero
    in exact arithmetic (a shift of every key's score by q·b leaves the
    softmax as it is), so what it holds is rounding noise with no scale of
    its own, held against the max of the q, k and v biases' gradients (the
    packed projection's bias, as ``_phase_fused_grads`` holds K6's bqkv)
    and printed beside the CPU's."""
    import copy

    from multimodal_concept_learning_tpu_torch.models.clip import TextBlock

    b, t, width = 16, 77, 512
    block = TextBlock(width, 8, torch.bfloat16)
    for prm in block.parameters():  # seeded weights: std 0.05 (matrices), 0.1 (vectors)
        std = 0.05 if prm.dim() == 2 else 0.1
        prm.data = (std * torch.randn(prm.shape, generator=gen, device=dev)).cpu()
    for ln in (block.ln_1, block.ln_2):
        ln.weight.data += 1.0
    x = torch.randn(b, t, width, generator=gen, device=dev).to(torch.bfloat16).cpu()
    dy = torch.randn(b, t, width, generator=gen, device=dev).to(torch.bfloat16).cpu()
    kvm = torch.from_numpy(_caption_masks(b))

    old = os.environ.get("MCL_ATTN_CORE_BD")
    try:
        for bd in ("0", "1"):
            os.environ["MCL_ATTN_CORE_BD"] = bd
            grads = {}
            for where in (dev, "cpu"):
                mod = copy.deepcopy(block).to(where)
                xl = x.to(where).clone().requires_grad_(True)  # a new leaf each pass
                with torch.enable_grad():  # phase 3 runs under no_grad
                    mod(xl, kvm.to(where)).backward(dy.to(where))
                grads[str(where)] = {"x": xl.grad.float().cpu(),
                                     **{n: p.grad.float().cpu() for n, p in mod.named_parameters()}}
            what = "K2-bd" if bd == "1" else "K2"
            cpu, card = grads["cpu"], grads[str(dev)]
            errs = {n: _held(g, cpu[n], torch.bfloat16, f"text block ({what}) d {n}")
                    for n, g in card.items() if n != "k.bias"}
            bias_max = max(cpu[f"{x}.bias"].abs().max().item() for x in "qkv")
            err_kb = (card["k.bias"] - cpu["k.bias"]).abs().max().item()
            if not err_kb <= TOL["bfloat16"] * bias_max:
                fail(f"text block ({what}) d k.bias: max abs err {err_kb} > "
                     f"{TOL['bfloat16']} x {bias_max} (the q, k, v biases' max)")
            print(f"[kernels] CLIP text block gradients [16,77,512] causal + captions bf16 "
                  f"through {what}, card vs CPU: max abs err "
                  + ", ".join(f"d {n} {e:.3e}" for n, e in errs.items())
                  + f", d k.bias {err_kb:.3e} (|d k.bias| max: card "
                  f"{card['k.bias'].abs().max().item():.3e}, CPU "
                  f"{cpu['k.bias'].abs().max().item():.3e}; q, k, v biases' max "
                  f"{bias_max:.3e})", flush=True)
    finally:
        if old is None:
            os.environ.pop("MCL_ATTN_CORE_BD", None)
        else:
            os.environ["MCL_ATTN_CORE_BD"] = old


def _phase_lm_layer_grads(torch, gen, dev) -> None:
    """One full-width gemma3-1b decoder layer (hidden 1152, 4q/1kv heads of
    256, q/k norms, sandwich norms, bf16 compute) at the training batch:
    batch 2, T 221, causal + kv_lens [221, 212], on the card (K1's forward
    and its bf16 dQ and dK/dV kernels) against the same autograd run on CPU
    copies (the plain versions): dx and the q, k, v and o projections'
    weight gradients each within 2e-2 of its own reference's max |value|;
    the layer's other gradients are printed beside them."""
    import copy

    from multimodal_concept_learning_tpu_torch.models.lm import LMBlock, LMConfig, rope_tables
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa

    b, t = 2, LM_TRAIN_T
    cfg = LMConfig.preset("gemma3-1b", vocab_size=1148)
    block = LMBlock(cfg)
    for prm in block.parameters():  # seeded weights: std 0.03 (matrices), 0.1 (norms)
        std = 0.03 if prm.dim() == 2 else 0.1
        prm.data = (std * torch.randn(prm.shape, generator=gen, device=dev)).cpu()
    x = torch.randn(b, t, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16).cpu()
    dy = torch.randn(b, t, cfg.hidden_size, generator=gen, device=dev).to(torch.bfloat16).cpu()
    kv_lens = torch.tensor([t, t - 9], dtype=torch.int32)
    positions = torch.arange(t)[None].expand(b, t)
    grads, launched = {}, {}
    for where in (dev, "cpu"):
        mod = copy.deepcopy(block).to(where)
        xl = x.to(where).clone().requires_grad_(True)
        rope = tuple(r.to(where) for r in rope_tables(positions, cfg.head_dim, cfg.rope_theta))
        before = (fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches)
        with torch.enable_grad():  # phase 3 runs under no_grad
            mod(xl, rope, kv_lens=kv_lens.to(where)).backward(dy.to(where))
        launched[str(where)] = (fa.flash_attention_bwd_dq.launches - before[0],
                                fa.flash_attention_bwd_dkv.launches - before[1])
        grads[str(where)] = {"x": xl.grad.float().cpu(),
                             **{n: p.grad.float().cpu() for n, p in mod.named_parameters()}}
    cpu, card = grads["cpu"], grads[str(dev)]
    held = ("x",) + tuple(f"self_attn.{w}_proj.weight" for w in "qkvo")
    errs = {n: _held(card[n], cpu[n], torch.bfloat16, f"LM layer d {n}") for n in held}
    other = {n: (card[n] - cpu[n]).abs().max().item() / max(cpu[n].abs().max().item(), 1e-30)
             for n in card if n not in held}
    print(f"[kernels] gemma3-1b decoder layer gradients [2,{t},1152] causal + kv_lens bf16, "
          f"card vs CPU: max abs err " + ", ".join(f"d {n} {e:.3e}" for n, e in errs.items())
          + "; the other gradients' err / max: "
          + ", ".join(f"d {n} {e:.2e}" for n, e in other.items())
          + f"; backward launches (dQ, dK/dV) card {launched[str(dev)]}, CPU {launched['cpu']}",
          flush=True)
    if launched[str(dev)] != (1, 1) or launched["cpu"] != (0, 0):
        fail(f"LM layer gradients: backward launches {launched}")


def _core_bd_cases(torch, gen, dev):
    """(name, qkv, heads, t_real, causal, kv_mask, on the path): the CLIP
    path's two shapes (the text tower first: K2-bd's row), then T not a
    multiple of 16, t_real below T, a mask with holes and a sample with no
    valid key, and three tokens a sample (many samples a tile)."""

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    holes = (torch.rand(16, 77, generator=gen, device=dev) < 0.5).to(torch.int32)
    holes[:, 0] = 1
    empty = holes.clone()
    empty[5] = 0  # sample 5: no valid key, rows exactly 0
    captions = torch.from_numpy(_caption_masks(CLIP_BATCH)).to(dev)
    return [
        ("text [256,77,8x64] causal + caption mask", randn(CLIP_BATCH, 77, 3 * 512), 8, 77, True,
         captions, True),
        ("vision [256,50,12x64]", randn(CLIP_BATCH, 50, 3 * 768), 12, 50, False, None, True),
        ("T 37 [16,37,8x64] causal + holes", randn(16, 37, 3 * 512), 8, 37, True,
         holes[:, :37].contiguous(), False),
        ("t_real 41 of 64 [16,64,12x64]", randn(16, 64, 3 * 768), 12, 41, False, None, False),
        ("holes + a sample with no valid key [16,77,8x64]", randn(16, 77, 3 * 512), 8, 77, False,
         empty, False),
        ("T 3 [70,3,4x64] causal", randn(70, 3, 3 * 256), 4, 3, True, None, False),
        (f"{D16} [16,17,4x16]", randn(16, 17, 3 * 64), 4, 17, False, None, False),
        (f"{D16} [16,17,4x16] causal + holes", randn(16, 17, 3 * 64), 4, 17, True,
         holes[:, :17].contiguous(), False),
        (f"{D32} [16,17,4x32]", randn(16, 17, 3 * 128), 4, 17, False, None, False),
        (f"{D32} [16,17,4x32] causal + holes", randn(16, 17, 3 * 128), 4, 17, True,
         holes[:, :17].contiguous(), False),
    ]


def _held(got, want, dtype, what: str) -> float:
    """Max abs error of ``got`` against ``want``; fails past float32 1e-4
    abs or bf16 2e-2 of the reference's max |value|."""
    import torch

    tag = str(dtype).replace("torch.", "")
    err = (got.float() - want.float()).abs().max().item()
    limit = TOL[tag] * (1.0 if dtype is torch.float32 else want.float().abs().max().item())
    if not err <= limit:
        fail(f"{what} {tag}: max abs err {err} > {limit}")
    return err


def _phase_core_bd(torch, gen, dev, report: dict) -> None:
    """K2-bd forward and backward against their plain versions on the same
    inputs (float32 reference, as K2): float32 <= 1e-4 abs, bf16 <= 2e-2 of
    the reference's max |value|, lse <= 1e-4; rows of a sample with no
    valid key exactly 0; the backward at merges of 1, 2 and the default
    number of samples a CTA.  At the path's shapes in bf16: K2-bd beside
    K2, the bound and SDPA (K2-bd's row: the text tower, its main path)."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac

    kf = report.setdefault("attention_core_bd_fwd", {"max_abs_err": 0.0})
    kb = report.setdefault("attention_core_bd_bwd", {"max_abs_err": 0.0})
    for name, qkv32, heads, t_real, causal, kvm, on_path in _core_bd_cases(torch, gen, dev):
        b, t, hd3 = qkv32.shape
        da32 = torch.randn(b, t, hd3 // 3, generator=gen, device=dev)
        merges = sorted({1, 2, ac.bd_block(t)})
        for dtype in (torch.float32, torch.bfloat16):
            qkv, da = qkv32.to(dtype), da32.to(dtype)
            args = (heads, t_real, causal, kvm)
            out, lse = ac.attention_core_bd_fwd(qkv, *args, with_lse=True)
            # the bf16 backward recomputes lse from qkv and dA: it takes neither
            saved = (out, lse) if dtype is torch.float32 else (None, None)
            grads = {m: ac.attention_core_bd_bwd(qkv, saved[0], da, saved[1], *args, bblk=m)
                     for m in merges}
            ref, ref_lse = ac.attention_core_bd_reference(qkv.float(), *args, return_lse=True)
            ref_d = ac.attention_core_bd_backward_reference(qkv.float(), da.float(), *args)
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            err = _held(out, ref, dtype, f"K2-bd fwd {name}")
            # +inf on both sides for a row with no valid key
            err_lse = (lse - ref_lse).masked_fill(lse == ref_lse, 0.0).abs().max().item()
            if not err_lse <= TOL["float32"]:
                fail(f"K2-bd fwd {name} {tag}: lse error {err_lse}")
            err_d = max(_held(g, ref_d, dtype, f"K2-bd bwd {name} bblk {m}")
                        for m, g in grads.items())
            zero = "" if kvm is None or kvm.any(dim=1).all() else (
                f"; rows of the empty sample: out {out[5].abs().max().item():.1e}, dqkv "
                f"{max(g[5].abs().max().item() for g in grads.values()):.1e}")
            if zero and (out[5].any() or any(g[5].any() for g in grads.values())):
                fail(f"K2-bd {name} {tag}: a row with no valid key is not 0{zero}")
            print(f"[kernels] K2-bd {name} {tag}: max_abs_err out {err:.3e} lse {err_lse:.3e} "
                  f"dqkv {err_d:.3e} (backward merges {merges}){zero}", flush=True)
            kf["max_abs_err"] = max(kf["max_abs_err"], err)
            kb["max_abs_err"] = max(kb["max_abs_err"], err_d)
            if name == f"{D16} [16,17,4x16]" and dtype is torch.bfloat16:
                f_ms = cuda_time_ms(lambda: ac.attention_core_bd_fwd(qkv, *args, with_lse=True))
                b_ms = cuda_time_ms(lambda: ac.attention_core_bd_bwd(qkv, None, da, None, *args))
                print(f"[kernels] K2-bd {name} bf16: fwd kernel {f_ms:.4f} ms, bwd kernel "
                      f"{b_ms:.4f} ms", flush=True)
            if not (on_path and dtype is torch.bfloat16):
                continue
            r = time_bd(torch, ac, name, qkv, da, args)
            if name.startswith("text"):  # the JSON line's numbers: K2-bd's main path
                kf.update(ms=r["fwd"], plain_ms=r["plain_fwd"], library_ms=r["sdpa_fwd"],
                          **r["fwd_bound"])
                kb.update(ms=r["bwd"], plain_ms=r["plain_bwd"], library_ms=r["sdpa_bwd"],
                          **r["bwd_bound"])


def time_bd(torch, ac, name: str, qkv, da, args, plain: bool = True) -> dict:
    """K2-bd beside K2 at one CLIP shape, bf16, forward and backward, each
    by CUDA graph replay in two rounds (K2, K2-bd, K2-bd, K2: the order
    cancels drift; the least of each kept), beside SDPA (graph replay), the
    plain versions (event loop) and the bounds (this run's attendable pairs
    and live key rows).  Prints and returns them."""
    heads, _, causal, kvm = args
    b, t, hd3 = qkv.shape
    times = {}
    for rnd in range(2):
        for kind in (("k2", "bd"), ("bd", "k2"))[rnd]:
            fwd = ac.attention_core_bd_fwd if kind == "bd" else ac.attention_core_fwd
            bwd = ac.attention_core_bd_bwd if kind == "bd" else ac.attention_core_bwd
            # as a training step runs them: the bf16 backward takes no out or lse
            f_ms = graph_time_ms(lambda: fwd(qkv, *args, with_lse=False))
            b_ms = graph_time_ms(lambda: bwd(qkv, None, da, None, *args))
            times.setdefault(kind, []).append((f_ms, b_ms))
    out = ac.attention_core_bd_fwd(qkv, *args, with_lse=False)[0]
    dqkv = ac.attention_core_bd_bwd(qkv, None, da, None, *args)
    ok = ac.key_ok(b, t, t, causal, kvm, qkv.device)
    pairs = int(ok.sum()) * (b if ok.shape[0] == 1 else 1) * heads
    d = hd3 // (3 * heads)
    r = {"fwd": min(f for f, _ in times["bd"]), "bwd": min(bw for _, bw in times["bd"]),
         "k2_fwd": min(f for f, _ in times["k2"]), "k2_bwd": min(bw for _, bw in times["k2"]),
         "sdpa_fwd": graph_time_ms(_sdpa_core(torch, ac, qkv, heads, causal, kvm)),
         "fwd_bound": bound(_k2_bytes(qkv, kvm, t, out), 4 * d * pairs),
         "bwd_bound": bound(_k2_bytes(qkv, kvm, t, da, dqkv), 10 * d * pairs)}
    r["sdpa_bwd"] = sdpa_bwd_ms(torch, ac, qkv, heads, causal, kvm, da)
    r["plain_fwd"] = r["plain_bwd"] = None
    if plain:
        r["plain_fwd"] = cuda_time_ms(lambda: ac.attention_core_bd_reference(qkv, *args))
        r["plain_bwd"] = cuda_time_ms(lambda: ac.attention_core_bd_backward_reference(
            qkv, da, *args))
    print(f"[kernels] K2 vs K2-bd {name} bf16 (ms by graph replay, fwd / bwd, two rounds "
          f"each): K2 " + ", ".join(f"{f:.4f} / {bw:.4f}" for f, bw in times["k2"])
          + "; K2-bd " + ", ".join(f"{f:.4f} / {bw:.4f}" for f, bw in times["bd"])
          + f"; SDPA {r['sdpa_fwd']:.4f} / {r['sdpa_bwd']:.4f}"
          + (f"; plain {r['plain_fwd']:.4f} / {r['plain_bwd']:.4f}" if plain else "")
          + f"; bound {r['fwd_bound']['bound_ms']:.5f} / {r['bwd_bound']['bound_ms']:.5f}",
          flush=True)
    return r


def _fused_cases(torch, gen, dev):
    """(name, x, params, heads, t_real, on the path): the vision tower's
    shape, the MLLM tower's T = 197, T not a multiple of 16, t_real below
    T, and the kernels' largest T (320).  Weights std 0.05 (qkv) and 0.02
    (o), so that the attention is far from uniform."""

    def randn(*shape, s=1.0):
        return s * torch.randn(*shape, generator=gen, device=dev)

    def params(w):
        return (1 + randn(w, s=0.1), randn(w, s=0.1), randn(w, 3 * w, s=0.05),
                randn(3 * w, s=0.1), randn(w, w, s=0.02), randn(w, s=0.1))

    p768 = params(768)
    return [
        ("vision [256,50,768] 12 heads", randn(CLIP_BATCH, 50, 768), p768, 12, 50, True),
        ("vit-b/16 T 197 [8,197,768]", randn(8, 197, 768), p768, 12, 197, False),
        ("T 37 [16,37,768]", randn(16, 37, 768), p768, 12, 37, False),
        ("t_real 41 of 64 [16,64,768]", randn(16, 64, 768), p768, 12, 41, False),
        ("T 320 [2,320,512] 8 heads", randn(2, 320, 512), params(512), 8, 320, False),
        (f"{D16} [16,17,64] 4 heads", randn(16, 17, 64), params(64), 4, 17, False),
        (f"{D32} [16,17,128] 4 heads", randn(16, 17, 128), params(128), 4, 17, False),
    ]


def _unfused_sublayer(torch, x, params, heads: int, eps: float = 1e-12):
    """The library composition of the same sublayer on the same tensors:
    ``F.layer_norm`` + ``F.linear`` + SDPA + ``F.linear`` + add."""
    F = torch.nn.functional
    lns, lnb, wqkv, bqkv, wo, bo = (a.to(x.dtype) for a in params)
    w_in, w_out = wqkv.t().contiguous(), wo.t().contiguous()
    b, t, width = x.shape

    def call():
        h = F.layer_norm(x, (width,), lns, lnb, eps)
        q, k, v = (a.transpose(1, 2) for a in
                   F.linear(h, w_in, bqkv).view(b, t, 3, heads, -1).unbind(2))
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, -1)
        return F.linear(a, w_out, bo) + x
    return call


def _phase_fused(torch, gen, dev, report: dict) -> None:
    """K6 forward (y and attn) and backward (dqkv) against their plain
    versions in the same dtype (the plain versions keep the kernels'
    rounding points): float32 <= 1e-4 abs, bf16 <= 2e-2 of the reference's
    max |value|; the backward at merges of 1, 2 and the default.  At the
    vision path's shape in bf16: times beside the bound, the unfused library
    composition (forward) and SDPA's backward."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import fused_attention_block as fb

    kf = report.setdefault("fused_attention_fwd", {"max_abs_err": 0.0})
    kb = report.setdefault("fused_bwd_attn", {"max_abs_err": 0.0})
    for name, x32, params, heads, t_real, on_path in _fused_cases(torch, gen, dev):
        b, t, width = x32.shape
        hd = params[4].shape[0]  # wo [H·D, W]
        d = hd // heads
        da32 = torch.randn(b, t, hd, generator=gen, device=dev)
        merges = sorted({1, 2, ac.bd_block(t)})
        for dtype in (torch.float32, torch.bfloat16):
            x, da = x32.to(dtype), da32.to(dtype)
            y, attn = fb.fused_attention_fwd(x, *params, heads, t_real)
            ref_y, ref_attn = fb.fused_attention_reference(x, *params, heads, t_real)
            qkv = fb.ln_qkv(x, *params[:4], 1e-12)[0]
            grads = {m: fb.fused_bwd_attn(qkv, da, heads, t_real, bblk=m) for m in merges}
            ref_d = fb.fused_bwd_attn_reference(qkv, da, heads, t_real)
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            err = max(_held(y, ref_y, dtype, f"K6 fwd y {name}"),
                      _held(attn, ref_attn, dtype, f"K6 fwd attn {name}"))
            err_d = max(_held(g, ref_d, dtype, f"K6 bwd {name} bblk {m}")
                        for m, g in grads.items())
            print(f"[kernels] K6 {name} {tag}: max_abs_err y/attn {err:.3e} dqkv {err_d:.3e} "
                  f"(backward merges {merges})", flush=True)
            kf["max_abs_err"] = max(kf["max_abs_err"], err)
            kb["max_abs_err"] = max(kb["max_abs_err"], err_d)
            if name.startswith(D16) and dtype is torch.bfloat16:
                f_ms = cuda_time_ms(lambda: fb.fused_attention_fwd(x, *params, heads, t_real))
                b_ms = cuda_time_ms(lambda: fb.fused_bwd_attn(qkv, da, heads, t_real))
                print(f"[kernels] K6 {name} bf16: fwd kernels {f_ms:.4f} ms, bwd kernel "
                      f"{b_ms:.4f} ms", flush=True)
            if not (on_path and dtype is torch.bfloat16):
                continue
            ms = cuda_time_ms(lambda: fb.fused_attention_fwd(x, *params, heads, t_real), iters=10)
            plain_ms = cuda_time_ms(lambda: fb.fused_attention_reference(x, *params, heads,
                                                                         t_real), iters=10)
            lib_ms = cuda_time_ms(_unfused_sublayer(torch, x, params, heads))
            pairs = b * heads * t * t_real
            cast = [a.to(dtype) for a in params]
            fwd_b = bound(nbytes(x, *cast, y, attn),
                          2 * b * t * width * 3 * hd + 2 * b * t * hd * width + 4 * d * pairs)
            print(f"[kernels] K6 {name} bf16: fwd kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"unfused library {lib_ms:.4f} ms, bound {fwd_b['bound_ms']:.5f} ms "
                  f"({fwd_b['bound_by']})", flush=True)
            r = time_k6b(torch, ac, fb, name, qkv, da, heads, t_real)
            kf.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **fwd_b)
            kb.update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["sdpa_ms"], **r["bound"])
    _phase_fused_grads(torch, gen, dev)


def time_k6b(torch, ac, fb, name: str, qkv, da, heads: int, t_real: int,
             plain: bool = True) -> dict:
    """K6's backward kernels at one shape, bf16, by CUDA graph replay,
    beside SDPA's backward (graph replay), the plain version (event loop)
    and the bound (qkv and dA read, dqkv written; this run's pairs).
    Prints and returns them."""
    b, t, hd3 = qkv.shape
    d = hd3 // (3 * heads)
    dqkv = fb.fused_bwd_attn(qkv, da, heads, t_real)
    r = {"ms": graph_time_ms(lambda: fb.fused_bwd_attn(qkv, da, heads, t_real)),
         "bound": bound(nbytes(qkv, da, dqkv), 10 * d * b * heads * t * min(t, t_real)),
         "plain_ms": None}
    r["sdpa_ms"] = sdpa_bwd_ms(torch, ac, qkv, heads, False, None, da)
    if plain:
        r["plain_ms"] = cuda_time_ms(lambda: fb.fused_bwd_attn_reference(qkv, da, heads, t_real))
    print(f"[kernels] K6 {name} bf16: bwd kernel {r['ms']:.4f} ms (graph replay), SDPA backward "
          f"{r['sdpa_ms']:.4f} ms (graph replay)"
          + (f", plain {r['plain_ms']:.4f} ms" if plain else "")
          + f", bound {r['bound']['bound_ms']:.5f} ms ({r['bound']['bound_by']})", flush=True)
    return r


def _phase_fused_grads(torch, gen, dev) -> None:
    """The bf16 vision sublayer's gradients through ``fused_attention_sublayer``
    on the card (K6's kernels, the backward products in bf16 with float32
    output) against the same autograd run on CPU copies (the plain
    versions, float32 products): dx and every parameter gradient within
    2e-2 of the reference's max |value|."""
    from multimodal_concept_learning_tpu_torch.ops import fused_attention_block as fb

    name, x32, params, heads, t_real, _ = _fused_cases(torch, gen, dev)[0]
    dy = torch.randn(x32.shape, generator=gen, device=dev).to(torch.bfloat16)
    grads = {}
    for where in (dev, "cpu"):
        leaves = [x32.to(where, torch.bfloat16).requires_grad_(True)]
        leaves += [a.to(where).clone().requires_grad_(True) for a in params]
        with torch.enable_grad():  # phase 3 runs under no_grad
            y = fb.fused_attention_sublayer(leaves[0], *leaves[1:], heads, t_real)
            y.backward(dy.to(where))
        grads[str(where)] = [a.grad.float().cpu() for a in leaves]
    names = ("dx", "d ln_scale", "d ln_bias", "d wqkv", "d bqkv", "d wo", "d bo")
    errs = [_held(g, w, torch.bfloat16, f"K6 sublayer {n} {name}")
            for n, g, w in zip(names, grads[str(dev)], grads["cpu"])]
    print(f"[kernels] K6 sublayer gradients {name} bf16, card vs CPU: max abs err "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)), flush=True)


def _paged_case(torch, gen, dev, hq, hk, d, ps, np_, lens):
    """(q, pool_k, pool_v, page_table, lens): rows own shuffled pages."""
    b = len(lens)
    pages = 1 + b * np_
    perm = torch.randperm(pages - 1, generator=gen, device=dev)[: b * np_] + 1
    pt = perm.reshape(b, np_).to(torch.int32)
    q = torch.randn(b, 1, hq, d, generator=gen, device=dev)
    pk = torch.randn(pages, hk, ps, d, generator=gen, device=dev)
    pv = torch.randn(pages, hk, ps, d, generator=gen, device=dev)
    return q, pk, pv, pt, torch.tensor(lens, dtype=torch.int32, device=dev)


def _paged_cases(torch, gen, dev):
    """(name, q, pool_k, pool_v, page_table, lens, window): gemma3-1b shapes
    (hk 1, group 4, d 256, page 16), 8 ragged rows incl. one of length 0,
    then one case at the kernel's other head dim, group and page size."""
    gemma = _paged_case(torch, gen, dev, 4, 1, 256, 16, 40, [0, 1, 15, 16, 17, 261, 530, 640])
    other = _paged_case(torch, gen, dev, 4, 2, 128, 8, 40, [0, 7, 33, 300])
    return ([(f"gemma3 decode window {w}", *gemma, w) for w in (-1, 512, 20)]
            + [("hk 2, group 2, d 128, page 8, window 97", *other, 97)])


# gemma3-1b's seven decode projections (in, out) at 8 rows, then rows 1 and
# 64 of the widest, and a nano shape of tests/test_int4.py
GEMMA_PROJECTIONS = (("q_proj", 1152, 1024), ("k_proj", 1152, 256), ("v_proj", 1152, 256),
                     ("o_proj", 1024, 1152), ("gate_proj", 1152, 6912),
                     ("up_proj", 1152, 6912), ("down_proj", 6912, 1152))
K5_CASES = ([(f"gemma3 {n} [8,{i}]x[{i},{o}]", 8, i, o) for n, i, o in GEMMA_PROJECTIONS]
            + [("gemma3 up_proj rows 1", 1, 1152, 6912),
               ("gemma3 up_proj rows 64", 64, 1152, 6912),
               ("nano down_proj [16,512]x[512,128]", 16, 512, 128)])
K5_TOL = {"float32": 1e-5, "bfloat16": 8e-3}  # of the reference's max |value|
COLD_BYTES = 96e6  # weights cycled per timing: past the 50 MB L2, as a decode step finds them


def _int4_sets(torch, gen, dev, d_in: int, d_out: int, n: int) -> list:
    """``n`` quantized random weights [d_in, d_out] (normal(0.02))."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    return [i4.quantize_weight_int4(0.02 * torch.randn(d_in, d_out, generator=gen, device=dev))
            for _ in range(n)]


def _cycled(fn, sets: list):
    """A call of ``fn(*sets[i])`` that moves to the next set each time."""
    state = {"i": 0}

    def call():
        args = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*args)
    return call


def _int4pack(torch, packed, scale, high_first: bool = True):
    """(packed weight, scales and zeros) of ``torch._weight_int4pack_mm``
    for the same codes (unsigned code + 8, zero point 0), or None; the
    nibble order of its uint8 input with ``high_first``."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    if not hasattr(torch, "_weight_int4pack_mm"):
        return None
    u = (i4.unpack_int4(packed).to(torch.int32) + 8).t().contiguous()  # [out, in] in 0..15
    even, odd = u[:, ::2], u[:, 1::2]
    pairs = (even << 4) | odd if high_first else (odd << 4) | even
    w = torch._convert_weight_to_int4pack(pairs.to(torch.uint8), 8)
    zeros = torch.zeros_like(scale)
    return w, torch.stack([scale, zeros], dim=-1).contiguous()


def _phase_int4(torch, gen, dev, report: dict) -> None:
    """K5 against its plain version on the same inputs at the decode path's
    shapes, x in float32 and bf16; every gemma3 shape timed cold (weights
    cycled past L2) in bf16; the widest beside its bound, the bf16 product
    of the dequantized weight and ``torch._weight_int4pack_mm``."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    k5 = report.setdefault("int4_matmul", {"max_abs_err": 0.0})
    layer_ms = 0.0  # the seven projections of one gemma3 layer
    for name, rows, d_in, d_out in K5_CASES:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        x = torch.randn(rows, d_in, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            out = i4.int4_matmul(xd, packed, scale)
            ref = i4.int4_matmul_reference(xd.float(), packed, scale)
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            err = (out.float() - ref).abs().max().item()
            limit = K5_TOL[tag] * ref.abs().max().item()
            print(f"[kernels] K5 {name} {tag}: max_abs_err {err:.3e} (limit {limit:.3e})",
                  flush=True)
            if not err <= limit:
                fail(f"K5 {name} {tag}: max abs err {err} > {limit}")
            k5["max_abs_err"] = max(k5["max_abs_err"], err)
        if not name.startswith("gemma3") or "rows" in name:
            continue
        set_bytes = nbytes(packed, scale)
        sets = _int4_sets(torch, gen, dev, d_in, d_out, max(16, int(COLD_BYTES // set_bytes)))
        xb = x.to(torch.bfloat16)
        call = _cycled(lambda p, s: i4.int4_matmul(xb, p, s), sets)
        ms = graph_time_ms(call, iters=len(sets))
        eager_ms = cuda_time_ms(call)
        b = bound(nbytes(packed, scale, xb) + 2 * rows * d_out, 2 * rows * d_in * d_out)
        layer_ms += ms
        print(f"[kernels] K5 {name} bf16 cold: kernel {ms:.5f} ms (eager wrapper loop "
              f"{eager_ms:.4f} ms), bound {b['bound_ms']:.5f} ms ({b['bound_by']})", flush=True)
        if name.split()[1] != "up_proj":
            continue
        plain_ms = cuda_time_ms(lambda: i4.int4_matmul_reference(xb, packed, scale))
        dense = [i4.dequantize_int4(p, s).to(torch.bfloat16) for p, s in sets[:8]]
        dense_ms = graph_time_ms(_cycled(lambda w: xb @ w, [(w,) for w in dense]), iters=8)
        del dense
        pack_ms = None
        if hasattr(torch, "_weight_int4pack_mm"):
            # the nibble order whose product reproduces the plain version's
            want = i4.int4_matmul_reference(xb.float(), sets[0][0], sets[0][1])
            errs = {}
            for high_first in (True, False):
                w4, sz = _int4pack(torch, *sets[0], high_first=high_first)
                lib = torch._weight_int4pack_mm(xb, w4, 64, sz)
                errs[high_first] = (lib.float() - want).abs().max().item()
            order = min(errs, key=errs.get)
            lib_err = errs[order]
            packs = [_int4pack(torch, p, s, high_first=order) for p, s in sets[:16]]
            pack_ms = graph_time_ms(_cycled(lambda w, z: torch._weight_int4pack_mm(xb, w, 64, z),
                                            packs), iters=16)
            print(f"[kernels] K5 library torch._weight_int4pack_mm: {pack_ms:.5f} ms cold "
                  f"(max abs diff from the plain version {lib_err:.3e}, nibble order "
                  f"{'high' if order else 'low'} first)", flush=True)
        print(f"[kernels] K5 {name} bf16: plain version {plain_ms:.4f} ms; bf16 matmul of "
              f"the dequantized weight (what bf16 weights pay) {dense_ms:.5f} ms cold", flush=True)
        k5.update(ms=ms, plain_ms=plain_ms, library_ms=pack_ms, **b)
    print(f"[kernels] K5 over one decode step of gemma3-1b (7 projections x 26 layers, cold): "
          f"{26 * layer_ms:.4f} ms", flush=True)


INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
# every shape the A/B entry point gives the variants (each its own split-K
# layout: v3_splits), at its batch 8 and at rows 1 and 16
V3_CASES = [(f"gemma3 {n} rows {r}", r, i, o) for n, i, o in GEMMA_PROJECTIONS
            for r in (1, 8, 16)]


def _phase_int4_v3(torch, gen, dev, report: dict) -> None:
    """K5v3a and K5v3b against their plain versions on the same inputs
    (gemma3-1b's seven projections, rows 1, 8 and 16, x in float32 and bf16;
    K5's limits, 1e-5 and 8e-3 of the reference's max |value|); then each timed
    cold at up_proj [8,1152]x[1152,6912] (weights cycled past the L2, CUDA
    graph replay) beside K5's bound, K5 itself, and for v3a
    ``torch._weight_int4pack_mm``.  v3b has no library call: its int8
    activations make it another function than every library product."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    variants = {"int4_matmul_v3a": (i4.v3a_matmul, i4.v3a_matmul_reference, "K5v3a"),
                "int4_matmul_v3b": (i4.v3b_matmul, i4.v3b_matmul_reference, "K5v3b")}
    for key in variants:
        report.setdefault(key, {"max_abs_err": 0.0})
    for name, rows, d_in, d_out in V3_CASES:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        x = torch.randn(rows, d_in, generator=gen, device=dev)
        for key, (fn, ref_fn, label) in variants.items():
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                out = fn(xd, packed, scale)
                ref = ref_fn(xd.float(), packed, scale)
                torch.cuda.synchronize()
                tag = str(dtype).replace("torch.", "")
                err = (out.float() - ref).abs().max().item()
                limit = K5_TOL[tag] * ref.abs().max().item()
                print(f"[kernels] {label} {name} {tag}: max_abs_err {err:.3e} (limit "
                      f"{limit:.3e})", flush=True)
                if not err <= limit:
                    fail(f"{label} {name} {tag}: max abs err {err} > {limit}")
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
    rows, d_in, d_out = 8, 1152, 6912  # up_proj at batch 8, the A/B script's shape
    (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
    sets = _int4_sets(torch, gen, dev, d_in, d_out,
                      max(16, int(COLD_BYTES // nbytes(packed, scale))))
    xb = torch.randn(rows, d_in, generator=gen, device=dev).to(torch.bfloat16)
    moved = nbytes(packed, scale, xb) + 2 * rows * d_out
    times = {}
    order = (("int4_matmul", i4.int4_matmul), ("int4_matmul_v3a", i4.v3a_matmul),
             ("int4_matmul_v3b", i4.v3b_matmul))
    for rnd in range(2):  # K5, v3a, v3b, then the reverse (order cancels drift)
        for key, fn in (order if rnd == 0 else order[::-1]):
            times.setdefault(key, []).append(
                graph_time_ms(_cycled(lambda p, s, fn=fn: fn(xb, p, s), sets), iters=len(sets)))
    pack_ms = None
    if hasattr(torch, "_weight_int4pack_mm"):
        packs = [_int4pack(torch, p, s) for p, s in sets[:16]]
        pack_ms = graph_time_ms(_cycled(lambda w, z: torch._weight_int4pack_mm(xb, w, 64, z),
                                        packs), iters=16)
    for key, (fn, ref_fn, label) in variants.items():
        ms = min(times[key])
        plain_ms = cuda_time_ms(lambda: ref_fn(xb, packed, scale))
        b = bound(moved, 2 * rows * d_in * d_out,
                  INT8_OPS_PER_S if key.endswith("v3b") else BF16_FLOPS_PER_S)
        lib = pack_ms if key.endswith("v3a") else None
        report[key].update(ms=ms, plain_ms=plain_ms, library_ms=lib, **b)
        print(f"[kernels] {label} up_proj [8,1152]x[1152,6912] bf16 cold: kernel "
              + " / ".join(f"{t:.5f}" for t in times[key]) + f" ms (K5 "
              + " / ".join(f"{t:.5f}" for t in times["int4_matmul"]) + f" ms), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}), library "
              + (f"torch._weight_int4pack_mm {lib:.5f} ms" if lib is not None else
                 "none (int8 activations: no library call computes this function)"),
              flush=True)


K4_PPB = (1, 3, 8)


def _phase_paged_mp(torch, gen, dev, report: dict) -> None:
    """K4 against its plain version (the same blocks) on K3's cases plus
    64-token pages at 4 kv heads and ~1k context, pages_per_block 1, 3 and
    8 (clamped on the card), fp32 and bf16; the length-0 row exactly 0.
    Then K4 beside K3 at 4 kv heads (group 4, d 256), batch 8, ~1k context,
    pages of 16 and 64, bf16, by CUDA graph."""
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as mp

    k4 = report.setdefault("paged_decode_attention_mp", {"max_abs_err": 0.0})
    long_ctx = [0, 1000, 1024, 700, 1, 63, 64, 65]
    cases = _paged_cases(torch, gen, dev) + [
        ("hk 4, group 4, d 256, page 64, ~1k context",
         *_paged_case(torch, gen, dev, 16, 4, 256, 64, 17, long_ctx), -1)]
    for name, q, pool_k, pool_v, pt, lens, w in cases:
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, pool_k, pool_v))
            args = (qd, kd, vd, pt, lens)
            tag = str(dtype).replace("torch.", "")
            for ppb in K4_PPB:
                out = mp.paged_decode_attention_mp(*args, scale=1 / 16, window=w,
                                                   pages_per_block=ppb)
                ref = mp.paged_decode_attention_mp_reference(
                    qd.float(), kd.float(), vd.float(), pt, lens, scale=1 / 16, window=w,
                    pages_per_block=ppb)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                zero_row = out[0].abs().max().item()
                sched = mp.mp_schedule(kd.shape[2], kd.shape[3], dtype,
                                       qd.shape[2] // kd.shape[1], ppb, pt.shape[1])
                print(f"[kernels] K4 {name} {tag} pages_per_block {ppb} (card: {sched[1]} "
                      f"segments of {sched[0]} tokens): max_abs_err {err:.3e} len-0 row "
                      f"{zero_row:.1e}", flush=True)
                if not (err <= TOL[tag] and zero_row == 0.0):
                    fail(f"K4 {name} {tag} ppb {ppb}: max abs err {err}, len-0 row {zero_row}")
                k4["max_abs_err"] = max(k4["max_abs_err"], err)
            if w == 512 and dtype is torch.bfloat16:  # the main path's shape, as K3's row
                ms = graph_time_ms(lambda: mp.paged_decode_attention_mp(*args, scale=1 / 16,
                                                                        window=w))
                plain_ms = cuda_time_ms(lambda: mp.paged_decode_attention_mp_reference(
                    *args, scale=1 / 16, window=w))
                tokens = int(lens.clamp(max=w).sum())
                hk, d = kd.shape[1], kd.shape[-1]
                k4.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                          **bound(2 * nbytes(qd) + nbytes(pt, lens)
                                  + 2 * tokens * hk * d * kd.element_size(),
                                  4 * d * qd.shape[2] * tokens))
                k3_ms = graph_time_ms(lambda: pk.paged_decode_attention(*args, scale=1 / 16,
                                                                       window=w))
                print(f"[kernels] K4 {name} bf16: kernel {ms:.5f} ms (K3 {k3_ms:.5f} ms), "
                      f"plain {plain_ms:.4f} ms, bound {k4['bound_ms']:.5f} ms", flush=True)
    for ps in (16, 64):
        np_ = -(-1024 // ps)
        q, pool_k, pool_v, pt, lens = _paged_case(torch, gen, dev, 16, 4, 256, ps, np_,
                                                  [1024, 1017, 1000, 990, 960, 1024, 1003, 998])
        args = tuple(t.to(torch.bfloat16) for t in (q, pool_k, pool_v)) + (pt, lens)
        k3_ms = graph_time_ms(lambda: pk.paged_decode_attention(*args, scale=1 / 16))
        k4_ms = graph_time_ms(lambda: mp.paged_decode_attention_mp(*args, scale=1 / 16))
        k3_eager = cuda_time_ms(lambda: pk.paged_decode_attention(*args, scale=1 / 16))
        k4_eager = cuda_time_ms(lambda: mp.paged_decode_attention_mp(*args, scale=1 / 16))
        tokens = int(lens.sum())
        b = bound(2 * nbytes(args[0]) + nbytes(pt, lens) + 2 * tokens * 4 * 256 * 2,
                  4 * 256 * 16 * tokens)
        sched = mp.mp_schedule(ps, 256, torch.bfloat16, 4, 8, np_)
        print(f"[kernels] K3 vs K4, batch 8, hk 4, group 4, d 256, ~1k context, page {ps}, "
              f"bf16: K3 {k3_ms:.5f} ms, K4 {k4_ms:.5f} ms (pages_per_block 8 -> {sched[1]} "
              f"of {sched[0]} tokens); eager wrapper loops K3 {k3_eager:.4f} ms, K4 "
              f"{k4_eager:.4f} ms; bound {b['bound_ms']:.5f} ms ({b['bound_by']})", flush=True)


def time_k1_fwd(torch, fa, name: str, q, k, v, kw) -> dict:
    """K1 forward at one path shape, bf16: the kernel and one SDPA call on
    the same inputs by CUDA graph replay, the plain version by the event
    loop, the bound (this run's attendable pairs).  Prints and returns them."""
    mask = {key: kw[key] for key in ("kv_lens", "causal", "window") if key in kw}
    pairs = _k1_pairs(torch, fa, q, k, mask)
    out = fa.flash_attention(q, k, v, **kw)
    r = dict(ms=graph_time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
             plain_ms=cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw)),
             library_ms=graph_time_ms(_sdpa_k1(torch, fa, q, k, v, kw)),
             **bound(nbytes(q, k, v, out, kw.get("kv_lens"), kw.get("bias")),
                     4 * q.shape[-1] * pairs))
    print(f"[kernels] K1 fwd {name} bf16: kernel {r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} "
          f"ms (graph replay), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
          f"({r['bound_by']})", flush=True)
    return r


def time_forwards(root: str) -> None:
    """K1 and K2 forwards in bf16 at their main-path shapes, from the port
    package of the checkout at ``root`` (``sys.path`` puts it first): each
    kernel and its SDPA call by CUDA graph replay.  Run it once a process on
    two checkouts in turns (parent, change, change, parent) to compare them
    on one card."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa

    print(f"[ab] kernels of {os.path.dirname(os.path.dirname(fa.__file__))}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for name, q, k, v, kw in _flash_cases(torch, gen, dev):
            if name.startswith(K1_TIMED):
                time_k1_fwd(torch, fa, name, *(x.to(torch.bfloat16) for x in (q, k, v)), kw)
        for name, qkv32, heads, t_real, causal, kvm, on_path in _core_cases(torch, gen, dev):
            if not on_path:
                continue
            qkv = qkv32.to(torch.bfloat16)
            ms = graph_time_ms(lambda: ac.attention_core_fwd(qkv, heads, t_real, causal, kvm,
                                                             with_lse=True))
            lib_ms = graph_time_ms(_sdpa_core(torch, ac, qkv, heads, causal, kvm))
            print(f"[kernels] K2 fwd {name} bf16: kernel {ms:.4f} ms, SDPA {lib_ms:.4f} ms "
                  "(graph replay)", flush=True)


def time_variants(root: str) -> None:
    """K2-bd's forward and backward at both CLIP shapes (beside K2: their
    bf16 backwards are the same kernel pair, over 16-row slots of one
    sample), K6's backward at the vision shape and K1's backward at the LM
    training shape, bf16, each by CUDA graph replay beside SDPA, from the
    port package of the checkout at ``root`` (``sys.path`` puts it first).
    Run it once a process on two checkouts in turns (parent, change,
    change, parent) to compare them on one card; a checkout whose bf16 K2
    backward still takes the forward's out and lse runs its own script
    (``cd ROOT && python3 chip_smoke.py --time-variants .``)."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops import fused_attention_block as fb

    print(f"[ab] kernels of {os.path.dirname(os.path.dirname(ac.__file__))}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    with torch.no_grad():
        for name, qkv32, heads, t_real, causal, kvm, on_path in _core_bd_cases(torch, gen, dev):
            if on_path:
                b, t, hd3 = qkv32.shape
                da = torch.randn(b, t, hd3 // 3, generator=gen, device=dev).to(bf16)
                time_bd(torch, ac, name, qkv32.to(bf16), da, (heads, t_real, causal, kvm),
                        plain=False)
        name, x32, params, heads, t_real, _ = _fused_cases(torch, gen, dev)[0]
        qkv = fb.ln_qkv(x32.to(bf16), *params[:4], 1e-12)[0]
        da = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, generator=gen,
                         device=dev).to(bf16)
        time_k6b(torch, ac, fb, name, qkv, da, heads, t_real, plain=False)
        for name, q, k, v, kw, _ in _flash_bwd_cases(torch, gen, dev):
            if name.startswith("lm ["):
                do = torch.randn(q.shape, generator=gen, device=dev)
                time_k1_bwd(torch, fa, name, *(x.to(bf16) for x in (q, k, v, do)), kw)


def phase_kernels(report: dict) -> None:
    import torch

    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = report.setdefault("flash_attention_fwd", {"max_abs_err": 0.0})
    k3 = report.setdefault("paged_decode_attention", {"max_abs_err": 0.0})
    with torch.no_grad():
        for name, q, k, v, kw in _flash_cases(torch, gen, dev):
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                out = fa.flash_attention(qd, kd, vd, **kw)
                # the plain version in float32 on the same (dtype-rounded) inputs
                ref = fa.flash_attention_reference(qd.float(), kd.float(), vd.float(), **kw)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tag = str(dtype).replace("torch.", "")
                print(f"[kernels] K1 {name} {tag}: max_abs_err {err:.3e}", flush=True)
                if not err <= TOL[tag]:
                    fail(f"K1 {name} {tag}: max abs err {err} > {TOL[tag]}")
                k1["max_abs_err"] = max(k1["max_abs_err"], err)
                if not (name.startswith(K1_TIMED) and dtype is torch.bfloat16):
                    continue
                timing = time_k1_fwd(torch, fa, name, qd, kd, vd, kw)
                if name.startswith("lm ["):  # the JSON line's numbers: LM prefill
                    k1.update(timing)
        for name, q, pool_k, pool_v, pt, lens, w in _paged_cases(torch, gen, dev):
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, pool_k, pool_v))
                args = (qd, kd, vd, pt, lens)
                out = pk.paged_decode_attention(*args, scale=1 / 16, window=w)
                ref = pk.paged_decode_attention_reference(
                    qd.float(), kd.float(), vd.float(), pt, lens, scale=1 / 16, window=w)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                zero_row = out[0].abs().max().item()
                ms = cuda_time_ms(lambda: pk.paged_decode_attention(*args, scale=1 / 16, window=w))
                plain_ms = cuda_time_ms(
                    lambda: pk.paged_decode_attention_reference(*args, scale=1 / 16, window=w))
                tag = str(dtype).replace("torch.", "")
                print(f"[kernels] K3 {name} {tag}: max_abs_err {err:.3e} len-0 row "
                      f"{zero_row:.1e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
                if not (err <= TOL[tag] and zero_row == 0.0):
                    fail(f"K3 {name} {tag}: max abs err {err}, len-0 row max {zero_row}")
                k3["max_abs_err"] = max(k3["max_abs_err"], err)
                if w == 512 and dtype is torch.bfloat16:
                    # the tokens each row reads: its length, cut to the window
                    tokens = int(lens.clamp(max=w).sum()) if w > 0 else int(lens.sum())
                    hk, d = kd.shape[1], kd.shape[-1]
                    k3.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                              **bound(2 * nbytes(qd) + nbytes(pt, lens)
                                      + 2 * tokens * hk * d * kd.element_size(),
                                      4 * d * qd.shape[2] * tokens))
        _phase_flash_bwd(torch, fa, gen, dev, report)
        _phase_core(torch, gen, dev, report)
        _phase_core_bd(torch, gen, dev, report)
        _phase_fused(torch, gen, dev, report)
        _phase_past_cap(torch, gen, dev)
        _phase_text_block_grads(torch, gen, dev)
        _phase_lm_layer_grads(torch, gen, dev)
        _phase_int4(torch, gen, dev, report)
        _phase_int4_v3(torch, gen, dev, report)
        _phase_paged_mp(torch, gen, dev, report)


def _rgb(name: str) -> list:
    """[r, g, b] of a color class name such as "r255g128b0"."""
    return [int(x) for x in re.findall(r"\d+", name)]


def _circle(rgb, size: int = 224) -> np.ndarray:
    """[3, size, size] float image in [0, 1]: a colored circle on white."""
    yy, xx = np.mgrid[:size, :size]
    inside = (xx - size // 2) ** 2 + (yy - size // 2) ** 2 <= (size // 3) ** 2
    img = np.ones((3, size, size), np.float32)
    img[:, inside] = np.asarray(rgb, np.float32)[:, None] / 255.0
    return img


def phase_parity() -> None:
    """Full widths, 2 ViT + 2 LM layers (one sliding, one global), float32:
    greedy paged_generate on the card == on the CPU plain path."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.models.mllm import paged_generate
    from multimodal_concept_learning_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
        paged_decode_attention,
    )

    for window in (512, 64):
        cfg, sd, inputs = _parity_model(window, SEED)
        before = (flash_attention.launches, paged_decode_attention.launches)
        on_card = paged_generate(build_mllm(cfg, sd, "cuda"), *inputs, max_new_tokens=8,
                                 page_size=16).cpu().numpy()
        launched = (flash_attention.launches - before[0],
                    paged_decode_attention.launches - before[1])
        on_cpu = paged_generate(build_mllm(cfg, sd, "cpu"), *inputs, max_new_tokens=8,
                                page_size=16).numpy()
        same = bool((on_card == on_cpu).all())
        print(f"[parity] window {window}: cuda tokens == cpu tokens: {same} "
              f"(kernel launches K1 {launched[0]}, K3 {launched[1]}); cuda {on_card.tolist()}",
              flush=True)
        if not same or min(launched) == 0:
            fail(f"parity at window {window}: cpu {on_cpu.tolist()}, launches {launched}")


def phase_quant_parity() -> None:
    """Phase 10: phase 4's model (full widths, 2 + 2 layers, float32,
    window 512) quantized by the serving loader's function, on the card and
    on the CPU from the same quantized weights: greedy ``paged_generate``
    gives the same tokens with int4 LM weights under MCL_PAGED_KERNEL=2 (K5
    and K4 launched, K3 not) and with int8 LM + vision weights (K3)."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.models.mllm import paged_generate
    from multimodal_concept_learning_tpu_torch.serve.loader import _quantize_for_serving

    cfg, sd, inputs = _parity_model(512, SEED + 1)
    counters = _kernel_counters()
    for quant, env in (({"int4": True}, "2"), ({"int8": True, "int8_vision": True}, None)):
        qsd, qcfg = _quantize_for_serving(sd, cfg, quant.get("int8", False),
                                          quant.get("int8_vision", False), False,
                                          int4=quant.get("int4", False))
        if env:
            os.environ["MCL_PAGED_KERNEL"] = env
        try:
            before = {n: fn.launches for n, fn in counters.items()}
            on_card = paged_generate(build_mllm(qcfg, qsd, "cuda"), *inputs, max_new_tokens=8,
                                     page_size=16).cpu().numpy()
            launched = {n: fn.launches - before[n] for n, fn in counters.items()}
            on_cpu = paged_generate(build_mllm(qcfg, qsd, "cpu"), *inputs, max_new_tokens=8,
                                    page_size=16).numpy()
        finally:
            os.environ.pop("MCL_PAGED_KERNEL", None)
        same = bool((on_card == on_cpu).all())
        print(f"[quant-parity] {quant} (MCL_PAGED_KERNEL={env}): cuda tokens == cpu tokens: "
              f"{same}; kernel launches {launched}; cuda {on_card.tolist()}", flush=True)
        if not same:
            fail(f"quantized parity {quant}: cpu {on_cpu.tolist()}")
        k3, k4, k5 = (launched[n] for n in ("paged_decode_attention", "paged_decode_attention_mp",
                                            "int4_matmul"))
        ok = (k5 > 0 and k4 > 0 and k3 == 0) if env else (k5 == 0 and k3 > 0)
        if not ok:
            fail(f"quantized parity {quant}: launches {launched}")


def _parity_model(window: int, data_seed: int):
    """The parity phases' float32 MLLM (full widths, 2 ViT + 2 LM layers,
    the LM's first layer sliding, weights from SEED) and a ragged prompt
    batch drawn from ``data_seed``: (cfg, state dict, [images, ids, mask])."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig

    base = MLLMConfig.create(vocab_size=1148, dtype=torch.float32)
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
        lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=window,
                               sliding_window_pattern=2))
    sd = init_random_weights_(MLLM(cfg), torch.Generator().manual_seed(SEED)).state_dict()
    rng = np.random.default_rng(data_seed)
    lens = [64, 40, 17, 5]
    t = 197 + max(lens)
    ids = rng.integers(4, 1148, size=(len(lens), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        mask[i, : 197 + n] = 1
    ids[mask == 0] = 0
    images = np.stack([_circle(c) for c in ([255, 0, 0], [0, 128, 255], [40, 200, 40],
                                            [250, 250, 0])])
    return cfg, sd, [torch.from_numpy(x) for x in (images, ids, mask)]


def _dense_hidden(model, inputs) -> list:
    """Hidden states of ``prefill`` (the prompt's valid positions), one
    ``decode_step`` and one 3-token ``decode_chunk`` over dense caches, for
    fixed tokens, as float32 CPU tensors."""
    import torch

    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache

    dev = next(model.parameters()).device
    images, ids, mask = (x.to(dev) for x in inputs)
    lm = model.language_model
    b, t = ids.shape
    rows = torch.arange(b, device=dev)
    caches = init_kv_cache(lm.cfg, b, t + 4, dev)
    seq = mask.sum(dim=1).to(torch.int32)
    with torch.inference_mode():
        h0 = model.prefill(images, ids, mask, caches, kv_lens=seq)
        cache_mask = torch.nn.functional.pad(mask.to(torch.int32), (0, 4))
        cache_mask[rows, seq.long()] = 1
        h1 = lm.decode_step(lm.embed(rows[:, None] + 5), caches, seq, cache_mask)
        chunk = rows[:, None] + torch.arange(3, device=dev)[None] + 7
        h2 = lm.decode_chunk(lm.embed(chunk), caches, seq + 1, cache_mask)
    return [h.float().cpu() for h in (h0[mask.bool()], h1, h2)]


def phase_generate_parity() -> None:
    """Phase 14: ``greedy_generate`` over dense KV caches, float32, window
    64 on the sliding layer (below every row's length but the shortest, so
    decode attends through the float32 bias of each row's own position):
    tokens on the card == the CPU plain path's == ``paged_generate``'s on
    the card, with float and with int4 LM weights.  Launches: K1 2 + 2 a
    prefill and 2 a decode step; K5 7 x 2 a decode step with int4, else 0;
    K3 and K4 0."""
    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate, paged_generate
    from multimodal_concept_learning_tpu_torch.serve.loader import _quantize_for_serving

    cfg, sd, inputs = _parity_model(64, SEED + 2)
    counters = _kernel_counters()
    new = 8
    for int4 in (False, True):
        qsd, qcfg = (_quantize_for_serving(sd, cfg, False, False, False, int4=True) if int4
                     else (sd, cfg))
        model = build_mllm(qcfg, qsd, "cuda")
        for fn in counters.values():
            fn.launches = 0
        dense = greedy_generate(model, *inputs, max_new_tokens=new).cpu().numpy()
        launched = {n: fn.launches for n, fn in counters.items()}
        paged = paged_generate(model, *inputs, max_new_tokens=new, page_size=16).cpu().numpy()
        del model
        on_cpu = greedy_generate(build_mllm(qcfg, qsd, "cpu"), *inputs,
                                 max_new_tokens=new).numpy()
        expected = {"flash_attention_fwd": 4 + 2 * (new - 1), "paged_decode_attention": 0,
                    "paged_decode_attention_mp": 0,
                    "int4_matmul": 7 * 2 * (new - 1) if int4 else 0}
        same_cpu, same_paged = bool((dense == on_cpu).all()), bool((dense == paged).all())
        print(f"[generate-parity] {'int4' if int4 else 'float'}: dense cuda tokens == cpu "
              f"{same_cpu}, == paged cuda {same_paged}; launches {launched} (expected "
              f"{expected}); cuda {dense.tolist()}", flush=True)
        if not (same_cpu and same_paged):
            fail(f"generation parity int4={int4}: cpu {on_cpu.tolist()}, paged {paged.tolist()}")
        if launched != expected:
            fail(f"generation parity int4={int4}: launches {launched} != {expected}")
    # the random weights repeat one token a row: hold the hidden states too
    got = _dense_hidden(build_mllm(cfg, sd, "cuda"), inputs)
    want = _dense_hidden(build_mllm(cfg, sd, "cpu"), inputs)
    errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
    print(f"[generate-parity] hidden states cuda vs cpu, max abs error / max |cpu| (prefill, "
          f"decode_step, decode_chunk of 3): {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e}",
          flush=True)
    if not max(errs) <= 1e-4:
        fail(f"dense-cache hidden states cuda vs cpu: {errs}")


TRAINING_CONFIG = {  # experiments/multimodal/color/12_colors_3k.yaml (served fields)
    "prompt_template": "Is the color of the circle {class_name}?",
    "dataset_name": "color_multimodal", "vision_model_name": "vit-b-16",
    "language_model_name": "google/gemma-3-1b-it", "vision_path": None,
    "num_vision_tokens": 197, "num_labels": 12,
    "trainable_params_setting": "language_embed_only", "torch_dtype": "bfloat16",
    "seed": 42, "image_size": 224, "train_transforms": ["ToTensor"],
    "val_transforms": ["ToTensor"], "run_name": "mllm_12_colors_3k_ood",
}
MAPPING = os.path.join(REPO, "experiments/multimodal/color/12_colors_3k_labels_mapping.json")


def _write_results_dir(root: str) -> None:
    """A seeded random-init results dir of the full 12_colors_3k model."""
    import shutil

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import (
        init_random_weights_,
        save_results_dir,
    )
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        build_tokenizer,
        model_config,
        training_config,
    )

    mapping = os.path.join(root, "labels_mapping.json")
    shutil.copy(MAPPING, mapping)
    cfg_dict = dict(TRAINING_CONFIG, labels_mapping_path=os.path.abspath(mapping),
                    results_dir=os.path.abspath(root))
    config = training_config(cfg_dict)
    tokenizer, _ = build_tokenizer(config)
    cfg = model_config(config, len(tokenizer), torch.float32)
    with torch.device("cuda"):
        model = MLLM(cfg)
    init_random_weights_(model, torch.Generator(device="cuda").manual_seed(SEED))
    save_results_dir(root, model, tokenizer, cfg_dict)
    n = sum(p.numel() for p in model.parameters())
    print(f"[slice] random-init results dir: vocab {len(tokenizer)}, {n} parameters", flush=True)


def _kernel_counters() -> dict:
    """The serving path's kernel wrappers by report name."""
    from multimodal_concept_learning_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_concept_learning_tpu_torch.ops.int4 import int4_matmul
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
        paged_decode_attention,
    )
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_mp_kernel import (
        paged_decode_attention_mp,
    )

    return {"flash_attention_fwd": flash_attention,
            "paged_decode_attention": paged_decode_attention,
            "paged_decode_attention_mp": paged_decode_attention_mp,
            "int4_matmul": int4_matmul}


def _serve(root: str, tag: str, **quant) -> dict:
    """Serve the results dir ``root`` through the port's paged server
    (``make_server``, batch 8, 8 answer tokens, pages of 16): a warm-up
    request, then 16 requests from 16 threads; /healthz and /metrics over
    HTTP.  Returns the run's numbers and the serving path's launch counts
    (counted from 0 just before the first request)."""
    import http.client
    import threading

    import torch

    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    httpd, batcher = make_server(root, port=0, paged=True, batch_size=8, max_new_tokens=8,
                                 page_size=16, **quant)
    print(f"[{tag}] served in {time.perf_counter() - t0:.1f} s ({quant or 'float weights'})",
          flush=True)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    with open(MAPPING) as f:
        mapping = list(json.load(f).items())  # "r255g128b0" -> "<ood 1>"
    requests = []
    for i in range(16):
        key, name = mapping[i % len(mapping)]
        requests.append((_circle(_rgb(key)), f"Is the color of the circle {name}?"))
    counters = _kernel_counters()
    try:
        for fn in counters.values():
            fn.launches = 0
        batcher.engine.decode_steps = 0
        batcher.submit(*requests[0])  # first request: cuBLAS/allocator warm-up
        results, tokens, latency = [None] * 16, [0] * 16, [0.0] * 16

        def run(i):
            def count(_tok, i=i):
                tokens[i] += 1
            t = time.perf_counter()
            results[i] = batcher.submit(*requests[i], on_token=count)
            latency[i] = time.perf_counter() - t

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        steps = batcher.engine.decode_steps
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        conn.close()
        finite = all(bool(torch.isfinite(p[kv]).all())
                     for p in batcher.engine.pools for kv in ("k", "v"))
    finally:
        httpd.shutdown()
        batcher.shutdown()
        server.join(timeout=30)
        httpd.server_close()
    run = {"requests_per_s": 16 / wall, "tokens_per_s": sum(tokens) / wall,
           "p50_ms": 1e3 * float(np.median(latency)), "launches": launches,
           "decode_steps": steps}
    print(f"[{tag}] 16 requests from 16 threads in {wall:.3f} s: {run['requests_per_s']:.3f} "
          f"requests/s, {run['tokens_per_s']:.1f} generated tokens/s ({sum(tokens)} tokens); "
          f"p50 latency {run['p50_ms']:.1f} ms, max {1e3 * max(latency):.1f} ms", flush=True)
    print(f"[{tag}] healthz {health}; metrics {metrics}", flush=True)
    print(f"[{tag}] answers {results[:4]} ...; kernel launches {launches} over {steps} decode "
          f"steps", flush=True)
    if not all(isinstance(r, str) for r in results):
        fail(f"{tag}: not every request was answered")
    if not (health.get("ok") and metrics.get("completed") == 17 and finite):
        fail(f"{tag} server state: healthz {health}, metrics {metrics}, finite pools {finite}")
    return run


def phase_slice(report: dict, root: str) -> dict:
    """Phase 5: the float model served; K1 and K3 launched, K4 and K5 not."""
    t0 = time.perf_counter()
    _write_results_dir(root)
    print(f"[slice] results dir written in {time.perf_counter() - t0:.1f} s", flush=True)
    run = _serve(root, "slice")
    launches = run["launches"]
    for name in ("flash_attention_fwd", "paged_decode_attention"):
        if launches[name] == 0:
            fail(f"{name} was never launched by the serving path")
        report[name]["launches"] = launches[name]
    if launches["paged_decode_attention_mp"] or launches["int4_matmul"]:
        fail(f"the float serving path launched K4 or K5: {launches}")
    return run


LM_PROJECTION_LAUNCHES = 7 * 26  # K5 launches per decode step: 7 projections x 26 layers


def phase_quant_slice(report: dict, root: str, float_run: dict) -> None:
    """Phase 11: the same results dir served with int4 LM weights under
    MCL_PAGED_KERNEL=2 (K5 in every decode projection, K4 in every decode
    attention, no K3), then with int8 LM and vision weights (K3 again);
    requests/s, tokens/s and p50 latency beside the float run's."""
    os.environ["MCL_PAGED_KERNEL"] = "2"
    try:
        int4 = _serve(root, "int4-slice", int4=True)
    finally:
        del os.environ["MCL_PAGED_KERNEL"]
    launches, steps = int4["launches"], int4["decode_steps"]
    if launches["int4_matmul"] != LM_PROJECTION_LAUNCHES * steps or steps == 0:
        fail(f"int4 slice: K5 launches {launches['int4_matmul']} != {LM_PROJECTION_LAUNCHES} "
             f"x {steps} decode steps")
    if launches["paged_decode_attention_mp"] == 0 or launches["paged_decode_attention"]:
        fail(f"int4 slice under MCL_PAGED_KERNEL=2: K4 {launches['paged_decode_attention_mp']} "
             f"(> 0), K3 {launches['paged_decode_attention']} (0)")
    for name in ("int4_matmul", "paged_decode_attention_mp"):
        report[name]["launches"] = launches[name]
    int8 = _serve(root, "int8-slice", int8=True, int8_vision=True)
    if int8["launches"]["int4_matmul"] or int8["launches"]["paged_decode_attention"] == 0:
        fail(f"int8 slice launches {int8['launches']}")
    for tag, run in (("float", float_run), ("int4 + K4", int4), ("int8 + int8 vision", int8)):
        print(f"[quant-slice] {tag}: {run['requests_per_s']:.3f} requests/s, "
              f"{run['tokens_per_s']:.1f} tokens/s, p50 {run['p50_ms']:.1f} ms", flush=True)


ANSWER_ARGS = ["--split", "train", "--batch_size", "8", "--limit", "16", "--max_new_tokens", "8",
               "--device", "cuda"]


def phase_answer_slice(root: str) -> None:
    """Phase 15: the port's answer CLI on phase 7's results dir and data
    (the full 12_colors_3k model trained one epoch, bf16 compute): float,
    ``--int4`` and ``--int8 --int8_vision``; 16 train samples, 8 tokens,
    batch 8.  Checks the CLI's lines, the 16 JSONL rows and exact launch
    counts (counted from 0 just before each run): K1 38 a prefill (12 ViT +
    26 LM layers) and 26 a decode step; K5 7 x 26 a decode step under
    ``--int4`` (prefill rows take the dequantized product), else 0."""
    import contextlib
    import io

    import torch

    from multimodal_concept_learning_tpu_torch.train.generate_answers import main as answers_main

    results = os.path.join(root, "results")
    counters = _kernel_counters()
    new, n = 8, 16
    runs = {}
    for tag, extra in (("float", []), ("int4", ["--int4"]), ("int8", ["--int8", "--int8_vision"])):
        out_path = os.path.join(root, f"generations_{tag}.jsonl")
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = answers_main(["--results_dir", results, "--output", out_path, *ANSWER_ARGS,
                                *extra])
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        text = buf.getvalue()
        for line in text.splitlines():
            print(f"[answers-{tag}] {line}", flush=True)
        with open(out_path) as f:
            rows = [json.loads(line) for line in f]
        keys = {"prompt", "generated", "target", "yes_no_match", "exact_match"}
        batches = res["batches"]
        expected = {"flash_attention_fwd": batches * (38 + 26 * (new - 1)),
                    "paged_decode_attention": 0, "paged_decode_attention_mp": 0,
                    "int4_matmul": batches * LM_PROJECTION_LAUNCHES * (new - 1)
                    if tag == "int4" else 0}
        lines_ok = (f"Generated answers for {n} samples (train split)" in text
                    and re.search(r"^Yes/No Accuracy: \d+\.\d\d%$", text, re.M)
                    and re.search(r"^Exact-Match Accuracy: \d+\.\d\d%$", text, re.M)
                    and f"Wrote {out_path}" in text)
        rows_ok = (len(rows) == n and all(set(r) == keys and r["target"] for r in rows))
        samples_s, tokens_s = n / res["seconds"], n * new / res["seconds"]
        runs[tag] = (samples_s, tokens_s, res)
        print(f"[answers-{tag}] {n} samples x {new} tokens in {batches} batches: generation "
              f"{res['seconds']:.3f} s = {samples_s:.3f} samples/s, {tokens_s:.1f} tokens/s; "
              f"whole CLI {wall:.1f} s; launches {launches} (expected {expected}); rows "
              f"{rows[:2]} ...", flush=True)
        if not (lines_ok and rows_ok and res["n"] == n and batches == 2):
            fail(f"answer slice {tag}: lines {lines_ok}, rows {rows_ok}, n {res['n']}, "
                 f"batches {batches}")
        if launches != expected:
            fail(f"answer slice {tag}: launches {launches} != {expected}")
    print("[answers] " + "; ".join(
        f"{tag}: {sps:.3f} samples/s, {tps:.1f} tokens/s, yes/no {res['yes_no_acc']:.2f}%, "
        f"exact {res['exact_acc']:.2f}%" for tag, (sps, tps, res) in runs.items()), flush=True)


def phase_ab(report: dict) -> None:
    """Phase 16: the int4 A/B entry point at full shapes (gemma3-1b's 7
    projections x 26 layers, batch 8): every variant runs, 182 launches of
    each kernel a step (the wrappers count one eager step, two warm-up steps
    and the captured step: 4 x 182), ms a step by CUDA graph replay.  Then
    each kernel variant's output at each of the seven projections, on the
    entry point's own weights, against its plain version (K5's limits)."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops import int4 as i4
    from multimodal_concept_learning_tpu_torch.scripts import bench_int4_kernel as ab

    kernels = {"v2": ("int4_matmul", i4.int4_matmul, i4.int4_matmul_reference),
               "v3a": ("int4_matmul_v3a", i4.v3a_matmul, i4.v3a_matmul_reference),
               "v3b": ("int4_matmul_v3b", i4.v3b_matmul, i4.v3b_matmul_reference)}
    for _, fn, _ in kernels.values():
        fn.launches = 0
    results = ab.main(["--variants", ",".join(ab.VARIANTS), "--device", "cuda"])
    launches = {v: fn.launches for v, (_, fn, _) in kernels.items()}
    w4, _, x0 = ab.make_weights(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(16)
    errs = {}
    for (d_in, d_out), (packed, scale) in zip(ab.SHAPES, w4):
        x = x0 if d_in == x0.shape[1] else torch.randn(
            ab.B, d_in, generator=gen, device="cuda").to(torch.bfloat16)
        for v, (_, fn, ref_fn) in kernels.items():
            ref = ref_fn(x.float(), packed, scale)
            err = (fn(x, packed, scale).float() - ref).abs().max().item()
            limit = K5_TOL["bfloat16"] * ref.abs().max().item()
            if not err <= limit:
                fail(f"A/B {v} [{ab.B},{d_in}]x[{d_in},{d_out}]: max abs err {err} > {limit}")
            errs[v] = max(errs.get(v, 0.0), err / limit)
    print("[ab] each variant's output at the seven projections against its plain version, "
          "largest error as a share of its limit: "
          + ", ".join(f"{v} {e:.3f}" for v, e in errs.items()), flush=True)
    step = LM_PROJECTION_LAUNCHES
    print("[ab] decode-step matmuls (ms, CUDA graph replay, min / median of 5): " + "; ".join(
        f"{v} {r['ms']:.4f} / {r['median_ms']:.4f}" for v, r in results.items())
        + f"; kernel launches counted {launches}", flush=True)
    if any(r["calls"] != step for r in results.values()):
        fail(f"A/B: matmuls a step {[r['calls'] for r in results.values()]} != {step}")
    if any(results[v]["launches"] != step or launches[v] != 4 * step for v in kernels):
        fail(f"A/B: launches a step {[results[v]['launches'] for v in kernels]}, counted "
             f"{launches} (expected {step} and {4 * step})")
    for v in ("v3a", "v3b"):
        report[kernels[v][0]]["launches"] = launches[v]


def _train_batch(tokenizer, labels_mapping, seed: int, b: int = 2):
    """A collated 224px training batch of the 12_colors_3k prompts (numpy)."""
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator

    names = sorted(labels_mapping)
    collator = MultimodalCollator(tokenizer, 197, TRAINING_CONFIG["prompt_template"], names,
                                  labels_mapping, seed=seed)
    samples = []
    for i in range(b):
        key = names[(seed * b + i) % len(names)]
        samples.append((_circle(_rgb(key)), key))
    return collator(samples)


def phase_train_parity() -> None:
    """Full widths, 2 ViT + 2 LM layers (one sliding, one global), float32,
    language_embed_only: three micro-steps with accumulation 2 on the card
    (K1 forward, dQ and dK/dV kernels) and on the CPU (plain versions) give
    the same losses and trained tensors; frozen tensors stay bitwise."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        MLLM,
        MLLMConfig,
        copy_init_ood_rows,
        trainable_mask,
    )
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, training_config

    with open(MAPPING) as f:
        labels_mapping = json.load(f)
    tokenizer, _ = build_tokenizer(training_config(dict(TRAINING_CONFIG,
                                                        labels_mapping_path=MAPPING)))
    base = MLLMConfig.create(vocab_size=len(tokenizer), dtype=torch.float32)
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
        lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=64,
                               sliding_window_pattern=2))
    model0 = init_random_weights_(MLLM(cfg), torch.Generator().manual_seed(SEED))
    copy_init_ood_rows(model0, 6)
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    batches = [_train_batch(tokenizer, labels_mapping, seed=i) for i in range(3)]
    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = MLLM(cfg)
        model.load_state_dict(sd, strict=True)
        mask = trainable_mask(model, "language_embed_only")
        opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                              accumulation_steps=2)
        state, step = TrainState(model=model, optimizer=opt), make_mllm_train_step(model)
        before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                  fa.flash_attention_bwd_dkv.launches)
        losses = []
        for batch in batches:
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
        launched = tuple(n - b for n, b in zip((fa.flash_attention.launches,
                                               fa.flash_attention_bwd_dq.launches,
                                               fa.flash_attention_bwd_dkv.launches), before))
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     launched, mask)
    (cl, csd, claunch, mask), (pl, psd, plaunch, _) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, pl))
    trained = [n for n, t in mask.items() if t]
    # Adam's first update is ~lr * g / |g| per element, so an element whose
    # gradient nearly cancels can flip between two summation orders: hold
    # each trained tensor to 1e-4 relative in norm, and report the largest
    # element difference in units of the learning rate
    param_err = max(((csd[n] - psd[n]).norm() / psd[n].norm()).item() for n in trained)
    worst = max((csd[n] - psd[n]).abs().max().item() for n in trained) / 5e-4
    moved = all(not torch.equal(csd[n], sd[n]) for n in trained)
    frozen_same = all(torch.equal(csd[n], sd[n]) and torch.equal(psd[n], sd[n])
                      for n, t in mask.items() if not t)
    print(f"[train-parity] losses cuda {cl} cpu {pl}: max rel err {loss_err:.2e}; trained "
          f"tensors {trained}: max norm-relative err {param_err:.2e} (largest element "
          f"difference {worst:.3f} lr), moved {moved}; frozen bitwise "
          f"unchanged {frozen_same}; kernel launches (fwd, dq, dkv) cuda {claunch} "
          f"cpu {plaunch}", flush=True)
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and moved and frozen_same):
        fail("training parity CUDA vs CPU")
    if min(claunch) == 0 or max(plaunch) != 0:
        fail(f"training parity launches: cuda {claunch}, cpu {plaunch}")


def _write_config(src: str, root: str, overrides: dict) -> dict:
    """The YAML ``src`` with the top-level ``overrides`` written into
    ``root/<name>``; returns {"path", "parsed"}."""
    from multimodal_concept_learning_tpu_torch import miniyaml

    with open(src) as f:
        text = f.read()
    lines = []
    for line in text.splitlines():
        key = line.split(":", 1)[0]
        lines.append(f"{key}: {overrides[key]}" if key in overrides and not line.startswith(" ")
                     else line)
    path = os.path.join(root, os.path.basename(src))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path) as f:
        return {"path": path, "parsed": miniyaml.safe_load(f)}


def _write_train_config(root: str, data_dir: str) -> str:
    """experiments/multimodal/color/12_colors_3k.yaml with the paths under
    ``root``, epochs 1 and 2 loader workers, as a YAML file."""
    cfg = _write_config(os.path.join(REPO, "experiments/multimodal/color/12_colors_3k.yaml"),
                        root, {"mapping_path": os.path.join(data_dir, "train_mapping.csv"),
                               "image_root": data_dir, "labels_mapping_path": MAPPING,
                               "results_dir": os.path.join(root, "results"), "epochs": "1",
                               "num_workers": "2"})
    parsed = cfg["parsed"]
    assert parsed["epochs"] == 1 and parsed["batch_size"] == 2 and parsed["image_root"] == data_dir
    return cfg["path"]


def _generate_colors(root: str, images_per_color: int) -> tuple:
    """The 12_colors_3k dataset at ``images_per_color``, under ``root/data``:
    (dataset dir, {split: pairs})."""
    import csv

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig,
        generate_color_dataset,
    )

    with open(os.path.join(REPO, "experiments/datasets/color/12_colors_3k.yaml")) as f:
        ds = dict(miniyaml.safe_load(f), n_images_per_color=images_per_color,
                  data_dir=os.path.join(root, "data"))
    data_dir = generate_color_dataset(ColorDatasetConfig.from_params(ds), verbose=False)
    sizes = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(data_dir, f"{split}_mapping.csv")) as f:
            sizes[split] = sum(1 for _ in csv.DictReader(f))
    return data_dir, sizes


def phase_train_slice(report: dict, root: str, images_per_color: int = 8) -> None:
    """The port's trainer CLI on the full 12_colors_3k model, one epoch."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import changed_frozen, load_state_dict
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, images_per_color)
    cfg_path = _write_train_config(root, data_dir)
    print(f"[train] {images_per_color} images per color generated ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for fn in counters + (ac.attention_core_fwd, ac.attention_core_bwd):
        fn.launches = 0
    t0 = time.perf_counter()
    state, test_metrics, logged = train_main(["--config_path", cfg_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(
        ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), counters)}
    if ac.attention_core_fwd.launches or ac.attention_core_bwd.launches:
        fail("the MLLM's ViT took K2; it runs the bthd layout through K1")

    micro = sizes["train"] // 2  # batch 2, drop_last
    evals = -(-sizes["val"] // 2) + -(-sizes["test"] // 2)
    expected = {"flash_attention_fwd": 38 * (micro + evals),  # 12 ViT + 26 LM layers
                "flash_attention_bwd_dq": 26 * micro, "flash_attention_bwd_dkv": 26 * micro}
    epoch = logged[0] if logged else {}
    models = os.path.join(root, "results", "models")
    layout = ["initial_model.pt", "best_model.pt", "epoch_0_model.pt", "training_config.json",
              "tokenizer"]
    missing = [n for n in layout if not os.path.exists(os.path.join(models, n))]
    init_sd = load_state_dict(os.path.join(models, "initial_model.pt"))
    best_sd = load_state_dict(os.path.join(models, "best_model.pt"))
    trained = ("language_model.model.embed_tokens.weight", "projector.weight", "projector.bias")
    moved = all(not torch.equal(init_sd[n], best_sd[n]) for n in trained)
    # the checkpoints' layout: frozen leaves bitwise those of initial_model.pt
    frozen_same = all(torch.equal(init_sd[n], best_sd[n]) for n in init_sd if n not in trained)
    float32 = all(t.dtype == torch.float32 for t in best_sd.values())
    # the card's own frozen parameters, after the epoch, against initial_model.pt
    # cast to their storage dtype: nothing on the card wrote to them
    changed_on_card = changed_frozen(state.model, init_sd)
    del init_sd, best_sd, state
    finite = all(np.isfinite(epoch.get(k, float("nan"))) for k in ("train_loss", "val_loss"))
    finite = finite and np.isfinite(test_metrics["test_loss"])
    steps_per_s = epoch.get("micro_steps", 0) / epoch["train_time"] if epoch else 0.0
    print(f"[train] one epoch: {epoch.get('micro_steps')} micro-steps (batch 2, 4 per update) "
          f"in {epoch.get('train_time', float('nan')):.3f} s: {steps_per_s:.3f} micro-steps/s, "
          f"{2 * steps_per_s:.3f} samples/s; epoch wall time (train + val) "
          f"{epoch.get('epoch_time', float('nan')):.3f} s; whole CLI run {wall:.1f} s",
          flush=True)
    print(f"[train] train loss {epoch.get('train_loss')}, val loss {epoch.get('val_loss')}, "
          f"test {test_metrics}; kernel launches {launches} (expected {expected}); "
          f"trained tensors moved {moved}, frozen bitwise == initial_model.pt {frozen_same}, "
          f"frozen on the card changed {changed_on_card}, float32 leaves {float32}, "
          f"missing files {missing}", flush=True)
    if not (finite and moved and frozen_same and not changed_on_card and float32
            and not missing):
        fail("training slice checks")
    if launches != expected:
        fail(f"training slice launch counts {launches} != expected {expected}")
    for name, n in launches.items():
        report[name]["launches"] = n


def _clip_batches(tokenizer, n: int, b: int) -> list:
    """``n`` collated CLIP batches of ``b`` 224px circles of the 12 colors
    with their captions (numpy)."""
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator

    collator = ClipCollator(tokenizer, CLIP_CAPTION, 77)
    names = _color_names()
    picks = [[names[(s * b + i) % len(names)] for i in range(b)] for s in range(n)]
    return [collator([(_circle(_rgb(c)), c) for c in row]) for row in picks]


def _noise_batches(vocab: int, pad_id: int, n: int, b: int, seed: int) -> list:
    """``n`` CLIP batches of ``b`` uniform-noise 224px images and captions of
    random token ids, left-aligned masks of 4-19 tokens (numpy)."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n):
        mask = (np.arange(77)[None, :] < rng.integers(4, 20, size=(b, 1))).astype(np.int32)
        ids = np.where(mask == 1, rng.integers(4, vocab, size=(b, 77)), pad_id).astype(np.int32)
        batches.append({"images": rng.random((b, 3, 224, 224), dtype=np.float32),
                        "input_ids": ids, "attention_mask": mask})
    return batches


def _clip_counters() -> dict:
    """The CLIP paths' kernel wrappers by report name."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import fused_attention_block as fb

    return {"attention_core_fwd": ac.attention_core_fwd,
            "attention_core_bwd": ac.attention_core_bwd,
            "attention_core_bd_fwd": ac.attention_core_bd_fwd,
            "attention_core_bd_bwd": ac.attention_core_bd_bwd,
            "fused_attention_fwd": fb.fused_attention_fwd,
            "fused_bwd_attn": fb.fused_bwd_attn}


def _clip_parity(tag: str, fused: bool, expected: dict) -> None:
    """Full widths (ViT-B/32; text 512 wide, 8 heads), 2 vision + 2 text
    layers, float32, batch 8, the JAX initialisers, on the card (kernels)
    and on the CPU (plain versions): the first batch's gradient of every
    tensor within 1e-4 relative in norm; then three train steps with the
    same losses (1e-4 relative) and parameters (1e-4 relative in norm).
    ``fused`` puts the vision tower on K6; the card's launch counts over the
    four passes must equal ``expected`` (every other CLIP kernel 0), the
    CPU's all 0.

    The parameters are held as one vector, and each tensor's own distance
    is printed.  AdamW divides each element's update by that element's own
    gradient size, so an element whose gradient lies near zero takes an
    update that the float32 rounding of two summation orders changes by a
    large part of itself.  A tensor that is all update (a bias initialised
    at zero) thus lands ~sqrt(rounding / gradient scale) ~ 1e-4..1e-3 apart
    in norm in two float32 runs, whatever computes the gradients; the
    gradients themselves are linear in the rounding and are held per tensor.
    Noise images and random captions keep the samples' features apart, so
    no gradient is a batch sum that nearly cancels."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import (
        CLIPConfig,
        CLIPModel,
        contrastive_loss,
    )
    from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    tokenizer = load_tokenizer("concept-tokenizer")
    base = CLIPConfig.create(vocab_size=len(tokenizer), dtype=torch.float32)
    cfg = dataclasses.replace(base, text_layers=2, vision=dataclasses.replace(
        base.vision, num_hidden_layers=2, fused_attention=fused))
    model0 = init_random_weights_(CLIPModel(cfg), torch.Generator().manual_seed(SEED))
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    batches = _noise_batches(len(tokenizer), tokenizer.pad_token_id, 3, 8, SEED)
    counters = _clip_counters()
    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = CLIPModel(cfg)
        model.load_state_dict(sd, strict=True)
        before = {n: fn.launches for n, fn in counters.items()}
        first = to_device(batches[0], dev)
        contrastive_loss(*model(images_from_batch(first), first["input_ids"],
                                first["attention_mask"])).backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        opt = build_optimizer(model, 5e-4, weight_decay=0.2, max_grad_norm=1.0)
        state, step = TrainState(model=model, optimizer=opt), make_clip_train_step(model)
        losses = []
        for batch in batches:
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
        launched = {n: fn.launches - before[n] for n, fn in counters.items()}
        runs[dev] = (losses, grads, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     launched)
    (cl, cg, csd, claunch), (pl, pg, psd, plaunch) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, pl))

    def rel(a, b, names):
        return sorted((((a[n] - b[n]).norm() / b[n].norm()).item(), n) for n in names)

    # a key bias shifts every score of a row alike, so softmax cancels its
    # gradient exactly: what either run computes for it is rounding alone
    held = [n for n in cg if not n.endswith(("key.bias", ".k.bias"))]
    grad_errs = rel(cg, pg, held)
    flat = torch.cat([csd[n].flatten() - psd[n].flatten() for n in sd])
    param_err = (flat.norm() / torch.cat([psd[n].flatten() for n in sd]).norm()).item()
    tensor_errs = rel(csd, psd, held)
    moved = all(not torch.equal(csd[n], sd[n]) for n in sd)
    shown = {n: c for n, c in claunch.items() if c or expected.get(n)}
    print(f"[{tag}] losses cuda {cl} cpu {pl}: max rel err {loss_err:.2e}; first "
          f"gradients of {len(held)} tensors: max norm-relative err {grad_errs[-1][0]:.2e} "
          f"(largest: " + ", ".join(f"{n} {e:.2e}" for e, n in grad_errs[-3:]) + "); "
          f"parameters after 3 steps: norm-relative err {param_err:.2e}, largest tensor "
          + ", ".join(f"{n} {e:.2e}" for e, n in tensor_errs[-3:]) + f"; every tensor moved "
          f"{moved}; kernel launches cuda {shown} (expected {expected}), cpu "
          f"{sum(plaunch.values())}", flush=True)
    if not (loss_err <= 1e-4 and grad_errs[-1][0] <= 1e-4 and param_err <= 1e-4 and moved):
        fail(f"{tag}: CLIP training parity CUDA vs CPU")
    if claunch != {n: expected.get(n, 0) for n in counters} or any(plaunch.values()):
        fail(f"{tag} launches: cuda {claunch} (expected {expected}), cpu {plaunch}")


def phase_clip_parity() -> None:
    """Phase 8: the default CLIP (K2 in both towers): 4 passes x (2 vision
    + 2 text) layers of K2 forward and backward."""
    _clip_parity("clip-parity", False, {"attention_core_fwd": 16, "attention_core_bwd": 16})


def phase_variant_parity() -> None:
    """Phase 12: phase 8 under MCL_ATTN_CORE_BD=1, (a) with the vision tower
    on K6 (vision K6, text K2-bd) and (b) in the default layout (K2-bd in
    both towers); K2 never launched."""
    os.environ["MCL_ATTN_CORE_BD"] = "1"
    try:
        _clip_parity("variant-parity (a) fused vision", True, {
            "fused_attention_fwd": 8, "fused_bwd_attn": 8,
            "attention_core_bd_fwd": 8, "attention_core_bd_bwd": 8})
        _clip_parity("variant-parity (b) K2-bd both towers", False, {
            "attention_core_bd_fwd": 16, "attention_core_bd_bwd": 16})
    finally:
        del os.environ["MCL_ATTN_CORE_BD"]


def _steady_step_ms(state, steps: int = 3) -> float:
    """ms per train step of ``state.model`` on one fixed device batch of the
    slice's circles and captions (no input path), after one warm-up step;
    the model trains on."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel.train_step import make_clip_train_step
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    batch = to_device(_clip_batches(load_tokenizer("concept-tokenizer"), 1, CLIP_BATCH)[0],
                      "cuda")
    step = make_clip_train_step(state.model)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def phase_clip_slice(report: dict, root: str, images_per_color: int = 108) -> dict:
    """The port's contrastive CLI (``contrastive_training.main``) on the
    full CLIP of experiments/contrastive/color/12_colors_3k.yaml (ViT-B/32 +
    12 x 512 text tower, batch 256), one epoch on a generated 12-color
    dataset; exact K2 launch counts, finite losses, every tensor moved."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import init_model, main

    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, images_per_color)
    cfg = _write_config(CLIP_CONFIG, root, {
        "mapping_path": os.path.join(data_dir, "train_mapping.csv"), "image_root": data_dir,
        "results_dir": os.path.join(root, "results"), "epochs": "1"})
    config = ContrastiveTrainingConfig.from_params(cfg["parsed"])
    assert config.epochs == 1 and config.batch_size == CLIP_BATCH and config.text_layers == 12
    print(f"[clip] {images_per_color} images per color generated ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ac.attention_core_fwd.launches = ac.attention_core_bwd.launches = 0
    t0 = time.perf_counter()
    out = main(["--config_path", cfg["path"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {"attention_core_fwd": ac.attention_core_fwd.launches,
                "attention_core_bwd": ac.attention_core_bwd.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steady_ms = _steady_step_ms(out["state"])

    steps = sizes["train"] // CLIP_BATCH  # drop_last
    test_batches = -(-sizes["test"] // CLIP_BATCH)
    # 12 vision + 12 text layers a step; the class captions once; 12 vision a test batch
    expected = {"attention_core_fwd": 24 * steps + 12 + 12 * test_batches,
                "attention_core_bwd": 24 * steps}
    epoch, acc, ckpt = out["history"][0], out["zero_shot_acc"], out["checkpoint"]
    saved = os.path.exists(ckpt)
    trained = load_state_dict(ckpt) if saved else {}
    init = init_model(config, len(load_tokenizer("concept-tokenizer")), "cuda")
    unmoved = [n for n, t in init.state_dict().items()
               if n not in trained or torch.equal(t.cpu(), trained[n])]
    del init, out
    rate = epoch["steps"] / epoch["epoch_time"]
    print(f"[clip] one epoch: {epoch['steps']} steps of batch {CLIP_BATCH} in "
          f"{epoch['epoch_time']:.3f} s: {rate:.3f} steps/s, {CLIP_BATCH * rate:.1f} images/s; "
          f"whole CLI run {wall:.1f} s; peak memory {peak_gib:.2f} GiB; steady step on a "
          f"fixed device batch {steady_ms:.2f} ms", flush=True)
    print(f"[clip] train loss {epoch['train_loss']}, zero-shot accuracy {acc}%, checkpoint "
          f"{os.path.basename(ckpt)} saved {saved}; tensors unmoved {unmoved}; K2 launches "
          f"{launches} (expected {expected})", flush=True)
    if not (np.isfinite(epoch["train_loss"]) and 0.0 <= acc <= 100.0 and saved and not unmoved):
        fail("CLIP slice checks")
    if launches != expected:
        fail(f"CLIP slice launch counts {launches} != expected {expected}")
    for name, n in launches.items():
        report[name]["launches"] = n
    return {"config": config, "steps_per_s": rate, "images_per_s": CLIP_BATCH * rate,
            "peak_gib": peak_gib, "steady_ms": steady_ms}


def _variant_model(config, vocab_size: int):
    """The config's CLIP as ``contrastive_training.init_model`` builds it
    (bf16 compute over float32 parameters, the seeded init on the card),
    with the vision config replaced by ``fused_attention=True``."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel

    cfg = CLIPConfig.create(vocab_size=vocab_size, vision_preset=config.vision_model_name,
                            image_size=config.image_size, text_width=config.text_width,
                            text_layers=config.text_layers, text_heads=config.text_heads,
                            context_length=config.context_length, embed_dim=config.embed_dim,
                            dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, fused_attention=True))
    with torch.device("cuda"):
        model = CLIPModel(cfg)
    return init_random_weights_(model, torch.Generator(device="cuda").manual_seed(config.seed))


def phase_variant_slice(report: dict, clip_run: dict) -> None:
    """Phase 13: the full CLIP of phase 9 (ViT-B/32 + 12 x 512, batch 256,
    bf16) with ``vision.fused_attention=True`` under MCL_ATTN_CORE_BD=1,
    built as ``contrastive_training.init_model`` builds it but for the
    vision config, trained by ``make_clip_train_step`` for one epoch of
    phase 9's generated data through the CLI's loader, then zero-shot
    (``make_zero_shot_step``) on the test split.  Per train step exactly 12
    K6 forward, 12 K6 backward, 12 K2-bd forward and 12 K2-bd backward
    launches and no K2; the class captions add 12 K2-bd forwards, each test
    batch 12 K6 forwards.  Finite loss, every tensor moved; steps/s,
    images/s and peak memory beside phase 9's."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ColorDataset,
        load_split_datasets,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
        build_optimizer,
        linear_warmup_schedule,
    )
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import zero_shot_eval

    config = clip_run["config"]
    tokenizer = load_tokenizer("concept-tokenizer")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = _variant_model(config, len(tokenizer))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    train, _, test = load_split_datasets(
        ColorDataset, mapping_dir=os.path.dirname(config.mapping_path),
        data_dir=config.image_root,
        train_transform=create_transforms(config, is_train=True, seed=config.seed),
        val_transform=create_transforms(config, is_train=False, seed=config.seed),
        return_synset=True)
    collator = ClipCollator(tokenizer, config.caption_template, config.context_length)
    loader = BatchLoader(train, batch_size=config.batch_size, shuffle=True, drop_last=True,
                         collate_fn=collator, seed=config.seed)
    schedule = linear_warmup_schedule(config.learning_rate, config.warmup_steps, len(loader))
    opt = build_optimizer(model, schedule, weight_decay=config.weight_decay,
                          max_grad_norm=config.max_grad_norm)
    state, step = TrainState(model=model, optimizer=opt), make_clip_train_step(model)
    label_to_idx = {n: i for i, n in enumerate(train.unique_labels)}

    def eval_collate(batch):  # the CLI's
        return {"images": np.stack([b[0] for b in batch]).astype(np.float32),
                "labels": np.asarray([label_to_idx[b[1]] for b in batch], dtype=np.int32)}

    counters = _clip_counters()
    os.environ["MCL_ATTN_CORE_BD"] = "1"
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        loader.set_epoch(0)
        losses = []
        for batch in loader:
            state, m = step(state, to_device(batch, "cuda"))
            losses.append(m["loss"])
        loss = float(torch.stack(losses).mean())
        epoch_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        trained = {n: fn.launches for n, fn in counters.items()}
        acc = zero_shot_eval(model, BatchLoader(test, batch_size=config.batch_size,
                                                collate_fn=eval_collate),
                             train.unique_labels, collator, "cuda")
        launches = {n: fn.launches for n, fn in counters.items()}
        unmoved = [n for n, t in model.state_dict().items() if torch.equal(t, init[n])]
        steady_ms = _steady_step_ms(state)
    finally:
        del os.environ["MCL_ATTN_CORE_BD"]
    steps, test_batches = len(losses), -(-len(test) // config.batch_size)
    per_step = {"fused_attention_fwd": 12, "fused_bwd_attn": 12, "attention_core_bd_fwd": 12,
                "attention_core_bd_bwd": 12}
    expected_train = {n: per_step.get(n, 0) * steps for n in counters}
    expected = dict(expected_train,
                    fused_attention_fwd=12 * (steps + test_batches),
                    attention_core_bd_fwd=12 * (steps + 1))
    del init, state, model, opt
    rate = steps / epoch_s
    print(f"[variant] one epoch: {steps} steps of batch {config.batch_size} in {epoch_s:.3f} s: "
          f"{rate:.3f} steps/s, {config.batch_size * rate:.1f} images/s, peak memory "
          f"{peak_gib:.2f} GiB, steady step {steady_ms:.2f} ms; phase 9 (default path): "
          f"{clip_run['steps_per_s']:.3f} steps/s, {clip_run['images_per_s']:.1f} images/s, "
          f"{clip_run['peak_gib']:.2f} GiB, steady step {clip_run['steady_ms']:.2f} ms",
          flush=True)
    print(f"[variant] train loss {loss}, zero-shot accuracy {acc}%; tensors unmoved {unmoved}; "
          f"launches after training {trained} (expected {expected_train}), after zero-shot "
          f"{launches} (expected {expected})", flush=True)
    if not (np.isfinite(loss) and steps > 0 and 0.0 <= acc <= 100.0 and not unmoved):
        fail("variant slice checks")
    if trained != expected_train or launches != expected:
        fail(f"variant slice launch counts {trained}, {launches}")
    for name in per_step:
        report[name]["launches"] = launches[name]


PORT_KERNELS = ("core_fwd_kernel", "core_fwd_tc_kernel", "core_bwd_kernel", "bd_fwd_kernel",
                "bd_fwd_tc_kernel", "merged_bwd_kernel", "bwd_dq_tc_kernel",
                "bwd_dkv_tc_kernel", "fused_attn_kernel", "out_proj_kernel",
                "flash_fwd", "flash_bwd")  # the port's attention kernels, by name
K1_GROUPS = {"K1 forward": "flash_fwd", "K1 dQ": "flash_bwd_dq",
             "K1 dK/dV": "flash_bwd_dkv"}  # K1's kernels by name, both dtypes


def profile_clip(steps: int = 6, warmup: int = 4) -> None:
    """``--profile``: the full CLIP train step (batch 256, bf16 compute, the
    trainer's optimizer) on a fixed device batch, on the default path (K2)
    and on the kernel variants (fused vision tower under
    MCL_ATTN_CORE_BD=1: K6 and K2-bd), then the input path alone."""
    import torch

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_clip_train_step,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import init_model

    with open(CLIP_CONFIG) as f:
        config = ContrastiveTrainingConfig.from_params(miniyaml.safe_load(f))
    tokenizer = load_tokenizer("concept-tokenizer")
    batch = to_device(_clip_batches(tokenizer, 1, CLIP_BATCH)[0], "cuda")

    def run(tag, model):
        opt = build_optimizer(model, config.learning_rate, weight_decay=config.weight_decay,
                              max_grad_norm=config.max_grad_norm)
        _profile_step(tag, TrainState(model=model, optimizer=opt), make_clip_train_step(model),
                      batch, steps, warmup, CLIP_BATCH, "images")

    run("default", init_model(config, len(tokenizer), "cuda"))
    torch.cuda.empty_cache()
    os.environ["MCL_ATTN_CORE_BD"] = "1"
    try:
        run("variant", _variant_model(config, len(tokenizer)))
    finally:
        del os.environ["MCL_ATTN_CORE_BD"]
    _time_loader(config, tokenizer)


def profile_mllm(root: str, steps: int = 6, warmup: int = 4) -> None:
    """``--profile-mllm [ROOT]``: the full 12_colors_3k MLLM micro-step
    (batch 2, bf16 compute, the trainer's optimizer with 4 micro-steps an
    update, the vision tower and the LM's non-embedding weights frozen) on a
    fixed device batch, from the port package of the checkout at ``root``
    (``sys.path`` puts it first; a parent checkout, which has no such flag,
    is profiled this way), with K1's forward, dQ and dK/dV in ms a
    micro-step."""
    import torch

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import trainable_mask
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import (
        init_model_and_tokenizer,
    )

    print(f"[ab] kernels of {os.path.abspath(root)}", flush=True)
    with open(os.path.join(REPO, "experiments/multimodal/color/12_colors_3k.yaml")) as f:
        params = miniyaml.safe_load(f)
    config = MultimodalTrainingConfig.from_params(dict(params, labels_mapping_path=MAPPING))
    model, tokenizer, labels_mapping, _ = init_model_and_tokenizer(
        config, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    trainable_mask(model, config.trainable_params_setting)
    opt = build_optimizer(model, config.learning_rate, weight_decay=config.weight_decay,
                          max_grad_norm=config.max_grad_norm,
                          accumulation_steps=config.effective_batch_size // config.batch_size)
    cast_for_compute(model, model.cfg.dtype, only_frozen=True)
    batch = to_device(_train_batch(tokenizer, labels_mapping, seed=0), "cuda")
    _profile_step("mllm", TrainState(model=model, optimizer=opt), make_mllm_train_step(model),
                  batch, steps, warmup, config.batch_size, "samples", groups=K1_GROUPS)


def _profile_step(tag: str, state, step, batch, steps: int, warmup: int, batch_size: int,
                  unit: str, groups: dict = None) -> None:
    """Steady ms per step unprofiled; a ``torch.profiler`` window of
    ``steps`` steps tracing the card only: device busy time (union of kernel
    intervals) and the idle share, against the unprofiled step and against
    the window's own wall time; then a window tracing host and card: aten
    ops per step, device time by kernel (the port's kernels and the matrix
    products summed, and each of ``groups``: {label: name fragment}), and
    how far host tracing stretches the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    print(f"[profile {tag}] unprofiled: {step_ms:.2f} ms per step, {1e3 / step_ms:.3f} steps/s, "
          f"{batch_size * 1e3 / step_ms:.1f} {unit}/s (loss {float(m['loss']):.4f})", flush=True)

    def window(activities):
        nonlocal state
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        events = prof.events()
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for lo, hi in spans:
            busy += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        return events, spans, busy, wall_us

    _, _, busy_dev, wall_dev = window([ProfilerActivity.CUDA])
    busy_ms = busy_dev / 1e3 / steps
    print(f"[profile {tag}] card-only trace of {steps} steps: device busy {busy_ms:.2f} ms a "
          f"step; idle share {1 - busy_ms / step_ms:.3f} of the unprofiled step, "
          f"{1 - busy_dev / wall_dev:.3f} of the window ({wall_dev / 1e3 / steps:.2f} ms a "
          f"step)", flush=True)
    events, spans, busy, wall_us = window([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    aten = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("aten::"))
    by_kernel = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = by_kernel.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.end - e.time_range.start
            k[1] += 1
    ours = sum(t for name, (t, _) in by_kernel.items() if any(k in name for k in PORT_KERNELS))
    gemm = sum(t for name, (t, _) in by_kernel.items()
               if any(tag in name for tag in ("gemm", "nvjet", "cutlass", "xmma")))
    sgemm = sum(t for name, (t, _) in by_kernel.items()  # float32 products on the CUDA cores
                if "sgemm" in name or ("gemm" in name and "ffma" in name))
    print(f"[profile {tag}] host + card trace of {steps} steps: wall {wall_us / 1e3:.2f} ms "
          f"({wall_us / 1e3 / steps / step_ms:.2f}x the unprofiled step), device busy "
          f"{busy / 1e3:.2f} ms; {len(spans)} kernels and {aten} aten ops "
          f"({aten / steps:.0f} a step); the port's attention kernels {ours / 1e3:.2f} ms = "
          f"{ours / busy:.3f} and matrix products {gemm / 1e3:.2f} ms = {gemm / busy:.3f} of "
          f"device time, of them float32 on the CUDA cores {sgemm / 1e3 / steps:.2f} ms a step = "
          f"{sgemm / busy:.3f}", flush=True)
    for label, frag in (groups or {}).items():
        t = sum(t for name, (t, _) in by_kernel.items() if frag in name)
        n = sum(n for name, (_, n) in by_kernel.items() if frag in name)
        print(f"[profile {tag}] {label}: {t / 1e3 / steps:.4f} ms a step in {n // steps} "
              f"launches ({t / busy:.3f} of device time)", flush=True)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (t, n) in ranked[:15]:
        print(f"[profile {tag}] {t / 1e3 / steps:8.3f} ms/step {t / busy:6.3f} {n // steps:5d}x "
              f"{name[:110]}", flush=True)
    for name, (t, n) in ranked:  # every port kernel the step launched, by name
        if any(k in name for k in PORT_KERNELS):
            print(f"[profile {tag}] port kernel {t / 1e3 / steps:8.3f} ms/step {n // steps:5d}x "
                  f"{name[:110]}", flush=True)


def _time_loader(config, tokenizer, images_per_color: int = 108) -> None:
    """The CLI's input path alone: one epoch of the train loader (PNG decode,
    ToTensor, collation) over the CLIP slice's generated dataset, each batch
    moved to the card, no model."""
    import shutil
    import tempfile

    import torch

    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ColorDataset,
        load_split_datasets,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    root = tempfile.mkdtemp(prefix="_smoke_loader_", dir=REPO)
    try:
        data_dir, _ = _generate_colors(root, images_per_color)
        train, _, _ = load_split_datasets(ColorDataset, data_dir, data_dir,
                                          create_transforms(config, True, config.seed),
                                          create_transforms(config, False, config.seed), True)
        loader = BatchLoader(train, batch_size=CLIP_BATCH, shuffle=True, drop_last=True,
                             seed=config.seed, collate_fn=ClipCollator(
                                 tokenizer, config.caption_template, config.context_length))
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            to_device(batch, "cuda")
            n += 1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[profile] input path alone: {n} batches of {CLIP_BATCH} in {dt:.3f} s = "
          f"{1e3 * dt / n:.1f} ms a batch, {n * CLIP_BATCH / dt:.1f} images/s", flush=True)


SOURCES = {
    "flash_attention_fwd": ("multimodal_concept_learning_tpu_torch/csrc/flash_attention_fwd.cu",
                            "multimodal_concept_learning_tpu/ops/flash_attention.py:31"),
    "flash_attention_bwd_dq": (
        "multimodal_concept_learning_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        "multimodal_concept_learning_tpu/ops/flash_attention.py:52"),
    "flash_attention_bwd_dkv": (
        "multimodal_concept_learning_tpu_torch/csrc/flash_attention_bwd_tc.cu",
        "multimodal_concept_learning_tpu/ops/flash_attention.py:76"),
    "paged_decode_attention": ("multimodal_concept_learning_tpu_torch/csrc/paged_attention.cu",
                               "multimodal_concept_learning_tpu/ops/paged_attention_kernel.py:43"),
    "attention_core_fwd": ("multimodal_concept_learning_tpu_torch/csrc/attention_core.cu",
                           "multimodal_concept_learning_tpu/ops/attention_core.py:104"),
    "attention_core_bwd": ("multimodal_concept_learning_tpu_torch/csrc/merged_bwd_tc.cuh",
                           "multimodal_concept_learning_tpu/ops/attention_core.py:123"),
    "int4_matmul": ("multimodal_concept_learning_tpu_torch/csrc/int4_matmul.cu",
                    "multimodal_concept_learning_tpu/ops/int4.py:111"),
    "paged_decode_attention_mp": (
        "multimodal_concept_learning_tpu_torch/csrc/paged_attention_mp.cu",
        "multimodal_concept_learning_tpu/ops/paged_attention_mp_kernel.py:47"),
    "attention_core_bd_fwd": ("multimodal_concept_learning_tpu_torch/csrc/attention_core_bd.cu",
                              "multimodal_concept_learning_tpu/ops/attention_core.py:179"),
    "attention_core_bd_bwd": ("multimodal_concept_learning_tpu_torch/csrc/merged_bwd_tc.cuh",
                              "multimodal_concept_learning_tpu/ops/attention_core.py:203"),
    "fused_attention_fwd": (
        "multimodal_concept_learning_tpu_torch/csrc/fused_attention_block.cu",
        "multimodal_concept_learning_tpu/ops/fused_attention_block.py:86"),
    "fused_bwd_attn": ("multimodal_concept_learning_tpu_torch/csrc/merged_bwd_tc.cuh",
                       "multimodal_concept_learning_tpu/ops/fused_attention_block.py:106"),
    "int4_matmul_v3a": ("multimodal_concept_learning_tpu_torch/csrc/int4_matmul_v3.cu",
                        "scripts/bench_int4_kernel.py:49"),
    "int4_matmul_v3b": ("multimodal_concept_learning_tpu_torch/csrc/int4_matmul_v3.cu",
                        "scripts/bench_int4_kernel.py:66"),
}
KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def main(argv=None) -> None:
    import argparse
    import shutil
    import tempfile

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="build, then profile the full CLIP train step; no other phase")
    parser.add_argument("--time-forwards", metavar="ROOT",
                        help="build the kernels of the checkout at ROOT, then time the K1 and "
                             "K2 forwards (bf16, graph replay) beside SDPA; no other phase")
    parser.add_argument("--time-variants", metavar="ROOT",
                        help="build the kernels of the checkout at ROOT, then time K2-bd's "
                             "forward and backward beside K2, K6's backward and K1's "
                             "backward (bf16, graph replay) beside SDPA; no other phase")
    parser.add_argument("--profile-mllm", metavar="ROOT", nargs="?", const=".",
                        help="build the kernels of the checkout at ROOT (default: this one), "
                             "then profile the full MLLM micro-step; no other phase")
    args = parser.parse_args(argv)
    ab_root = args.time_forwards or args.time_variants or args.profile_mllm
    if ab_root:
        sys.path.insert(0, os.path.abspath(ab_root))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    if not os.path.isdir(os.path.join(REPO, "multimodal_concept_learning_tpu_torch")):
        fail(f"no multimodal_concept_learning_tpu_torch package beside {__file__}: "
             "run this script from a checkout of the repository")
    from multimodal_concept_learning_tpu_torch.device import set_reference_numerics

    set_reference_numerics()
    t_start = time.perf_counter()
    card = phase_card()
    phase_build(check_spills=not ab_root)
    if args.time_forwards:
        time_forwards(args.time_forwards)
        return
    if args.time_variants:
        time_variants(args.time_variants)
        return
    if args.profile:
        profile_clip()
        return
    if args.profile_mllm:
        profile_mllm(args.profile_mllm)
        return
    report: dict = {}
    phase_kernels(report)
    phase_parity()
    phase_quant_parity()
    phase_generate_parity()
    root = tempfile.mkdtemp(prefix="_smoke_results_", dir=REPO)  # listed in .gitignore
    try:
        float_run = phase_slice(report, root)
        phase_quant_slice(report, root, float_run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    serving_k1 = report["flash_attention_fwd"]["launches"]
    phase_train_parity()
    root = tempfile.mkdtemp(prefix="_smoke_train_", dir=REPO)
    try:
        phase_train_slice(report, root)
        phase_answer_slice(root)  # on phase 7's results dir and data
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[timing] K1 forward launches: serving slice {serving_k1}, training slice "
          f"{report['flash_attention_fwd']['launches']}", flush=True)
    phase_clip_parity()
    phase_variant_parity()
    root = tempfile.mkdtemp(prefix="_smoke_clip_", dir=REPO)
    try:
        clip_run = phase_clip_slice(report, root)
        phase_variant_slice(report, clip_run)  # on phase 9's generated data
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_ab(report)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], **{k: r[k] for k in KEYS}}
               for name, r in report.items()]
    if sorted(report) != sorted(SOURCES):
        fail(f"the kernels' line lists {sorted(report)}, not the {len(SOURCES)} port kernels")
    print(f"[timing] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)  # again, beside the results: the card's name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
