"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):

1. card: ``nvidia-smi`` name and power limit, on a line of their own;
2. build: compile the port's CUDA kernels from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, in
   float32 and bfloat16, at the serving and training paths' shapes (max abs
   error, and kernel vs plain time from CUDA events); the build fails if
   ptxas reports spill stores in a tensor-core kernel (the bf16 K1, K2 and
   K2-bd forwards, the bf16 backward pair of K2, K2-bd and K6, K1's bf16
   backward pair, K5, K6's bf16 forward) or in K3 or K4;
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
7. training slice (run after phase 18): the port's trainer CLI
   (``multimodal_training.main``) trains the full ``12_colors_3k`` model
   (seeded random init, the vision tower warm-started through
   ``vision_path`` from phase 18's ``best_model.pt``, which
   ``initial_model.pt`` must hold bitwise) for one epoch on a small
   generated 12-color dataset; launch counts of the K1 forward, dQ and
   dK/dV kernels per micro-step, finite losses, trained tensors moved,
   frozen tensors bitwise those of ``initial_model.pt``, the full results
   layout, and micro-steps/s and samples/s;
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
    ``12_colors_3k`` model, float, ``--int4``, ``--int8 --int8_vision``,
    ``--num_beams 4`` and ``--draft_layers 13 --draft_len 4``, 16 samples
    of 8 tokens at batch 8; the accuracy lines, the JSONL rows, launch
    counts (K1: 38 a prefill and 26 a decode step, at 32 rows under beam
    search; speculative: 13 a draft proposal and 26 a verify, within the
    range its acceptance allows; K5 7 x 26 a decode step under ``--int4``,
    else 0), samples/s and tokens/s, and how many speculative rows equal
    the float greedy rows;
16. A/B (run last): the port's int4 A/B entry point
    (``scripts/bench_int4_kernel.py``) at the JAX script's shapes (gemma3-1b's
    7 projections x 26 layers, batch 8): K5, K5v3a, K5v3b and the int8
    product, 182 launches of each kernel a step, ms a step by CUDA graph
    replay;
17. vision parity (run after phase 6): the full-width vit-b-16 classifier
    at 2 layers, float32, batch 8: three micro-steps with accumulation 2 on
    the card and on the CPU give the same losses and parameters (1e-4;
    each tensor but the key biases), with exactly 2 K1 forward, 2 dQ and 2 dK/dV launches a micro-step; at
    dropout 0.1 a training micro-step launches no K1 kernel, a CUDA
    generator's masks repeat bitwise under one seed and keep 0.9 of the
    values (within 4 sigma);
18. vision slice (run before phase 7): the port's vision trainer CLI
    (``vision_training.main``) on
    ``experiments/vision/color/12_colors_3k.yaml`` as it stands (vit-b-16,
    bf16, dropout 0.1, batch 64) for one epoch on a generated 12-color
    dataset of 64 images a color (the dataset's 80/10/10 split: 612
    training images, 9 micro-steps, 2 updates; 2 validation and 2 test
    batches); the reference-format lines, both checkpoints loading strict
    into the port's classifier, finite losses, K1 forward exactly 12 a
    validation or test batch and none in training; images/s,
    micro-steps/s, the epoch's wall time and peak memory;
19. analysis (run after phase 15, on phase 7's results dir): the port's
    token-embedding analysis CLI prints a finite Pearson r (and, without
    matplotlib, that the figures were skipped);
20. serving-fronts parity (run after phase 14, on phase 4's model: full
    widths, 2 + 2 layers, float32): the whole-batch engine, the dense
    continuous engine at steps_per_call 1 and 4, the chunked engine at
    chunk 16, beam search of width 4 (scores within 1e-4) and
    self-speculative decoding (draft_layers 1, draft_len 4) give the same
    greedy tokens on the card as on the CPU; speculative tokens and beam
    width 1 equal greedy's; exact K1 launch counts, K3, K4 and K5 never;
    the int8-pool paged engine's codes within 1 of the CPU's, its decode
    logits within 0.05 of dense (JAX's bound), its decode attention K1
    only (no K3 or K4); beam search on tied scores (``copy_init_ood_rows``
    over half the vocabulary, widths 2 and 3): the card's tokens and
    scores are the CPU's, every token the lower of its twins;
21. serving-fronts slice (run after phase 11, on phase 5's results dir, the
    full model in bf16): ``make_server`` with no front flag (the
    whole-batch front), ``continuous=True``, ``continuous=True,
    chunked_prefill=64`` and ``paged=True, int8_kv=True``, 16 requests from
    16 threads each: /healthz and /metrics, requests/s, tokens/s, p50
    latency, the longest gap between a request's streamed tokens, launch
    counts (K1 exactly 38 + 26 x 7 a whole batch; K3, K4, K5 never) beside
    phase 5's, and how many answers equal phase 5's (a count, not a gate);
22. LoRA parity (run after phase 17; full widths, 2 + 2 layers, float32,
    rank 8, alpha 16, both factors drawn nonzero): three ``language_lora``
    micro-steps with accumulation 2 on the card and on the CPU give the
    same losses and trained tensors (the 28 factors and the projector, all
    moved), frozen tensors bitwise unchanged, and exactly the K1 forward,
    dQ and dK/dV launches of the same steps without adapters; the merged
    forward on the card within 1e-5 (+ 1e-5 relative) of the adapter
    forward; a bank of
    three (the identity and two seeded adapters) behind the whole-batch and
    the dense continuous engines with mixed adapter ids: the card's tokens
    (and the continuous engine's KV caches, 1e-4) are the CPU's, exact K1
    counts, K3, K4 and K5 never, and the bank's hidden states are each
    row's merged adapter model's (1e-4); an int8 bank's tokens on the card
    are the CPU's;
23. LoRA slice (run after phase 19, on phase 7's generated data): the
    trainer CLI on a copy of the 12_colors_3k YAML with
    ``trainable_params_setting: language_lora`` and ``lm_lora_rank: 8``
    (the full model, bf16) for one epoch: micro-steps/s, K1 launches a
    micro-step those of phase 7, factors and projector moved, frozen
    tensors bitwise; the run served merged on the paged front (K1, K3) and
    through the answer CLI, float and ``--int4`` (K5 7 x 26 a decode step);
    a bank of the run and a seeded copy of it on the whole-batch and the
    dense continuous fronts, 16 requests from 16 threads of adapters 0, 1
    and 2: /healthz, /metrics, requests/s, p50, K1 exactly 38 + 26 x 7 a
    whole batch, K3, K4 and K5 never, and how many adapter-1 answers equal
    the merged server's (a count, not a gate);
24. the port's multi-LoRA benchmark (``scripts/bench_multi_lora.py``) at
    its defaults: plain and bank ms a token and fixed cost;
30. ImageNet data on the host (this machine has no Pillow): every JPEG
    fixture of tests/data/jpeg decoded by the port's C++ decoder (built
    here) to the sha256 of Pillow's ``convert("RGB")``; the train and val
    pipelines of the four ImageNet configs over them at two seeds to the
    JAX pipelines' recorded sha256; ms an image of the decode alone at
    500x375 and the loader's images/s alone (imagenet100's train pipeline,
    batch 64, 8 workers);
31. ImageNet vision: a synthetic tree of imagenet100's 100 synsets through
    the port's builder CLI, then the vision CLI on a copy of
    ``imagenet100.yaml`` (only paths and epochs changed: ViT-B/16, 100
    labels, dropout 0.1, batch 64, 16 micro-steps an update; 1100 JPEGs,
    one update), K1 exactly 12 a validation or test batch; three
    classifier micro-steps at dropout 0 on JPEG-fed batches, card against
    CPU (phase 17's tolerances);
32. ImageNet MLLM: a synthetic tree of the 1000 synsets of
    ``imagenet1k_vit``'s labels mapping through the port's imagenet_configs
    and builder CLIs, the trainer CLI on a copy of ``imagenet1k_vit.yaml``
    (only paths and epochs changed: vit-b-16 + gemma3-1b, bf16, batch 8,
    32 micro-steps an update; 264 JPEGs, one update) with exact K1 forward,
    dQ and dK/dV counts, ``generate_answers`` on its checkpoint and the
    ImageNet analysis CLI on its epoch checkpoints;
33. MoE parity (after phase 22): phase 4's model (full widths, 2 + 2
    layers, float32) with a 4-expert top-2 MoE in every LM block, dense and
    sparse at cf 1.25 and sparse at cf 0.5 (which drops), card against CPU:
    hidden states and per-layer aux within 1e-4, the same drop fraction,
    three ``language_only`` micro-steps (cf 1.25): losses, the first and the
    accumulated gradients and each tensor's change by the update within
    1e-4, equal greedy paged tokens, exact K1f / K1q / K1kv / K3 launches;
34. MoE slice (after phase 28, on phase 7's data): the trainer CLI on a
    copy of 12_colors_3k.yaml with ``lm_moe_experts: 4`` (the LM cut to 2
    layers: a full-depth 4-expert checkpoint is ~10.6 GB), dense then
    sparse, one epoch each (exact K1 counts, micro-steps/s, samples/s, peak
    memory); the sparse results dir served on the paged front (16
    requests) and through the answer CLI; ``--int4`` refused as in JAX;
35. MoE bench (after phase 26): the port's ``scripts/bench_mllm.py`` at the
    JAX script's cell (full depth, batch 16), E=4, top-2, cf 1.25, dense
    against sparse with ``--moe_stats``: images/s and drop_frac (the A/B
    BASELINE.md:559-584 owes; ``--profile-moe`` traces one step of each);
36. data parallel at world size 1: the MLLM (LM at 2 layers), vision and
    CLIP CLIs on small generated data, once in the side process (below)
    and once under ``torchrun --standalone --nproc_per_node 1`` (NCCL; the
    first run in a fresh process): the same losses and saved weights
    (within 1e-6; bitwise expected), the same files written by rank 0; the
    epochs' micro-steps/s beside the single process's, and the steady
    micro-step rate of each trainer's full model on a fixed device batch
    (the MLLM at phase 7's depth) in the torchrun process, windows
    alternating between the group's path and the single-process path;
37-39. meshes: two ranks sharing the card over Gloo (``--mesh-worker``),
    the 12_colors_3k MLLM at full widths with the LM cut to 6 blocks:
    sharded serving (37), sharded training, TP, FSDP and EP (38), the
    pipelined loss and ring attention (39), each against the single
    process on the card.

Processes: phases 3 and 16 run alone on the card (the kernels' times).
Phases 27, 28, 30-32 and 36 run in a second process (``--side``) started
after phase 3, and phases 37-39's two ranks start after phase 34; both run
beside this process's phases, whose rates and seconds therefore share the
card and the host's cores with them.

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
K1's backward beside SDPA's (all by CUDA graph replay; K1's forward and
backward also at the vision trainer's [64,197,12,64]), and K6's forward
beside the unfused library composition
(``F.layer_norm`` + ``F.linear`` + SDPA + ``F.linear`` + add); then K5
(int4 decode matmul; x in float32 and bf16, limits 1e-5 and 8e-3 of the
reference's max |value|; two calls bitwise equal) and K3 and K4 (paged
decode, each row split over a cluster of CTAs; K4 at pages_per_block 1, 3,
8; two calls bitwise equal, rows of length 0 exactly 0) to their plain
versions, and times each
kernel's path-shape case in bf16 beside its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, whichever is larger) and one PyTorch library
call computing the same function (SDPA, or its backward;
``torch._weight_int4pack_mm`` for K5 and K5v3a; none for K3, K4 and
K5v3b).  It also holds K5v3a and K5v3b (x float32 and bf16, rows 1, 8,
16, 17 and 64, gemma3-1b's seven projections; K5's limits against their
plain versions on CPU copies; two calls bitwise equal; one device kernel a
call, counted by ``torch.profiler``) and times them cold at the seven
projections beside K5, and holds K2, K2-bd and K6 at head dims 16 (vit-t-8
widths, T 17) and 32 in fp32 and bf16.  K1's forward is held at the ViT,
LM prefill, LM training and dense decode shapes (one query against a
269-slot cache under the float32 cache bias), the chunked front's chunk
(64 queries of one row against its 273-slot cache under the chunk's bias)
and the beam decode step (32 rows), a window, a bias, Tq < Tk and head
dim 128; K2's at the CLIP shapes and T 15 and 65 among others.
K5, K3, K4, K6's forward (beside the unfused composition) and the K1 and K2
forwards (with their SDPA calls) are timed by CUDA graph replay (device
time without the wrapper's host work), K5, K5v3a and K5v3b at each of
gemma3-1b's seven decode projections with their weights cycled past the L2
cache, beside ``torch._weight_int4pack_mm`` on the same cycled weights;
phase 3 also holds K1's forward, K2, K5, K5v3a, K5v3b, K3 and K4 on
strided and offset views of their operands (the wrappers copy them; K3 and K4 their q, page table and lens)
and times K3 and K4 side by side, warm and cold (pools cycled past the L2),
at the gemma3 window-512 row, the serving shape (8 rows of 262-269 tokens,
windows 512 and global) and 4 kv heads at ~1k context, pages of 16 and 64,
printing each call's split S (its cluster size).  ``python3 chip_smoke.py
--profile`` builds the kernels and profiles the full CLIP train step
instead, on the default path and on the kernel variants (``torch.profiler``:
idle share, aten ops and device time by kernel).  ``python3 chip_smoke.py
--time-forwards ROOT`` builds the kernels of the checkout at ROOT and times
only the K1 and K2 forwards at their path shapes beside SDPA, and
``--time-variants ROOT`` K2-bd's forward and backward (beside K2) at both
CLIP shapes, K6's forward (beside the unfused composition) and backward at
the vision shape, K1's backward at the LM training shape beside SDPA, and
K5, K5v3a and K5v3b at the seven gemma3-1b projections, cold, beside
``torch._weight_int4pack_mm`` (with a digest of K5's outputs on phase 3's
cases), and K3 and K4 at phase 3's timed shapes (an A/B between two
checkouts runs either on each in turns).  ``python3
chip_smoke.py --profile-mllm [ROOT]`` profiles the full MLLM micro-step
with the port package of ROOT (default this checkout): device busy, idle
share, aten ops and K1's forward, dQ and dK/dV in ms a micro-step;
``--profile-vision`` one vision-trainer micro-step at its slice's shape
(batch 64, dropout 0.1) the same way, ``--profile-moe`` one step of phase
35's E=4 bench cell in each dispatch; ``--profile-decode [ROOT]`` the full
MLLM's paged decode step at batch 8
(prompts of 262-269 tokens, a fixed batch): device busy, idle share and
K3's ms a step (K4's under ``MCL_PAGED_KERNEL=2``; with ``--int8-kv``
over int8 pools, K1's after the gather and dequantize).

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

PROCESS_T0 = time.perf_counter()  # a rank of phases 37-39 counts its start-up from here
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max abs error vs the plain version, unit-scale inputs
D16 = "vit-t-8 head dim 16"  # K2, K2-bd and K6 at the tests' preset: hidden 64, 4 heads, T 17
D32 = "head dim 32"  # the third built head dim (no preset has it): hidden 128, 4 heads, T 17
LM_TRAIN_T = 197 + 24  # vision tokens + the collator's pad_to for 12_colors_3k
DECODE_CACHE = 269  # the answer CLI's dense cache: prompt (vision tokens + question) + 8 tokens
CHUNK_CACHE = 197 + 64 + 8 + 4  # a chunked front slot's cache: prompt_t + 8 tokens + a step
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
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores


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
              "bwd_dq_tc_kernel", "bwd_dkv_tc_kernel", "int4_tc_kernel",
              "k6_qkv_attn_tc_kernel", "k6_out_proj_tc_kernel", "v3a_tc_kernel",
              "v3b_tc_kernel")  # the tensor-core kernels
# K1 forward at D 64/128/256; K2 forward and K2-bd forward at D 16/32/64; the
# shared backward pair (dQ, dK/dV) at D 16/32/64 in five configurations: K6's
# and K2's four (causal or not x kv_mask or not); K1's backward pair
# (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel) at D 64/128/256; K5 at
# its 9 (row tiles, stripe width) pairs (1 x 8/16/32/64, 2 x 8/16/32, 4 x
# 8/16); K6's bf16 forward: the qkv-attention kernel at D 16/32/64 x chunk
# depth 32/64, and the output projection; K5v3a and K5v3b at K5's 9 pairs each
TC_INSTANTIATIONS = 3 + 3 + 3 + 2 * 3 * 5 + 2 * 3 + 9 + 6 + 1 + 2 * 9
# K3 and K4 (CUDA-core kernels, split over clusters): float32 and bf16 at D
# 64/128/256, each for groups of up to 4 and up to 8 q heads
PAGED_KERNELS = ("paged_decode_kernel", "paged_mp_kernel")
PAGED_INSTANTIATIONS = 2 * 2 * 3 * 2


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
    spills = spill_stores(info["log"])
    for what, names, count in (("tensor-core kernels", TC_KERNELS, TC_INSTANTIATIONS),
                               ("paged decode kernels", PAGED_KERNELS, PAGED_INSTANTIATIONS)):
        found = {n: b for n, b in spills.items() if any(k in n for k in names)}
        print(f"[build] {what}: {len(found)} instantiations, spill stores "
              f"{sorted(set(found.values()))} bytes", flush=True)
        if len(found) != count or any(found.values()):
            fail(f"{what}: expected {count} instantiations without spills, got {found}")


def _flash_cases(torch, gen, dev):
    """(name, q, k, v, kwargs) at the K1 forward's path shapes: the ViT, the
    vision classifier's batch of 64, LM prefill (serving, answering), the LM
    at the training batch, the answer
    CLI's dense decode step (one query a row against the whole cache under
    the float32 cache bias, a few slots masked), the chunked front's chunk,
    the beam decode step (batch 8 x 4 beams), then a window, a float32
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
    # the chunked front's third 64-token chunk against its slot's cache:
    # the committed prefix [0, 128), the chunk causally, nothing past it
    slots = torch.arange(CHUNK_CACHE, device=dev)
    qpos = 128 + torch.arange(64, device=dev)[:, None]
    chunk_bias = torch.where((slots < 128) | ((slots >= 128) & (slots <= qpos)), 0.0, NEG)
    chunk_bias = chunk_bias[None, None]
    beam_bias = torch.zeros(4 * b, 1, 1, s, device=dev)
    beam_bias[:, :, :, 262:] = NEG  # beams of prompts of 262 tokens, one token decoded
    return [
        ("vit [8,197,12,64]", randn(b, 197, 12, 64), randn(b, 197, 12, 64),
         randn(b, 197, 12, 64), {}),
        (VIT_CLS, randn(64, 197, 12, 64), randn(64, 197, 12, 64), randn(64, 197, 12, 64), {}),
        ("lm [8,261,4/1,256] causal+kv_lens", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), lm),
        (f"lm train [2,{t},4/1,256] causal+kv_lens", randn(2, t, 4, 256), randn(2, t, 1, 256),
         randn(2, t, 1, 256), train),
        (f"decode [8,1,4/1,256] vs cache {s} + bias [8,1,1,{s}]", randn(b, 1, 4, 256),
         randn(b, s, 1, 256), randn(b, s, 1, 256), dict(scale=1 / 16, bias=cache_bias)),
        (f"chunk [1,64,4/1,256] vs cache {CHUNK_CACHE} + bias [1,1,64,{CHUNK_CACHE}]",
         randn(1, 64, 4, 256), randn(1, CHUNK_CACHE, 1, 256), randn(1, CHUNK_CACHE, 1, 256),
         dict(scale=1 / 16, bias=chunk_bias)),
        (f"beam decode [32,1,4/1,256] vs cache {s} + bias [32,1,1,{s}]",
         randn(4 * b, 1, 4, 256), randn(4 * b, s, 1, 256), randn(4 * b, s, 1, 256),
         dict(scale=1 / 16, bias=beam_bias)),
        ("lm window 64", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, window=64)),
        ("lm + bias [8,1,261,261]", randn(b, 261, 4, 256), randn(b, 261, 1, 256),
         randn(b, 261, 1, 256), dict(lm, bias=randn(b, 1, 261, 261))),
        ("Tq 37 < Tk 100 causal [2,37,4/1,256]", randn(2, 37, 4, 256), randn(2, 100, 1, 256),
         randn(2, 100, 1, 256), dict(scale=1 / 16, causal=True)),
        ("d 128 [2,100,8/8,128] causal", randn(2, 100, 8, 128), randn(2, 100, 8, 128),
         randn(2, 100, 8, 128), dict(causal=True)),
    ]


K1_TIMED = ("vit [", "lm [", "lm train [", "decode [", "chunk [",
            "beam decode [")  # K1 forward cases on a main path
VIT_CLS = "vit [64,197,12,64] classifier"  # the vision trainer's batch (K1 forward and backward)


def _flash_bwd_cases(torch, gen, dev):
    """(name, q, k, v, kwargs, bias needs grad) at the training path's K1
    shapes: the LM at batch 2 (4q/1kv heads of 256, causal + kv_lens, scale
    1/16), with a window, with a float32 bias that needs a gradient, and
    the ViT (12 heads of 64, no mask) at batch 2 and at the vision
    trainer's batch of 64; then one case at head dim 128 and a
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
        (VIT_CLS, randn(64, 197, 12, 64), randn(64, 197, 12, 64), randn(64, 197, 12, 64), {},
         False),
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
    two bf16 calls bitwise equal.  At the LM training shape and the vision
    trainer's in bf16 the kernels and SDPA's backward are timed by CUDA
    graph replay, the plain backward by the event loop (the JSON line keeps
    the LM's)."""
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
            if name == VIT_CLS and dtype is torch.bfloat16:
                time_k1_bwd(torch, fa, name, qd, kd, vd, dod, kw, bias_grad)
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
    dqkv <= 2e-2 of the reference's max |value| (lse <= 1e-4); kernel and
    plain times at the model shapes (CLIP's two, ViT-B/16, ViT-L/14; the
    edge-case shapes are held, not timed), and at the path's shapes in
    bf16 beside the bound and SDPA (each kernel and SDPA call by CUDA
    graph replay, the plain versions by the event loop)."""
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
            times = "times taken at the model shapes only"
            if on_path or name.startswith(("vit-b", "vit-l")):
                # the forward as a training step runs it: lse only where the backward reads it
                ms = graph_time_ms(lambda: ac.attention_core_fwd(
                    qkv, heads, t_real, causal, kvm, with_lse=dtype is torch.float32))
                bwd_ms = cuda_time_ms(bwd)
                plain_ms = cuda_time_ms(lambda: ac.attention_core_reference(qkv, heads, t_real,
                                                                            causal, kvm))
                plain_bwd_ms = cuda_time_ms(lambda: ac.attention_core_backward_reference(
                    qkv, da, heads, t_real, causal, kvm))
                times = (f"fwd kernel {ms:.4f} ms plain {plain_ms:.4f} ms; bwd kernel "
                         f"{bwd_ms:.4f} ms plain {plain_bwd_ms:.4f} ms")
            print(f"[kernels] K2 {name} {tag}: max_abs_err out {err:.3e} lse {err_lse:.3e} "
                  f"dqkv {err_d:.3e}; {times}", flush=True)
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
            f = time_k6f(torch, fb, name, x, params, heads, t_real)
            r = time_k6b(torch, ac, fb, name, qkv, da, heads, t_real)
            kf.update(ms=f["ms"], plain_ms=f["plain_ms"], library_ms=f["library_ms"],
                      **f["bound"])
            kb.update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["sdpa_ms"], **r["bound"])
    _phase_fused_grads(torch, gen, dev)


def time_k6f(torch, fb, name: str, x, params, heads: int, t_real: int,
             plain: bool = True) -> dict:
    """K6's forward kernels at one shape, bf16 (the parameters cast first,
    as the unfused composition has them), and the unfused library
    composition, each by CUDA graph replay, beside the plain version (event
    loop) and the bound (x, the weights, y and attn moved; the projections'
    and this run's query-key pairs' operations).  Prints and returns them."""
    b, t, width = x.shape
    cast = [a.to(x.dtype) for a in params]
    hd = cast[4].shape[0]
    y, attn = fb.fused_attention_fwd(x, *cast, heads, t_real)
    pairs = b * heads * t * min(t, t_real)
    r = {"ms": graph_time_ms(lambda: fb.fused_attention_fwd(x, *cast, heads, t_real)),
         "library_ms": graph_time_ms(_unfused_sublayer(torch, x, params, heads)),
         "bound": bound(nbytes(x, *cast, y, attn), 2 * b * t * width * 3 * hd
                        + 2 * b * t * hd * width + 4 * (hd // heads) * pairs),
         "plain_ms": None}
    if plain:
        r["plain_ms"] = cuda_time_ms(lambda: fb.fused_attention_reference(x, *cast, heads,
                                                                          t_real), iters=10)
    print(f"[kernels] K6 {name} bf16: fwd kernels {r['ms']:.4f} ms, unfused library "
          f"{r['library_ms']:.4f} ms (graph replay)"
          + (f", plain {r['plain_ms']:.4f} ms" if plain else "")
          + f", bound {r['bound']['bound_ms']:.5f} ms ({r['bound']['bound_by']})", flush=True)
    return r


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


def _len0_max(out, lens) -> float:
    """Max |value| of the output rows of length 0 (0.0 where there are none)."""
    rows = out[lens.long() == 0]
    return rows.abs().max().item() if rows.numel() else 0.0


def _paged_shape(args) -> tuple:
    """(batch, kv heads, page size, table columns) of paged decode operands."""
    q, pool_k, _, pt, _ = args
    return q.shape[0], pool_k.shape[1], pool_k.shape[2], pt.shape[1]


def _paged_cases(torch, gen, dev):
    """(name, q, pool_k, pool_v, page_table, lens, window): gemma3-1b shapes
    (hk 1, group 4, d 256, page 16), 8 ragged rows incl. one of length 0,
    then one case at the kernel's other head dim, group and page size, the
    serving path's decode (8 rows of 262-269 tokens in 17 pages of 16) and
    4 kv heads at ~1k context in pages of 64."""
    gemma = _paged_case(torch, gen, dev, 4, 1, 256, 16, 40, GEMMA_LENS)
    other = _paged_case(torch, gen, dev, 4, 2, 128, 8, 40, [0, 7, 33, 300])
    serving = _paged_case(torch, gen, dev, 4, 1, 256, 16, 17, SERVING_LENS)
    long_ctx = _paged_case(torch, gen, dev, 16, 4, 256, 64, 17, [0, 1000, 1024, 700, 1, 63, 64, 65])
    return ([(f"gemma3 decode window {w}", *gemma, w) for w in (-1, 512, 20)]
            + [("hk 2, group 2, d 128, page 8, window 97", *other, 97),
               ("serving decode window 512", *serving, 512),
               ("hk 4, group 4, d 256, page 64, ~1k context", *long_ctx, -1)])


GEMMA_LENS = [0, 1, 15, 16, 17, 261, 530, 640]  # ragged, a row of length 0
SERVING_LENS = [262, 263, 264, 265, 266, 267, 268, 269]  # prompts of 197 vision + 65-72 tokens
LONG_LENS = [1024, 1017, 1000, 990, 960, 1024, 1003, 998]


def _paged_timed_cases(torch, gen, dev):
    """(name, (q, pool_k, pool_v, page_table, lens), window) of the timed
    paged decode shapes: gemma3-1b (hk 1, group 4, d 256) at phase 3's
    ragged rows, window 512; the serving path's decode (8 rows of 262-269
    tokens in 17 pages of 16, the engine's table), window 512 and global;
    the ~1k-context case (hk 4, group 4, d 256), pages of 16 and 64."""
    gemma = _paged_case(torch, gen, dev, 4, 1, 256, 16, 40, GEMMA_LENS)
    serving = _paged_case(torch, gen, dev, 4, 1, 256, 16, 17, SERVING_LENS)
    cases = [("gemma3 decode window 512", gemma, 512), ("serving window 512", serving, 512),
             ("serving global", serving, -1)]
    for ps in (16, 64):
        cases.append((f"hk 4 ~1k context page {ps}",
                      _paged_case(torch, gen, dev, 16, 4, 256, ps, -(-1024 // ps), LONG_LENS), -1))
    return cases


def _attended_tokens(lens, window: int, limit: int) -> int:
    """Tokens the rows attend: [max(0, len - window), min(len, limit))."""
    end = lens.long().clamp(max=limit)
    start = (lens.long() - window).clamp(min=0) if window >= 0 else 0 * end
    return int((end - start).clamp(min=0).sum())


def time_paged(torch, gen, dev, plain: bool = False) -> dict:
    """K3 and K4 in bf16 at each of ``_paged_timed_cases``, by CUDA graph
    replay, warm (one set of pools) and cold (sets cycled past the 50 MB L2,
    as a decode step of 26 layers finds them), beside the bound (bytes) and,
    with ``plain``, the plain versions (event loop, warm).  Prints each with
    the split S (the cluster size; "n/a" for a checkout without the split);
    returns {kernel: {case: {"ms", "warm_ms", "plain_ms", "bound", "splits"}}}."""
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as mp

    kernels = {"K3": (pk.paged_decode_attention, pk.paged_decode_attention_reference),
               "K4": (mp.paged_decode_attention_mp, mp.paged_decode_attention_mp_reference)}
    split_for = getattr(pk, "split_for", None)
    times = {k: {} for k in kernels}
    for name, (q, pool_k, pool_v, pt, lens), w in _paged_timed_cases(torch, gen, dev):
        b, _, hq, d = q.shape
        _, hk, ps, _ = pool_k.shape
        np_ = pt.shape[1]
        first = tuple(t.to(torch.bfloat16) for t in (q, pool_k, pool_v))
        sets = [first] + [tuple(torch.randn(t.shape, generator=gen, device=dev).to(torch.bfloat16)
                                for t in (q, pool_k, pool_v))
                          for _ in range(max(3, int(COLD_BYTES // nbytes(*first))))]
        tokens = _attended_tokens(lens, w, np_ * ps)
        bd = bound(2 * nbytes(first[0]) + nbytes(pt, lens) + 2 * tokens * hk * d * 2,
                   4 * d * hq * tokens)
        splits = split_for(b, hk, ps, np_, w) if split_for else None
        for kname, (fn, ref) in kernels.items():
            def call(qq, kk, vv, fn=fn):
                return fn(qq, kk, vv, pt, lens, scale=1 / 16, window=w)
            warm = graph_time_ms(lambda: call(*first))
            cold = graph_time_ms(_cycled(call, sets), iters=len(sets))
            plain_ms = (cuda_time_ms(lambda: ref(*first, pt, lens, scale=1 / 16, window=w))
                        if plain else None)
            times[kname][name] = {"ms": cold, "warm_ms": warm, "plain_ms": plain_ms,
                                  "bound": bd, "splits": splits}
            print(f"[kernels] {kname} {name} [{b},1,{hq},{d}] vs pools [P,{hk},{ps},{d}] bf16, "
                  f"{tokens} tokens, S {splits if splits else 'n/a'} (clusters of "
                  f"{splits if splits else 'n/a'} CTAs, grid {splits or 1}x{b}x{hk}): cold "
                  f"{cold:.5f} ms, warm {warm:.5f} ms (graph replay, {len(sets)} pool sets)"
                  + (f", plain {plain_ms:.4f} ms" if plain else "")
                  + f", bound {bd['bound_ms']:.5f} ms ({bd['bound_by']})", flush=True)
    return times


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


def _int4pack_order(torch, xb, packed, scale):
    """The nibble order (high first or not) of ``_int4pack`` whose
    ``torch._weight_int4pack_mm`` reproduces the plain version, and its max
    abs difference from it; None without the library call."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    if not hasattr(torch, "_weight_int4pack_mm"):
        return None
    want = i4.int4_matmul_reference(xb.float(), packed, scale)
    errs = {}
    for high_first in (True, False):
        w4, sz = _int4pack(torch, packed, scale, high_first=high_first)
        errs[high_first] = (torch._weight_int4pack_mm(xb, w4, 64, sz).float()
                            - want).abs().max().item()
    order = min(errs, key=errs.get)
    return order, errs[order]


# the int4 decode products timed side by side: label -> (wrapper, plain version, report key)
INT4_KERNELS = ("K5", "K5v3a", "K5v3b")


def _int4_fns(i4) -> dict:
    return {"K5": (i4.int4_matmul, i4.int4_matmul_reference, "int4_matmul"),
            "K5v3a": (i4.v3a_matmul, i4.v3a_matmul_reference, "int4_matmul_v3a"),
            "K5v3b": (i4.v3b_matmul, i4.v3b_matmul_reference, "int4_matmul_v3b")}


def time_int4(torch, gen, dev, plain: bool = False) -> dict:
    """K5, K5v3a and K5v3b at each of gemma3-1b's seven decode projections
    at batch 8, bf16, weights cold (cycled past the L2, as a decode step
    finds them), by CUDA graph replay, in turns on the same cycled weights,
    beside ``torch._weight_int4pack_mm`` (the library call of K5 and K5v3a;
    K5v3b's int8 activations make it another function than every library
    product), each kernel's bound (bytes; operations at the int8 rate for
    K5v3b) and with ``plain`` its plain version (event loop).  Prints each
    and the decode step's sums (x 26 layers); returns {label: {projection:
    {"ms", "library_ms", "plain_ms", "bound"}}}."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    fns = _int4_fns(i4)
    rows, times, order = 8, {k: {} for k in INT4_KERNELS}, None
    for proj, d_in, d_out in GEMMA_PROJECTIONS:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        xb = torch.randn(rows, d_in, generator=gen, device=dev).to(torch.bfloat16)
        sets = _int4_sets(torch, gen, dev, d_in, d_out,
                          max(16, int(COLD_BYTES // nbytes(packed, scale))))
        ms = {k: graph_time_ms(_cycled(lambda p, s, fn=fns[k][0]: fn(xb, p, s), sets),
                               iters=len(sets)) for k in INT4_KERNELS}
        lib_ms = None
        if order is None:
            order = _int4pack_order(torch, xb, *sets[0])
            if order is not None:
                print(f"[kernels] K5 library torch._weight_int4pack_mm: max abs diff from the "
                      f"plain version {order[1]:.3e} (nibble order "
                      f"{'high' if order[0] else 'low'} first)", flush=True)
        if order is not None:
            try:
                packs = [_int4pack(torch, p, s, high_first=order[0]) for p, s in sets]
                lib_ms = graph_time_ms(
                    _cycled(lambda w, z: torch._weight_int4pack_mm(xb, w, 64, z), packs),
                    iters=len(packs))
            except RuntimeError as e:  # a shape the library call does not take
                print(f"[kernels] int4 library at {proj}: {str(e).splitlines()[0]}", flush=True)
        moved, flops = nbytes(packed, scale, xb) + 2 * rows * d_out, 2 * rows * d_in * d_out
        for k in INT4_KERNELS:
            b = bound(moved, flops, INT8_OPS_PER_S if k == "K5v3b" else BF16_FLOPS_PER_S)
            ref = fns[k][1]
            plain_ms = cuda_time_ms(lambda: ref(xb, packed, scale)) if plain else None
            times[k][proj] = {"ms": ms[k], "library_ms": None if k == "K5v3b" else lib_ms,
                              "plain_ms": plain_ms, "bound": b}
        print(f"[kernels] int4 {proj} [8,{d_in}]x[{d_in},{d_out}] bf16 cold (graph replay): "
              + ", ".join(f"{k} {ms[k]:.5f} ms" for k in INT4_KERNELS)
              + ", torch._weight_int4pack_mm " + (f"{lib_ms:.5f} ms" if lib_ms is not None
                                                  else "n/a")
              + (", plain " + " / ".join(f"{times[k][proj]['plain_ms']:.4f}"
                                         for k in INT4_KERNELS) + " ms" if plain else "")
              + f"; bound {times['K5'][proj]['bound']['bound_ms']:.5f} ms (bytes)", flush=True)
    lib = [r["library_ms"] for r in times["K5"].values()]
    print("[kernels] int4 over one decode step of gemma3-1b (7 projections x 26 layers, cold): "
          + ", ".join(f"{k} {26 * sum(r['ms'] for r in times[k].values()):.4f} ms"
                      for k in INT4_KERNELS)
          + "; torch._weight_int4pack_mm "
          + (f"{26 * sum(lib):.4f} ms" if None not in lib else "n/a") + "; bound "
          f"{26 * sum(r['bound']['bound_ms'] for r in times['K5'].values()):.4f} ms"
          + ("; plain (event loops, summed) " + ", ".join(
              f"{k} {26 * sum(r['plain_ms'] for r in times[k].values()):.3f} ms"
              for k in INT4_KERNELS) if plain else ""), flush=True)
    return times


def _phase_int4(torch, gen, dev, report: dict) -> None:
    """K5 against its plain version on the same inputs at the decode path's
    shapes, x in float32 and bf16, two calls bitwise equal; then up_proj
    timed beside the bf16 product of the dequantized weight."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    k5 = report.setdefault("int4_matmul", {"max_abs_err": 0.0})
    for name, rows, d_in, d_out in K5_CASES:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        x = torch.randn(rows, d_in, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            out = i4.int4_matmul(xd, packed, scale)
            again = i4.int4_matmul(xd, packed, scale)
            ref = i4.int4_matmul_reference(xd.float(), packed, scale)
            torch.cuda.synchronize()
            tag = str(dtype).replace("torch.", "")
            err = (out.float() - ref).abs().max().item()
            limit = K5_TOL[tag] * ref.abs().max().item()
            same = torch.equal(out, again)
            print(f"[kernels] K5 {name} {tag}: max_abs_err {err:.3e} (limit {limit:.3e}), "
                  f"plan {i4.k5_plan(rows, d_in, d_out)}, two calls bitwise equal {same}",
                  flush=True)
            if not (err <= limit and same):
                fail(f"K5 {name} {tag}: max abs err {err} > {limit} or two calls differ")
            k5["max_abs_err"] = max(k5["max_abs_err"], err)
    rows, d_in, d_out = 8, 1152, 6912  # up_proj: the kernels line's shape
    xb = torch.randn(rows, d_in, generator=gen, device=dev).to(torch.bfloat16)
    dense = [i4.dequantize_int4(p, s).to(torch.bfloat16)
             for p, s in _int4_sets(torch, gen, dev, d_in, d_out, 8)]
    dense_ms = graph_time_ms(_cycled(lambda w: xb @ w, [(w,) for w in dense]), iters=8)
    del dense
    print(f"[kernels] K5 up_proj bf16: the bf16 matmul of the dequantized weight (what bf16 "
          f"weights pay) {dense_ms:.5f} ms cold", flush=True)


def k5_digests(torch) -> str:
    """sha256 over K5's outputs on phase 3's cases (x float32 and bf16, from
    a fixed seed): equal digests from two checkouts on one card mean K5
    computes the same bits in both."""
    import hashlib

    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = hashlib.sha256()
    for _, rows, d_in, d_out in K5_CASES:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        x = torch.randn(rows, d_in, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            h.update(i4.int4_matmul(x.to(dtype), packed, scale).float().cpu().numpy().tobytes())
    return h.hexdigest()


# every shape the A/B entry point gives the variants, at its batch 8, at
# rows 1, 16 and 64 (each row tile count the kernels are built for) and at
# 17 (a second, ragged tile)
V3_CASES = [(f"gemma3 {n} rows {r}", r, i, o) for n, i, o in GEMMA_PROJECTIONS
            for r in (1, 8, 16, 17, 64)]


def _int4_reference(torch, ref_fn, x, packed, scale):
    """An int4 kernel's plain version on CPU copies, moved to x's device: K5v3b's
    quantization divides by 127 there (a division by a constant on the card
    multiplies by its reciprocal, which moves some scales by one ulp and
    then some xq by one), as the kernel does."""
    return ref_fn(x.float().cpu(), packed.cpu(), scale.cpu()).to(x.device)


def _device_kernels(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (``torch.profiler``
    tracing the card only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _phase_int4_v3(torch, gen, dev, report: dict) -> None:
    """K5v3a and K5v3b against their plain versions on the same inputs
    (gemma3-1b's seven projections, rows 1, 8, 16, 17 and 64, x in float32
    and bf16; K5's limits, 1e-5 and 8e-3 of the reference's max |value|),
    two calls bitwise equal, each call's plan printed; one call of each,
    traced, must run exactly one device kernel."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    fns = _int4_fns(i4)
    for label in ("K5v3a", "K5v3b"):
        report.setdefault(fns[label][2], {"max_abs_err": 0.0})
    for name, rows, d_in, d_out in V3_CASES:
        (packed, scale), = _int4_sets(torch, gen, dev, d_in, d_out, 1)
        x = torch.randn(rows, d_in, generator=gen, device=dev)
        for label in ("K5v3a", "K5v3b"):
            fn, ref_fn, key = fns[label]
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                out = fn(xd, packed, scale)
                again = fn(xd, packed, scale)
                ref = _int4_reference(torch, ref_fn, xd, packed, scale)
                torch.cuda.synchronize()
                tag = str(dtype).replace("torch.", "")
                err = (out.float() - ref.float()).abs().max().item()
                limit = K5_TOL[tag] * ref.float().abs().max().item()
                same = torch.equal(out, again) and out.dtype == dtype
                print(f"[kernels] {label} {name} {tag}: max_abs_err {err:.3e} (limit "
                      f"{limit:.3e}), plan {i4.v3_plan(rows, d_in, d_out)}, two calls bitwise "
                      f"equal {same}", flush=True)
                if not (err <= limit and same):
                    fail(f"{label} {name} {tag}: max abs err {err} > {limit}, or two calls "
                         f"differ or are not {dtype}")
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
    (packed, scale), = _int4_sets(torch, gen, dev, 1152, 6912, 1)
    xb = torch.randn(8, 1152, generator=gen, device=dev).to(torch.bfloat16)
    for label in ("K5v3a", "K5v3b"):
        names = _device_kernels(torch, lambda fn=fns[label][0]: fn(xb, packed, scale))
        print(f"[kernels] {label} up_proj bf16: device kernels of one call {names}", flush=True)
        if len(names) != 1:
            fail(f"{label}: one call ran {len(names)} device kernels, not 1: {names}")


def _phase_int4_times(torch, gen, dev, report: dict) -> None:
    """K5, K5v3a and K5v3b timed cold at the seven projections side by side
    (``time_int4``); the kernels line takes up_proj."""
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4

    times = time_int4(torch, gen, dev, plain=True)
    for label, (_, _, key) in _int4_fns(i4).items():
        up = times[label]["up_proj"]
        report[key].update(ms=up["ms"], plain_ms=up["plain_ms"], library_ms=up["library_ms"],
                           **up["bound"])


K4_PPB = (1, 3, 8)


def _phase_paged_mp(torch, gen, dev, report: dict) -> None:
    """K4 against its plain version (the same blocks) on K3's cases,
    pages_per_block 1, 3 and 8 (clamped on the card), fp32 and bf16; the
    length-0 row exactly 0, two calls bitwise equal.  Then K3 and K4 timed
    side by side (``time_paged``): the JSON line takes the gemma3 window-512
    case, cold."""
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as mp

    k4 = report.setdefault("paged_decode_attention_mp", {"max_abs_err": 0.0})
    for name, q, pool_k, pool_v, pt, lens, w in _paged_cases(torch, gen, dev):
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, pool_k, pool_v))
            args = (qd, kd, vd, pt, lens)
            tag = str(dtype).replace("torch.", "")
            for ppb in K4_PPB:
                out = mp.paged_decode_attention_mp(*args, scale=1 / 16, window=w,
                                                   pages_per_block=ppb)
                again = mp.paged_decode_attention_mp(*args, scale=1 / 16, window=w,
                                                     pages_per_block=ppb)
                ref = mp.paged_decode_attention_mp_reference(
                    qd.float(), kd.float(), vd.float(), pt, lens, scale=1 / 16, window=w,
                    pages_per_block=ppb)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                zero_row = _len0_max(out, lens)
                same = torch.equal(out, again)
                sched = mp.mp_schedule(kd.shape[2], kd.shape[3], dtype,
                                       qd.shape[2] // kd.shape[1], ppb, pt.shape[1])
                print(f"[kernels] K4 {name} {tag} pages_per_block {ppb} (card: {sched[1]} "
                      f"segments of {sched[0]} tokens, S {pk.split_for(*_paged_shape(args), w)}): "
                      f"max_abs_err {err:.3e} len-0 row {zero_row:.1e}, two calls bitwise equal "
                      f"{same}", flush=True)
                if not (err <= TOL[tag] and zero_row == 0.0 and same):
                    fail(f"K4 {name} {tag} ppb {ppb}: max abs err {err}, len-0 row {zero_row}, "
                         f"bitwise equal {same}")
                k4["max_abs_err"] = max(k4["max_abs_err"], err)
    times = time_paged(torch, gen, dev, plain=True)
    for kname, key in (("K3", "paged_decode_attention"), ("K4", "paged_decode_attention_mp")):
        r = times[kname]["gemma3 decode window 512"]  # the JSON line's numbers
        report[key].update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=None, **r["bound"])
    for name in times["K3"]:
        print(f"[kernels] K3 vs K4 {name}, cold: K3 {times['K3'][name]['ms']:.5f} ms, K4 "
              f"{times['K4'][name]['ms']:.5f} ms (pages_per_block 8)", flush=True)


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
    sample), K6's forward (beside the unfused library composition) and
    backward at the vision shape, K1's backward at the LM training shape,
    K5, K5v3a and K5v3b at gemma3-1b's seven decode projections, cold (beside
    ``torch._weight_int4pack_mm``; then a digest of K5's outputs on phase
    3's cases, equal between two checkouts whose K5 gives the same bits),
    and K3 and K4 at the gemma3 window-512,
    serving and ~1k-context shapes, warm and cold (``time_paged``), bf16,
    each by CUDA graph replay beside
    its library call (SDPA for the attention kernels), from the
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
        time_k6f(torch, fb, name, x32.to(bf16), params, heads, t_real, plain=False)
        qkv = fb.ln_qkv(x32.to(bf16), *params[:4], 1e-12)[0]
        da = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, generator=gen,
                         device=dev).to(bf16)
        time_k6b(torch, ac, fb, name, qkv, da, heads, t_real, plain=False)
        for name, q, k, v, kw, _ in _flash_bwd_cases(torch, gen, dev):
            if name.startswith("lm ["):
                do = torch.randn(q.shape, generator=gen, device=dev)
                time_k1_bwd(torch, fa, name, *(x.to(bf16) for x in (q, k, v, do)), kw)
        time_int4(torch, gen, dev)
        print(f"[ab] K5 digest over phase 3's cases: {k5_digests(torch)}", flush=True)
        time_paged(torch, gen, dev)


def _layout_views(torch, t) -> dict:
    """The values of ``t`` as a strided view (every other element of a last
    dim twice as long: not contiguous) and as an offset view (one element
    into a flat buffer: not 16-byte aligned), the layouts the JAX functions
    take."""
    wide = torch.zeros(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype, device=t.device)
    wide[..., ::2] = t
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    views = {"strided": wide[..., ::2], "offset": flat[1:].view(t.shape)}
    assert not views["strided"].is_contiguous() and views["offset"].data_ptr() % 16
    return views


def _phase_layouts(torch, gen, dev) -> None:
    """K1's forward, K2, K5, K5v3a and K5v3b on a strided and an offset view
    of their operands (copied by the wrappers, not refused) against their
    plain versions on the same values: K1 within TOL abs, K2 within TOL
    (bf16: of the reference's max), the int4 kernels within K5_TOL; then K3
    and K4 on a strided and an offset q, page table and lens (the pools stay
    as the cache holds them), within TOL abs; each wrapper must have
    launched its kernel."""
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops import int4 as i4
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as mp

    q, k, v = (torch.randn(2, 37, 4, 64, generator=gen, device=dev) for _ in range(3))
    qkv = torch.randn(4, 50, 3 * 4 * 64, generator=gen, device=dev)
    x = torch.randn(8, 1152, generator=gen, device=dev)
    (packed, scale), = _int4_sets(torch, gen, dev, 1152, 1024, 1)
    int4_fns = _int4_fns(i4)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        qd, kd, vd, qkvd, xd = (a.to(dtype) for a in (q, k, v, qkv, x))
        ref1 = fa.flash_attention_reference(qd.float(), kd.float(), vd.float(), causal=True)
        ref2 = ac.attention_core_reference(qkvd.float(), 4, 41)
        refs4 = [_int4_reference(torch, int4_fns[label][1], xd, packed, scale).float()
                 for label in INT4_KERNELS]
        lims4 = [K5_TOL[tag] * r.abs().max().item() for r in refs4]
        lim2 = TOL[tag] * (1.0 if dtype is torch.float32 else ref2.abs().max().item())
        for kind in ("strided", "offset"):
            wrappers = [fa.flash_attention, ac.attention_core_fwd,
                        *(int4_fns[label][0] for label in INT4_KERNELS)]
            n = [w.launches for w in wrappers]
            views = [_layout_views(torch, a)[kind] for a in (qd, kd, vd)]
            out1 = fa.flash_attention(*views, causal=True)
            out2 = ac.attention_core(_layout_views(torch, qkvd)[kind], 4, 41, block_diag=False)
            int4_views = [_layout_views(torch, a)[kind] for a in (xd, packed, scale)]
            outs4 = [int4_fns[label][0](*int4_views) for label in INT4_KERNELS]
            torch.cuda.synchronize()
            errs = [(o.float() - r).abs().max().item()
                    for o, r in zip((out1, out2, *outs4), (ref1, ref2, *refs4))]
            launched = tuple(w.launches - c for w, c in zip(wrappers, n))
            print(f"[kernels] {kind} views {tag}: K1 fwd {errs[0]:.3e}, K2 {errs[1]:.3e} "
                  f"(limit {lim2:.3e}), "
                  + ", ".join(f"{label} {e:.3e} (limit {lim:.3e})"
                              for label, e, lim in zip(INT4_KERNELS, errs[2:], lims4))
                  + f"; launches {launched}", flush=True)
            if not (errs[0] <= TOL[tag] and errs[1] <= lim2
                    and all(e <= lim for e, lim in zip(errs[2:], lims4))
                    and launched == (1,) * len(wrappers)):
                fail(f"{kind} views {tag}: errors {errs}, launches {launched}")
    name, q, pool_k, pool_v, pt, lens, w = _paged_cases(torch, gen, dev)[1]  # window 512
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        qd, kd, vd = (a.to(dtype) for a in (q, pool_k, pool_v))
        ref = pk.paged_decode_attention_reference(qd.float(), kd.float(), vd.float(), pt, lens,
                                                  scale=1 / 16, window=w)
        for kind in ("strided", "offset"):
            n = (pk.paged_decode_attention.launches, mp.paged_decode_attention_mp.launches)
            views = [_layout_views(torch, a)[kind] for a in (qd, pt, lens)]
            outs = [fn(views[0], kd, vd, views[1], views[2], scale=1 / 16, window=w)
                    for fn in (pk.paged_decode_attention, mp.paged_decode_attention_mp)]
            torch.cuda.synchronize()
            errs = [(o.float() - ref).abs().max().item() for o in outs]
            launched = (pk.paged_decode_attention.launches - n[0],
                        mp.paged_decode_attention_mp.launches - n[1])
            print(f"[kernels] {kind} q, page table and lens {tag} ({name}): K3 {errs[0]:.3e}, "
                  f"K4 {errs[1]:.3e} (limit {TOL[tag]:.0e}); launches {launched}", flush=True)
            if not (max(errs) <= TOL[tag] and launched == (1, 1)):
                fail(f"{kind} paged operands {tag}: errors {errs}, launches {launched}")


def _phase_paged(torch, gen, dev, report: dict) -> None:
    """K3 against its plain version on every ``_paged_cases`` case, fp32
    and bf16: within TOL abs, the length-0 row exactly 0, two calls bitwise
    equal (the merge runs in a fixed rank order)."""
    from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk

    k3 = report.setdefault("paged_decode_attention", {"max_abs_err": 0.0})
    for name, q, pool_k, pool_v, pt, lens, w in _paged_cases(torch, gen, dev):
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, pool_k, pool_v))
            args = (qd, kd, vd, pt, lens)
            out = pk.paged_decode_attention(*args, scale=1 / 16, window=w)
            again = pk.paged_decode_attention(*args, scale=1 / 16, window=w)
            ref = pk.paged_decode_attention_reference(
                qd.float(), kd.float(), vd.float(), pt, lens, scale=1 / 16, window=w)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            zero_row = _len0_max(out, lens)
            same = torch.equal(out, again)
            tag = str(dtype).replace("torch.", "")
            print(f"[kernels] K3 {name} {tag} (S {pk.split_for(*_paged_shape(args), w)}): "
                  f"max_abs_err {err:.3e} len-0 row {zero_row:.1e}, two calls bitwise "
                  f"equal {same}", flush=True)
            if not (err <= TOL[tag] and zero_row == 0.0 and same):
                fail(f"K3 {name} {tag}: max abs err {err}, len-0 row max {zero_row}, "
                     f"bitwise equal {same}")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)


def phase_kernels(report: dict) -> None:
    from functools import partial

    import torch

    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = report.setdefault("flash_attention_fwd", {"max_abs_err": 0.0})
    t0 = time.perf_counter()
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
        print(f"[timing]   K1 forward: {time.perf_counter() - t0:.1f} s", flush=True)
        for part in (partial(_phase_paged, torch, gen, dev, report),
                     partial(_phase_flash_bwd, torch, fa, gen, dev, report),
                     partial(_phase_core, torch, gen, dev, report),
                     partial(_phase_core_bd, torch, gen, dev, report),
                     partial(_phase_fused, torch, gen, dev, report),
                     partial(_phase_past_cap, torch, gen, dev),
                     partial(_phase_text_block_grads, torch, gen, dev),
                     partial(_phase_lm_layer_grads, torch, gen, dev),
                     partial(_phase_int4, torch, gen, dev, report),
                     partial(_phase_layouts, torch, gen, dev),
                     partial(_phase_int4_v3, torch, gen, dev, report),
                     partial(_phase_int4_times, torch, gen, dev, report),
                     partial(_phase_paged_mp, torch, gen, dev, report)):
            t0 = time.perf_counter()
            part()
            print(f"[timing]   {part.func.__name__}: {time.perf_counter() - t0:.1f} s",
                  flush=True)


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
    return cfg, sd, _parity_inputs(data_seed)


def _parity_inputs(data_seed: int) -> list:
    """The parity phases' ragged prompt batch [images, ids, mask] (text
    lengths 64, 40, 17 and 5 after 197 vision tokens) from ``data_seed``."""
    import torch

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
    return [torch.from_numpy(x) for x in (images, ids, mask)]


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


def _fronts_loaded(cfg, sd, device):
    """Phase 4's model as a serving engine's loaded model: the weights on
    ``device``, the 12_colors_3k tokenizer (vocabulary 1148) and config."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.serve.loader import (
        LoadedMLLM,
        build_tokenizer,
        training_config,
    )

    config = training_config(dict(TRAINING_CONFIG, labels_mapping_path=MAPPING,
                                  results_dir=REPO))
    tokenizer, mapping = build_tokenizer(config)
    if len(tokenizer) != cfg.lm.vocab_size:
        fail(f"fronts parity: tokenizer of {len(tokenizer)} entries, model of "
             f"{cfg.lm.vocab_size} rows")
    return LoadedMLLM(build_mllm(cfg, sd, device), tokenizer, config, mapping,
                      torch.device(device))


def _slot_tokens(engine, reqs, steps: int) -> dict:
    """Admit ``reqs`` (slot, image, prompt), complete chunked admissions,
    then ``steps`` engine steps: {slot: [first token, step tokens ...]}."""
    import numpy as np

    firsts = engine.admit_many(reqs)
    out = {slot: [f] for (slot, *_), f in zip(reqs, firsts)}
    while any(toks[0] is None for toks in out.values()):
        for slot, first in engine.advance_prefill():
            out[slot][0] = first
    for slot, toks in _slot_tokens_steps(engine, list(out), steps).items():
        out[slot] += toks
    return out


def _int8_drift(model, inputs, steps: int = 4) -> float:
    """Largest relative distance of the LM's decode logits over an int8 page
    pool from the same decode over dense float caches (fixed tokens):
    max |int8 - dense| / max |dense| over ``steps`` steps."""
    import torch

    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache
    from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
        init_paged_kv_cache,
        pages_needed,
    )

    dev = next(model.parameters()).device
    images, ids, mask = (x.to(dev) for x in inputs)
    lm = model.language_model
    b, t = ids.shape
    rows = torch.arange(b, device=dev)
    np_max = pages_needed(t + steps, 16)
    caches = init_kv_cache(lm.cfg, b, t + steps, dev)
    pools = init_paged_kv_cache(lm.cfg, 1 + b * np_max, 16, dev, quantized=True)
    pt = torch.arange(1, 1 + b * np_max, dtype=torch.int32, device=dev).reshape(b, np_max)
    seq = mask.sum(dim=1).to(torch.int32)
    worst = 0.0
    with torch.inference_mode():
        emb = model.prompt_embeds(images, ids)
        lm.prefill(emb, mask, caches, kv_lens=seq)
        lm.prefill_paged(emb, mask, pools, pt)
        cache_mask = torch.nn.functional.pad(mask.to(torch.int32), (0, steps))
        for step in range(steps):
            tok = lm.embed(rows[:, None] * 7 + 5 + step)
            cache_mask[rows, seq.long()] = 1
            dense = lm.lm_head(lm.decode_step(tok, caches, seq, cache_mask))
            int8 = lm.lm_head(lm.decode_step_paged(tok, pools, pt, seq))
            worst = max(worst, ((int8 - dense).abs().max() / dense.abs().max()).item())
            seq = seq + 1
    return worst


def phase_fronts_parity() -> None:
    """Phase 20: phase 4's model (full widths, 2 + 2 layers, float32,
    window 512) behind the serving fronts, on the card and on the CPU: the
    whole-batch engine, the dense continuous engine at steps_per_call 1 and
    4, the chunked engine at chunk 16, beam search of width 4 (scores within
    1e-4) and speculative decoding (draft_layers 1, draft_len 4) give the
    CPU's greedy tokens; speculative tokens and beam width 1 equal greedy's.
    The int8-pool paged engine's codes after admission differ from the CPU's
    by at most 1 and its decode logits stay within 0.05 of dense (JAX's
    bound).  K1 launches exactly: V + L a prefill (V ViT, L LM layers), L a
    decode step, a chunk or a verify, the draft's layers a proposal; K3, K4
    and K5 never."""
    import math

    import torch

    from multimodal_concept_learning_tpu_torch.models.beam import beam_generate
    from multimodal_concept_learning_tpu_torch.models.mllm import greedy_generate
    from multimodal_concept_learning_tpu_torch.models.speculative import speculative_generate
    from multimodal_concept_learning_tpu_torch.serve.chunked import ChunkedContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine
    from multimodal_concept_learning_tpu_torch.serve.paged import PagedContinuousEngine

    cfg, sd, inputs = _parity_model(512, SEED + 3)
    v_layers, l_layers, new = cfg.vision.num_hidden_layers, cfg.lm.num_layers, 8
    with open(MAPPING) as f:
        mapping = list(json.load(f).items())
    reqs = [(slot, _circle(_rgb(key)), f"Is the color of the circle {name}?")
            for slot, (key, name) in zip((2, 0, 3, 1), mapping[1:5])]
    slot_kw = dict(num_slots=4, max_new_tokens=new, max_prompt_len=16)
    counters = _kernel_counters()
    loaded = {dev: _fronts_loaded(cfg, sd, dev) for dev in ("cuda", "cpu")}
    plens = [197 + len(loaded["cpu"].tokenizer.encode(p)[:16]) for _, _, p in reqs]
    prompt_k1 = v_layers + l_layers

    def spec(ld):
        return speculative_generate(ld.model, *inputs, new, draft_layers=1, draft_len=4,
                                    return_stats=True)

    runs = {  # tag: (run on a loaded model, K1 launches expected of the card's result)
        "whole-batch": (lambda ld: ServingEngine(ld, batch_size=4, max_new_tokens=new,
                                                 max_prompt_len=16).generate_tokens(
            [r[1] for r in reqs], [r[2] for r in reqs]),
            lambda out: prompt_k1 + (new - 1) * l_layers),
        "greedy": (lambda ld: greedy_generate(ld.model, *inputs, new),
                   lambda out: prompt_k1 + (new - 1) * l_layers),
        "beam-4": (lambda ld: beam_generate(ld.model, *inputs, new, 4, return_scores=True),
                   lambda out: prompt_k1 + (new - 1) * l_layers),
        "beam-1": (lambda ld: beam_generate(ld.model, *inputs, new, 1),
                   lambda out: prompt_k1 + (new - 1) * l_layers),
        "speculative-1-4": (spec, lambda out: prompt_k1 + out[1]["iterations"]
                            * (1 * 3 + l_layers)),
    }
    for spc in (1, 4):
        steps = math.ceil((new - 1) / spc)
        runs[f"continuous-{spc}"] = (
            lambda ld, spc=spc, steps=steps: _slot_tokens(
                ContinuousEngine(ld, steps_per_call=spc, **slot_kw), reqs, steps),
            lambda out, spc=spc, steps=steps: prompt_k1 + steps * spc * l_layers)
    runs["chunked-16"] = (
        lambda ld: _slot_tokens(ChunkedContinuousEngine(ld, chunk_size=16, steps_per_call=4,
                                                        **slot_kw), reqs, 2),
        lambda out: v_layers + sum(math.ceil(n / 16) for n in plens) * l_layers
        + 2 * 4 * l_layers)
    results = {}
    for tag, (fn, expected_k1) in runs.items():
        for f in counters.values():
            f.launches = 0
        on_card = fn(loaded["cuda"])
        launched = {n: f.launches for n, f in counters.items()}
        on_cpu = fn(loaded["cpu"])
        results[tag] = on_card
        card_toks, cpu_toks = (_as_tokens(x) for x in (on_card, on_cpu))
        want = {"flash_attention_fwd": expected_k1(on_card), "paged_decode_attention": 0,
                "paged_decode_attention_mp": 0, "int4_matmul": 0}
        same = card_toks == cpu_toks
        print(f"[fronts-parity] {tag}: cuda tokens == cpu tokens {same}; launches {launched} "
              f"(expected {want}); cuda {card_toks}", flush=True)
        if not same:
            fail(f"fronts parity {tag}: cpu {cpu_toks}")
        if launched != want:
            fail(f"fronts parity {tag}: launches {launched} != {want}")
        if tag == "beam-4":
            err = (on_card[1].cpu() - on_cpu[1]).abs().max().item()
            print(f"[fronts-parity] beam-4 scores cuda vs cpu: max abs error {err:.2e}",
                  flush=True)
            if not err <= 1e-4:
                fail(f"fronts parity: beam scores differ by {err}")
        if tag == "speculative-1-4":
            print(f"[fronts-parity] speculative stats {on_card[1]}", flush=True)
    greedy = _as_tokens(results["greedy"])
    for tag in ("speculative-1-4", "beam-1"):
        if _as_tokens(results[tag]) != greedy:
            fail(f"fronts parity: {tag} tokens {_as_tokens(results[tag])} != greedy {greedy}")
    chunked_same = results["chunked-16"] == results["continuous-4"]
    print(f"[fronts-parity] speculative == greedy, beam-1 == greedy: True; chunked-16 == "
          f"one-shot admission on the card: {chunked_same} (not a gate)", flush=True)
    _beam_ties(cfg, sd, inputs)

    # int8 pools: codes after admission, then the steps' launches
    pools, launched = {}, {}
    for dev in ("cuda", "cpu"):
        engine = PagedContinuousEngine(loaded[dev], page_size=16, steps_per_call=4,
                                       quant_kv=True, **slot_kw)
        engine.admit_many(reqs)
        pools[dev] = [layer["k"].cpu().numpy().astype(int) for layer in engine.pools]
        if dev == "cuda":
            for f in counters.values():
                f.launches = 0
            toks = _slot_tokens_steps(engine, [r[0] for r in reqs], 2)
            launched = {n: f.launches for n, f in counters.items()}
    code_diff = max(abs(a[1:] - b[1:]).max() for a, b in zip(pools["cuda"], pools["cpu"]))
    drift = _int8_drift(loaded["cuda"].model, inputs)
    want = {"flash_attention_fwd": 2 * 4 * l_layers, "paged_decode_attention": 0,
            "paged_decode_attention_mp": 0, "int4_matmul": 0}
    print(f"[fronts-parity] int8-pool paged engine: codes cuda vs cpu differ by at most "
          f"{code_diff}; decode logits vs dense: max relative distance {drift:.4f} (JAX's "
          f"bound 0.05); step launches {launched} (expected {want}); cuda tokens {toks}",
          flush=True)
    if not (code_diff <= 1 and 0.0 < drift < 0.05 and launched == want):
        fail(f"fronts parity int8 pools: codes {code_diff}, drift {drift}, launches {launched}")


def _beam_ties(cfg, sd, inputs) -> None:
    """Phase 20's beams on tied scores: ``copy_init_ood_rows`` over half the
    vocabulary, so token j and its copy j + V/2 take equal logits through
    the tied head and every top-k ties.  Widths 2 and 3, 4 tokens, no EOS:
    the card's tokens and scores (1e-4) are the CPU's, and every chosen
    token is the lower of its twins (``jax.lax.top_k``'s order)."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.models.beam import beam_generate
    from multimodal_concept_learning_tpu_torch.models.mllm import copy_init_ood_rows

    half = cfg.lm.vocab_size // 2
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy_init_ood_rows(build_mllm(cfg, sd, dev), half)
        out[dev] = {w: beam_generate(model, *inputs, 4, w, return_scores=True) for w in (2, 3)}
        del model
    for w in (2, 3):
        (card, card_scores), (cpu, cpu_scores) = out["cuda"][w], out["cpu"][w]
        same = torch.equal(card.cpu(), cpu)
        err = (card_scores.cpu() - cpu_scores).abs().max().item()
        lower = bool((card < half).all())
        print(f"[fronts-parity] beam-{w} on tied scores (copy_init_ood_rows over {half} rows): "
              f"cuda tokens == cpu tokens {same}, scores max abs error {err:.2e}, every token "
              f"the lower twin {lower}; cuda {card.tolist()}", flush=True)
        if not (same and err <= 1e-4 and lower):
            fail(f"beam ties width {w}: cpu {cpu.tolist()}, scores {err}, lower twins {lower}")


def _slot_tokens_steps(engine, slots, steps: int) -> dict:
    """``steps`` engine steps over ``slots`` (already admitted): {slot: tokens}."""
    import numpy as np

    active = np.zeros(engine.num_slots, bool)
    active[slots] = True
    out = {slot: [] for slot in slots}
    for _ in range(steps):
        toks = engine.step(active)
        for slot in slots:
            out[slot] += [int(t) for t in toks[slot]]
    return out


def _as_tokens(result):
    """A front's result as plain lists: a tokens tensor or array (first of
    a (tokens, extra) pair), or a {slot: tokens} dict."""
    if isinstance(result, dict):
        return {k: list(v) for k, v in sorted(result.items())}
    if isinstance(result, tuple):
        result = result[0]
    return np.asarray(result.cpu() if hasattr(result, "cpu") else result).tolist()


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


def _serve(root: str, tag: str, front=None, adapters=None, **quant) -> dict:
    """Serve the results dir ``root`` through the port's server
    (``make_server``, batch 8, 8 answer tokens; ``front`` its front flags,
    default the paged front with pages of 16): a warm-up request, then 16
    requests from 16 threads; /healthz and /metrics over HTTP.  Returns the
    run's numbers, its answers and the serving path's launch counts
    (counted from 0 just before the first request).  Tokens are counted as
    they stream; the whole-batch front streams none and decodes each row's
    whole budget, 8 tokens a request.  With ``adapters`` (a multi-LoRA bank
    on ``root``) request i asks for adapter i % (len(adapters) + 1)."""
    import http.client
    import threading

    import torch

    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    front = {"paged": True} if front is None else front
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    httpd, batcher = make_server(root, port=0, batch_size=8, max_new_tokens=8, page_size=16,
                                 adapters=adapters, **front, **quant)
    bank = f", a bank of {batcher.engine.num_adapters} adapters" if adapters else ""
    print(f"[{tag}] served in {time.perf_counter() - t0:.1f} s ({front or 'whole-batch'}, "
          f"{quant or 'float weights'}{bank})", flush=True)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    with open(MAPPING) as f:
        mapping = list(json.load(f).items())  # "r255g128b0" -> "<ood 1>"
    requests = []
    for i in range(16):
        key, name = mapping[i % len(mapping)]
        requests.append((_circle(_rgb(key)), f"Is the color of the circle {name}?"))
    counters = _kernel_counters()
    engine = batcher.engine
    streams = hasattr(engine, "step")  # the slot-level fronts stream their tokens
    try:
        for fn in counters.values():
            fn.launches = 0
        if hasattr(engine, "decode_steps"):
            engine.decode_steps = 0
        batcher.submit(*requests[0])  # first request: cuBLAS/allocator warm-up
        results, stamps, latency = [None] * 16, [[] for _ in range(16)], [0.0] * 16

        def run(i):
            t = time.perf_counter()
            results[i] = batcher.submit(*requests[i],
                                        adapter=i % (len(adapters) + 1) if adapters else 0,
                                        on_token=lambda _tok, i=i: stamps[i].append(
                                            time.perf_counter()))
            latency[i] = time.perf_counter() - t

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        steps = getattr(engine, "decode_steps", None)
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.request("GET", "/metrics")
        metrics = json.loads(conn.getresponse().read())
        conn.close()
        state = getattr(engine, "pools", None) or getattr(engine, "caches", None) or ()
        finite = all(bool(torch.isfinite(t).all()) for layer in state for t in layer.values())
    finally:
        httpd.shutdown()
        batcher.shutdown()
        server.join(timeout=30)
        httpd.server_close()
    tokens = sum(len(s) for s in stamps) if streams else 16 * 8
    gaps = [b - a for s in stamps for a, b in zip(s, s[1:])]
    run = {"requests_per_s": 16 / wall, "tokens_per_s": tokens / wall,
           "p50_ms": 1e3 * float(np.median(latency)), "launches": launches,
           "decode_steps": steps, "answers": results, "batches": batcher.stats.get("batches"),
           "max_gap_ms": 1e3 * max(gaps) if gaps else None}
    gap = f"; longest gap between a request's tokens {run['max_gap_ms']:.1f} ms" if gaps else ""
    print(f"[{tag}] 16 requests from 16 threads in {wall:.3f} s: {run['requests_per_s']:.3f} "
          f"requests/s, {run['tokens_per_s']:.1f} generated tokens/s ({tokens} tokens); "
          f"p50 latency {run['p50_ms']:.1f} ms, max {1e3 * max(latency):.1f} ms{gap}", flush=True)
    print(f"[{tag}] healthz {health}; metrics {metrics}", flush=True)
    print(f"[{tag}] answers {results[:4]} ...; kernel launches {launches} over {steps} decode "
          f"steps", flush=True)
    if not all(isinstance(r, str) for r in results):
        fail(f"{tag}: not every request was answered")
    if not (health.get("ok") and metrics.get("completed") == 17 and finite):
        fail(f"{tag} server state: healthz {health}, metrics {metrics}, finite state {finite}")
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


FRONTS = (("whole-batch", {}), ("continuous", {"continuous": True}),
          ("chunked-64", {"continuous": True, "chunked_prefill": 64}),
          ("paged-int8-kv", {"paged": True, "int8_kv": True}))
VIT_LAYERS, LM_LAYERS = 12, 26  # the full 12_colors_3k model's ViT and LM depths
PROMPT_K1 = VIT_LAYERS + LM_LAYERS  # K1 launches of one prefill: ViT and LM layers


def phase_fronts_slice(root: str, float_run: dict) -> None:
    """Phase 21: phase 5's results dir (the full 12_colors_3k model, bf16)
    served through the other fronts: the whole-batch front (no flag), the
    dense continuous front, chunked prefill of 64 and the paged front with
    int8 pools, 16 requests each as phase 5.  K3, K4 and K5 never launch;
    the whole-batch front launches K1 exactly 38 + 26 x 7 a batch, the
    slot-level fronts at least 38 and 26 a decode step.  Requests/s, tokens/s, p50
    latency and the longest gap between a request's tokens beside phase
    5's, and how many answers equal phase 5's (bf16: a count, not a gate)."""
    runs = {"paged (phase 5)": float_run}
    for tag, front in FRONTS:
        run = runs[tag] = _serve(root, f"fronts-{tag}", front=front)
        launches, steps = run["launches"], run["decode_steps"]
        others = {n: launches[n] for n in ("paged_decode_attention", "paged_decode_attention_mp",
                                          "int4_matmul")}
        if any(others.values()):
            fail(f"fronts slice {tag}: launched {others} (expected none)")
        k1 = launches["flash_attention_fwd"]
        if tag == "whole-batch":
            want = run["batches"] * (PROMPT_K1 + LM_LAYERS * 7)
            ok = k1 == want
        else:
            want = f">= {PROMPT_K1} + {LM_LAYERS} x {steps} decode steps"
            ok = steps > 0 and k1 >= PROMPT_K1 + LM_LAYERS * steps
        print(f"[fronts-{tag}] K1 launches {k1} (expected {want}); answers equal to phase 5's: "
              f"{sum(a == b for a, b in zip(run['answers'], float_run['answers']))} of 16",
              flush=True)
        if not ok:
            fail(f"fronts slice {tag}: K1 launches {k1}, expected {want}")
    for tag, run in runs.items():
        gap = run["max_gap_ms"]
        print(f"[fronts-slice] {tag}: {run['requests_per_s']:.3f} requests/s, "
              f"{run['tokens_per_s']:.1f} tokens/s, p50 {run['p50_ms']:.1f} ms, longest gap "
              f"between a request's tokens {'n/a' if gap is None else f'{gap:.1f} ms'}",
              flush=True)


ANSWER_ARGS = ["--split", "train", "--batch_size", "8", "--limit", "16", "--max_new_tokens", "8",
               "--device", "cuda"]


DRAFT_LAYERS = 13  # phase 15's self-speculative draft: half the LM
ANSWER_RUNS = (("float", []), ("int4", ["--int4"]), ("int8", ["--int8", "--int8_vision"]),
               ("beam4", ["--num_beams", "4"]),
               ("spec13", ["--draft_layers", str(DRAFT_LAYERS), "--draft_len", "4"]))


def _answer_k1(tag: str, batches: int, new: int):
    """K1 launches the answer CLI's run ``tag`` makes: (low, high), equal
    but for speculative decoding, whose verify calls (13 x 3 draft + 26 each)
    depend on how many proposals are accepted: from ceil((new - 1) / 4) to
    new - 1 a batch."""
    if tag != "spec13":
        n = batches * (PROMPT_K1 + LM_LAYERS * (new - 1))
        return n, n
    per_iter = DRAFT_LAYERS * 3 + LM_LAYERS
    return (batches * (PROMPT_K1 + per_iter * -(-(new - 1) // 4)),
            batches * (PROMPT_K1 + per_iter * (new - 1)))


def phase_answer_slice(root: str, runs=ANSWER_RUNS, prefix: str = "answers") -> dict:
    """Phase 15: the port's answer CLI on phase 7's results dir and data
    (the full 12_colors_3k model trained one epoch, bf16 compute): float,
    ``--int4``, ``--int8 --int8_vision``, beam search of width 4 and
    self-speculative decoding (13 draft layers, draft_len 4); 16 train
    samples, 8 tokens, batch 8.  Checks the CLI's lines, the 16 JSONL rows
    and the launch counts (counted from 0 just before each run): K1 38 a
    prefill (12 ViT + 26 LM layers) and 26 a decode step (at 32 rows under
    beam search; speculative: 13 a draft proposal, 26 a verify, in the range
    of ``_answer_k1``); K5 7 x 26 a decode step under ``--int4``, else 0.
    Prints how many speculative rows equal the float greedy rows (bf16: the
    chunked verify may round differently; a count, not a gate).  ``runs``
    and ``prefix`` select the runs and tag the lines (phase 23 runs the
    first two on its LoRA run); returns {tag: generated rows}."""
    import contextlib
    import io

    import torch

    from multimodal_concept_learning_tpu_torch.train.generate_answers import main as answers_main

    results = os.path.join(root, "results")
    counters = _kernel_counters()
    new, n = 8, 16
    timings, rows_of = {}, {}
    for tag, extra in runs:
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
            print(f"[{prefix}-{tag}] {line}", flush=True)
        with open(out_path) as f:
            rows = rows_of[tag] = [json.loads(line) for line in f]
        keys = {"prompt", "generated", "target", "yes_no_match", "exact_match"}
        batches = res["batches"]
        k1_low, k1_high = _answer_k1(tag, batches, new)
        expected = {"flash_attention_fwd": k1_low if k1_low == k1_high else (k1_low, k1_high),
                    "paged_decode_attention": 0, "paged_decode_attention_mp": 0,
                    "int4_matmul": batches * LM_PROJECTION_LAUNCHES * (new - 1)
                    if tag == "int4" else 0}
        lines_ok = (f"Generated answers for {n} samples (train split)" in text
                    and re.search(r"^Yes/No Accuracy: \d+\.\d\d%$", text, re.M)
                    and re.search(r"^Exact-Match Accuracy: \d+\.\d\d%$", text, re.M)
                    and f"Wrote {out_path}" in text)
        rows_ok = (len(rows) == n and all(set(r) == keys and r["target"] for r in rows))
        samples_s, tokens_s = n / res["seconds"], n * new / res["seconds"]
        timings[tag] = (samples_s, tokens_s, res)
        print(f"[{prefix}-{tag}] {n} samples x {new} tokens in {batches} batches: generation "
              f"{res['seconds']:.3f} s = {samples_s:.3f} samples/s, {tokens_s:.1f} tokens/s; "
              f"whole CLI {wall:.1f} s; launches {launches} (expected {expected}); rows "
              f"{rows[:2]} ...", flush=True)
        if not (lines_ok and rows_ok and res["n"] == n and batches == 2):
            fail(f"answer slice {tag}: lines {lines_ok}, rows {rows_ok}, n {res['n']}, "
                 f"batches {batches}")
        k1 = launches.pop("flash_attention_fwd")
        expected.pop("flash_attention_fwd")
        if not (k1_low <= k1 <= k1_high and launches == expected):
            fail(f"answer slice {tag}: launches K1 {k1} (expected {k1_low}..{k1_high}), "
                 f"{launches} != {expected}")
    if "spec13" in rows_of:
        same = sum(a["generated"] == b["generated"]
                   for a, b in zip(rows_of["spec13"], rows_of["float"]))
        print(f"[{prefix}] speculative rows equal to the float greedy rows: {same} of {n}",
              flush=True)
    print(f"[{prefix}] " + "; ".join(
        f"{tag}: {sps:.3f} samples/s, {tps:.1f} tokens/s, yes/no {res['yes_no_acc']:.2f}%, "
        f"exact {res['exact_acc']:.2f}%" for tag, (sps, tps, res) in timings.items()),
        flush=True)
    return rows_of


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


LORA_RANK, LORA_ALPHA = 8, 16.0  # phases 22 and 23


def _lora_model(dev: str, rank: int = LORA_RANK):
    """Phase 22's float32 MLLM (full widths, 2 ViT + 2 LM layers, the LM's
    first layer sliding at window 64, rank-``rank`` adapters, alpha 16),
    seeded from SEED with 6 ``<ood>`` rows copied, and its ``b`` factors
    drawn normal(0.02) too: an adapter in training, where both factors take
    gradients (at b = 0 the gradient of ``a`` is exactly 0).  Returns (cfg,
    state dict)."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        MLLM,
        MLLMConfig,
        copy_init_ood_rows,
    )

    base = MLLMConfig.create(vocab_size=1148, dtype=torch.float32, lm_lora_rank=rank,
                             lm_lora_alpha=LORA_ALPHA)
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
        lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=64,
                               sliding_window_pattern=2))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.device(dev):
        model = init_random_weights_(MLLM(cfg), gen)
    copy_init_ood_rows(model, 6)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_lora.b"):
                p.normal_(0.0, 0.02, generator=gen)
    return cfg, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _adapter_tree(sd: dict, seed: int) -> dict:
    """A trained-adapter stand-in, as JAX ``tests/test_multi_lora.py``
    builds it: the adapter surface (LoRA factors, projector) replaced by
    seeded normal(0.05) values."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops.multi_lora import is_adapter_name

    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((0.05 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
            if is_adapter_name(k) else v for k, v in sd.items()}


def _micro_steps(cfg, sd: dict, dev: str, setting: str, batches: list):
    """Three micro-steps (accumulation 2, lr 5e-4, weight decay 1e-4, clip
    1) of ``setting`` as the trainer sets them up: (losses, final host state
    dict, (K1 forward, dQ, dK/dV) launches, mask)."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, trainable_mask
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    with torch.device(dev):
        model = MLLM(cfg)
    model.load_state_dict(sd, strict=True)
    mask = trainable_mask(model, setting)
    opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                          accumulation_steps=2)
    cast_for_compute(model, cfg.dtype, only_frozen=True)
    state, step = TrainState(model=model, optimizer=opt), make_mllm_train_step(model)
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    losses = [float(step(state, to_device(b, dev))[1]["loss"]) for b in batches]
    return (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
            tuple(fn.launches for fn in counters), mask)


def _bank_loaded(cfg, state_dicts: list, device: str, int8: bool = False):
    """A multi-LoRA bank of ``state_dicts`` (entry 0 first) as the serving
    loader builds it, on ``device``, with the 12_colors_3k tokenizer."""
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
        is_adapter_name,
        stack_adapter_params,
    )
    from multimodal_concept_learning_tpu_torch.ops.quant import quantize_mllm_params

    bank = stack_adapter_params(state_dicts)
    if int8:
        bank, cfg = quantize_mllm_params(bank, vision=False, lm=True), cfg.quantized(int8=True)
    base = {k: v[0].clone() if is_adapter_name(k) else v for k, v in bank.items()}
    loaded = _fronts_loaded(cfg, base, device)
    surface = {k: v.to(device) for k, v in bank.items() if is_adapter_name(k)}
    return loaded._replace(bank=surface, num_adapters=len(state_dicts))


def phase_lora_parity() -> None:
    """Phase 22: LoRA at full widths and 2 + 2 layers, float32, rank 8.
    Three ``language_lora`` micro-steps (``_lora_model``: both factors
    nonzero) on the card and on the CPU give the
    same losses and trained tensors (the factors and the projector, all
    moved), frozen tensors bitwise unchanged, and exactly the K1 forward,
    dQ and dK/dV launches of the same steps without adapters.  The merged
    forward on the card within 1e-5 (+ 1e-5 relative) of the adapter
    forward.  A bank of three (the identity and two seeded adapters) behind
    the whole-batch and the dense continuous engines with mixed adapter ids:
    the card's tokens are the CPU's and each row's are its adapter's merged
    model's, K1 exactly as phase 20 counts it and K3, K4, K5 never; then an
    int8 bank: the card's tokens are the CPU's."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import build_mllm
    from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import identity_adapter_params
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, training_config

    with open(MAPPING) as f:
        labels_mapping = json.load(f)
    tokenizer, _ = build_tokenizer(training_config(dict(TRAINING_CONFIG,
                                                        labels_mapping_path=MAPPING)))
    cfg, sd = _lora_model("cpu")
    cfg0 = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, lora_rank=0))
    batches = [_train_batch(tokenizer, labels_mapping, seed=i) for i in range(3)]
    runs = {dev: _micro_steps(cfg, sd, dev, "language_lora", batches) for dev in ("cuda", "cpu")}
    plain = _micro_steps(cfg0, {k: v for k, v in sd.items() if "_lora." not in k}, "cuda",
                         "language_lora", batches)
    (cl, csd, claunch, mask), (pl, psd, plaunch, _) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, pl))
    trained = [n for n, t in mask.items() if t]
    # held as phase 6 holds them: norm-relative, and the largest element
    # difference in units of the learning rate (Adam's first update is ~lr
    # per element, whatever the gradient's size)
    param_err = max(((csd[n] - psd[n]).norm() / psd[n].norm()).item() for n in trained)
    worst = max((csd[n] - psd[n]).abs().max().item() for n in trained) / 5e-4
    moved = all(not torch.equal(csd[n], sd[n]) for n in trained)
    frozen_same = all(torch.equal(csd[n], sd[n]) and torch.equal(psd[n], sd[n])
                      for n, t in mask.items() if not t)
    print(f"[lora-parity] language_lora micro-steps: losses cuda {cl} cpu {pl}: max rel err "
          f"{loss_err:.2e}; {len(trained)} trained tensors (factors + projector): max "
          f"norm-relative err {param_err:.2e} (largest element difference {worst:.3f} lr), all "
          f"moved {moved}; frozen bitwise unchanged {frozen_same}; kernel launches (fwd, dq, "
          f"dkv) cuda {claunch}, without adapters {plain[2]}, cpu {plaunch}", flush=True)
    if not (loss_err <= 1e-4 and param_err <= 1e-4 and moved and frozen_same
            and len(trained) == 2 + 2 * 7 * cfg.lm.num_layers):
        fail("LoRA training parity CUDA vs CPU")
    if claunch != plain[2] or min(claunch) == 0 or max(plaunch) != 0:
        fail(f"LoRA training launches {claunch}, without adapters {plain[2]}, cpu {plaunch}")

    adapters = [identity_adapter_params(sd), _adapter_tree(sd, 1), _adapter_tree(sd, 2)]
    inputs = _parity_inputs(SEED + 5)
    with torch.inference_mode():
        lora_h = build_mllm(cfg, adapters[1], "cuda")(*(x.cuda() for x in inputs))
        merged = build_mllm(cfg0, merge_lora_params(adapters[1], LORA_ALPHA), "cuda")
        merged_h = merged(*(x.cuda() for x in inputs))
    diff = (merged_h["hidden_states"] - lora_h["hidden_states"]).abs()
    excess = (diff - 1e-5 * lora_h["hidden_states"].abs()).max().item()
    print(f"[lora-parity] merged vs adapter forward on the card: max abs error "
          f"{diff.max().item():.2e} (max |hidden| {lora_h['hidden_states'].abs().max().item():.2f})"
          f"; past 1e-5 relative by {excess:.2e}", flush=True)
    if not excess <= 1e-5:
        fail(f"merged vs adapter forward: {excess}")
    del merged, lora_h, merged_h
    _phase_lora_bank(cfg, cfg0, adapters)


def _bank_hidden(model, inputs, rows=None) -> list:
    """Prefill hidden states [B, T, H] (padding zeroed) and one decode
    step's [B, 1, H] over dense caches, float32 on the host; under
    ``rows`` (``bank_rows``' result) each row takes its own adapter."""
    import torch

    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache
    from multimodal_concept_learning_tpu_torch.ops.lora import adapter_rows

    dev = next(model.parameters()).device
    images, ids, mask = (x.to(dev) for x in inputs)
    lm = model.language_model
    b, t = ids.shape
    caches = init_kv_cache(lm.cfg, b, t + 1, dev)
    seq = mask.sum(dim=1).to(torch.int32)
    cache_mask = torch.nn.functional.pad(mask.to(torch.int32), (0, 1))
    cache_mask[torch.arange(b, device=dev), seq.long()] = 1
    with torch.inference_mode(), adapter_rows(rows or {}):
        h0 = model.prefill(images, ids, mask, caches, kv_lens=seq) * mask[:, :, None]
        h1 = lm.decode_step(lm.embed(ids[:, 200:201]), caches, seq, cache_mask)
    return [h.float().cpu() for h in (h0, h1)]


def _phase_lora_bank(cfg, cfg0, adapters: list) -> None:
    """Phase 22's bank part (see ``phase_lora_parity``).  The random
    weights decode one token everywhere, so each row's hidden states are
    held too: under mixed ids, the bank's prefill and decode-step hidden
    states are each row's merged adapter model's (1e-4 of the largest), and
    the adapters' rows stand apart from the base's."""
    import math

    import torch

    from multimodal_concept_learning_tpu_torch.ops.lora import merge_lora_params
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import bank_rows
    from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine
    from multimodal_concept_learning_tpu_torch.serve.engine import ServingEngine

    with open(MAPPING) as f:
        mapping = list(json.load(f).items())
    reqs = [(_circle(_rgb(key)), f"Is the color of the circle {name}?")
            for key, name in mapping[1:5]]
    ids = [0, 2, 1, 2]
    v_layers, l_layers, new = cfg.vision.num_hidden_layers, cfg.lm.num_layers, 8
    counters = _kernel_counters()
    images, prompts = [r[0] for r in reqs], [r[1] for r in reqs]
    kw = dict(max_new_tokens=new, max_prompt_len=16)
    steps = math.ceil((new - 1) / 4)
    slots = [2, 0, 3, 1]
    engines = {}

    def whole_batch(ld):
        return ServingEngine(ld, batch_size=4, **kw).generate_tokens(images, prompts, ids)

    def continuous(ld):
        eng = engines[ld.device.type] = ContinuousEngine(ld, num_slots=4, steps_per_call=4, **kw)
        firsts = eng.admit_many([(s, *r, a) for s, r, a in zip(slots, reqs, ids)])
        toks = _slot_tokens_steps(eng, slots, steps)
        return np.asarray([[f, *toks[s]][:new] for s, f in zip(slots, firsts)])

    prompt_k1 = v_layers + l_layers
    for int8 in (False, True):
        loaded = {dev: _bank_loaded(cfg, adapters, dev, int8=int8) for dev in ("cuda", "cpu")}
        runs = (("whole-batch", whole_batch, prompt_k1 + (new - 1) * l_layers),
                ("continuous", continuous, prompt_k1 + steps * 4 * l_layers))
        for tag, fn, want_k1 in runs[:1] if int8 else runs:
            for f in counters.values():
                f.launches = 0
            card = fn(loaded["cuda"])
            launched = {n: f.launches for n, f in counters.items()}
            cpu = fn(loaded["cpu"])
            want = {"flash_attention_fwd": want_k1, "paged_decode_attention": 0,
                    "paged_decode_attention_mp": 0, "int4_matmul": 0}
            same = bool((card == cpu).all())
            label = f"{'int8 ' if int8 else ''}bank {tag}"
            print(f"[lora-parity] {label} (adapters {ids}): cuda tokens == cpu tokens {same}; "
                  f"launches {launched} (expected {want}); cuda {card.tolist()}", flush=True)
            if not same or launched != want:
                fail(f"LoRA {label}: cpu {cpu.tolist()}, launches {launched}")
        if int8:
            break
        caches = [max(((c[p].cpu() - g[p]).abs().max() / g[p].abs().max()).item()
                      for p in ("k", "v"))
                  for c, g in zip(engines["cuda"].caches, engines["cpu"].caches)]
        print(f"[lora-parity] bank continuous: KV caches cuda vs cpu, max abs error / max |cpu| "
              f"by layer {[f'{e:.2e}' for e in caches]}", flush=True)
        if not max(caches) <= 1e-4:
            fail(f"LoRA bank continuous caches cuda vs cpu: {caches}")
        # each row's hidden states on the card: its merged adapter model's
        inputs = _parity_inputs(SEED + 6)
        model, bank = loaded["cuda"].model, loaded["cuda"].bank
        got = _bank_hidden(model, inputs, bank_rows(model, bank, torch.tensor(ids).cuda()))
        merged = {}
        for a in sorted(set(ids)):
            own = _fronts_loaded(cfg0, merge_lora_params(adapters[a], LORA_ALPHA), "cuda")
            merged[a] = _bank_hidden(own.model, inputs)
            del own
        want = [torch.stack([merged[a][i][r] for r, a in enumerate(ids)]) for i in range(2)]
        errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
        apart = min(((merged[a][1][r] - merged[0][1][r]).abs().max()
                     / merged[0][1][r].abs().max()).item() for r, a in enumerate(ids) if a)
        print(f"[lora-parity] bank hidden states on the card vs each row's merged adapter "
              f"model, max abs error / max |merged| (prefill, decode step): {errs[0]:.2e}, "
              f"{errs[1]:.2e}; an adapter row's decode step apart from the base's by at least "
              f"{apart:.2e} of its max", flush=True)
        if not (max(errs) <= 1e-4 and apart > 1e-2):
            fail(f"LoRA bank hidden states: errors {errs}, adapters apart {apart}")
        engines.clear()
        del loaded, model, bank


def _write_config(src: str, root: str, overrides: dict) -> dict:
    """The YAML ``src`` with the top-level ``overrides`` (set, or added
    where ``src`` lacks them) written into ``root/<name>``; returns
    {"path", "parsed"}."""
    from multimodal_concept_learning_tpu_torch import miniyaml

    with open(src) as f:
        text = f.read()
    lines, seen = [], set()
    for line in text.splitlines():
        key = line.split(":", 1)[0]
        top = key in overrides and not line.startswith(" ")
        seen.update([key] if top else [])
        lines.append(f"{key}: {overrides[key]}" if top else line)
    lines += [f"{key}: {value}" for key, value in overrides.items() if key not in seen]
    path = os.path.join(root, os.path.basename(src))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(path) as f:
        return {"path": path, "parsed": miniyaml.safe_load(f)}


def _write_train_config(root: str, data_dir: str, vision_path: str = None) -> str:
    """experiments/multimodal/color/12_colors_3k.yaml with the paths under
    ``root``, epochs 1, 2 loader workers and ``vision_path``, as a YAML file."""
    cfg = _write_config(os.path.join(REPO, "experiments/multimodal/color/12_colors_3k.yaml"),
                        root, {"mapping_path": os.path.join(data_dir, "train_mapping.csv"),
                               "image_root": data_dir, "labels_mapping_path": MAPPING,
                               "results_dir": os.path.join(root, "results"), "epochs": "1",
                               "num_workers": "2", "vision_path": vision_path or "null"})
    parsed = cfg["parsed"]
    assert parsed["epochs"] == 1 and parsed["batch_size"] == 2 and parsed["image_root"] == data_dir
    assert parsed["vision_path"] == vision_path
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


def phase_train_slice(report: dict, root: str, images_per_color: int = 8,
                      vision_path: str = None) -> tuple:
    """The port's trainer CLI on the full 12_colors_3k model, one epoch; its
    vision tower warm-started from ``vision_path`` (phase 18's
    ``best_model.pt``), which ``initial_model.pt`` must hold bitwise.
    Returns the generated data (dataset dir, {split: size})."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import changed_frozen, load_state_dict
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, images_per_color)
    cfg_path = _write_train_config(root, data_dir, vision_path)
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
    warm = True
    if vision_path:  # the tower of initial_model.pt is the vision trainer's, bitwise
        vision_sd = load_state_dict(vision_path)
        tower = [n for n in init_sd if n.startswith("vision_model.")]
        warm = bool(tower) and all(torch.equal(init_sd[n], vision_sd["vit." + n[13:]])
                                   for n in tower)
        print(f"[train] warm start from {vision_path}: {len(tower)} tower tensors of "
              f"initial_model.pt bitwise the vision trainer's {warm}", flush=True)
        del vision_sd
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
            and not missing and warm):
        fail("training slice checks")
    if launches != expected:
        fail(f"training slice launch counts {launches} != expected {expected}")
    for name, n in launches.items():
        report[name]["launches"] = n
    return data_dir, sizes


MM_CONFIG = os.path.join(REPO, "experiments/multimodal/color/12_colors_3k.yaml")


def _lora_adapter_copy(results: str, dst: str, seed: int) -> str:
    """A copy of the results dir ``results`` (config, tokenizer,
    ``best_model.pt``) whose LoRA factors and projector carry seeded normal
    noise (0.02 of their values' scale: another adapter trained from the
    same base), written by the port's checkpoint writer."""
    import shutil

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict, save_state_dict
    from multimodal_concept_learning_tpu_torch.ops.multi_lora import is_adapter_name

    src, out = os.path.join(results, "models"), os.path.join(dst, "models")
    os.makedirs(out)
    for name in ("training_config.json", "tokenizer"):
        (shutil.copytree if name == "tokenizer" else shutil.copy)(
            os.path.join(src, name), os.path.join(out, name))
    gen = torch.Generator().manual_seed(seed)
    sd = load_state_dict(os.path.join(src, "best_model.pt"))
    save_state_dict({k: v + 0.02 * torch.randn(v.shape, generator=gen) if is_adapter_name(k)
                     else v for k, v in sd.items()}, os.path.join(out, "best_model.pt"))
    return dst


def phase_lora_slice(root: str, data: tuple) -> None:
    """Phase 23 (run after phase 19, on phase 7's generated data): the full
    12_colors_3k model (bf16) trained one epoch by the port's trainer CLI
    with ``trainable_params_setting: language_lora``, ``lm_lora_rank: 8``
    (a copy of the YAML under ``root``; vision tower from its seeded init):
    micro-steps/s, K1 launches a micro-step those of phase 7 (38 forward,
    26 dQ, 26 dK/dV; 38 an eval batch), the factors and projector moved,
    the frozen tensors bitwise those of ``initial_model.pt``.  The run
    served merged on the paged front (K1 and K3 launched, K4 and K5 not);
    the answer CLI on it, float and ``--int4`` (K5 7 x 26 a decode step).
    Then a bank of the run and a seeded copy of it on the whole-batch and
    the dense continuous fronts, 16 requests of adapters 0, 1, 2 in turn:
    /healthz and /metrics, requests/s and p50; K1 exactly 38 + 26 x 7 a
    whole batch (at least 38 and 26 a decode step on the continuous front);
    K3, K4 and K5 never; how many adapter-1 answers equal the merged
    paged server's (bf16 merged and unmerged weights round apart: a count,
    not a gate)."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import changed_frozen, load_state_dict
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    data_dir, sizes = data
    lora_root = os.path.join(root, "lora")
    os.makedirs(lora_root)
    results = os.path.join(lora_root, "results")
    cfg_path = _write_config(MM_CONFIG, lora_root, {
        "mapping_path": os.path.join(data_dir, "train_mapping.csv"), "image_root": data_dir,
        "labels_mapping_path": MAPPING, "results_dir": results, "epochs": "1",
        "num_workers": "2", "trainable_params_setting": "language_lora",
        "lm_lora_rank": str(LORA_RANK),
        # no epoch checkpoint: nothing here reads it, and each full-width
        # save writes ~3 GB of the call's disk budget
        "save_every_epoch": "false"})["path"]
    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    state, test_metrics, logged = train_main(["--config_path", cfg_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in zip(
        ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), counters)}
    micro = sizes["train"] // 2
    evals = -(-sizes["val"] // 2) + -(-sizes["test"] // 2)
    expected = {"flash_attention_fwd": 38 * (micro + evals),
                "flash_attention_bwd_dq": 26 * micro, "flash_attention_bwd_dkv": 26 * micro}
    epoch = logged[0]
    models = os.path.join(results, "models")
    init_sd = load_state_dict(os.path.join(models, "initial_model.pt"))
    best_sd = load_state_dict(os.path.join(models, "best_model.pt"))
    trained = [n for n in init_sd if "_lora." in n or n.startswith("projector.")]
    moved = all(not torch.equal(init_sd[n], best_sd[n]) for n in trained)
    frozen_same = all(torch.equal(init_sd[n], best_sd[n]) for n in init_sd if n not in trained)
    changed_on_card = changed_frozen(state.model, init_sd)
    del init_sd, best_sd, state
    finite = all(np.isfinite(epoch[k]) for k in ("train_loss", "val_loss"))
    steps_per_s = epoch["micro_steps"] / epoch["train_time"]
    print(f"[lora-train] one epoch of language_lora (rank {LORA_RANK}): {epoch['micro_steps']} "
          f"micro-steps (batch 2) in {epoch['train_time']:.3f} s: {steps_per_s:.3f} "
          f"micro-steps/s, {2 * steps_per_s:.3f} samples/s; whole CLI run {wall:.1f} s",
          flush=True)
    print(f"[lora-train] train loss {epoch['train_loss']}, val loss {epoch['val_loss']}, test "
          f"{test_metrics}; kernel launches {launches} (expected {expected}, phase 7's a "
          f"micro-step and eval batch); {len(trained)} trained tensors moved {moved}; frozen "
          f"bitwise == initial_model.pt {frozen_same}, changed on the card {changed_on_card}",
          flush=True)
    if not (finite and moved and frozen_same and not changed_on_card and len(trained) == 366):
        fail("LoRA training slice checks")
    if launches != expected:
        fail(f"LoRA training slice launch counts {launches} != expected {expected}")

    merged = _serve(results, "lora-paged")  # merged by the loader
    ml = merged["launches"]
    if not (ml["flash_attention_fwd"] and ml["paged_decode_attention"]
            and not ml["paged_decode_attention_mp"] and not ml["int4_matmul"]):
        fail(f"LoRA merged paged serving launches {ml}")
    phase_answer_slice(lora_root, runs=ANSWER_RUNS[:2], prefix="lora-answers")

    copy = _lora_adapter_copy(results, os.path.join(lora_root, "adapter2"), SEED + 23)
    for tag, front in (("whole-batch", {}), ("continuous", {"continuous": True})):
        run = _serve(results, f"lora-bank-{tag}", front=front, adapters=[results, copy])
        launches, steps = run["launches"], run["decode_steps"]
        others = {n: launches[n] for n in ("paged_decode_attention", "paged_decode_attention_mp",
                                          "int4_matmul")}
        k1 = launches["flash_attention_fwd"]
        if tag == "whole-batch":
            want = run["batches"] * (PROMPT_K1 + LM_LAYERS * 7)
            ok = k1 == want
        else:
            want = f">= {PROMPT_K1} + {LM_LAYERS} x {steps} decode steps"
            ok = steps > 0 and k1 >= PROMPT_K1 + LM_LAYERS * steps
        same = sum(run["answers"][i] == merged["answers"][i] for i in range(1, 16, 3))
        print(f"[lora-bank-{tag}] K1 launches {k1} (expected {want}), others {others}; adapter-1 "
              f"answers equal to the merged paged server's: {same} of 5", flush=True)
        if not ok or any(others.values()):
            fail(f"LoRA bank {tag}: K1 {k1} (expected {want}), others {others}")


MLORA_LENGTHS = "2,8,32"  # phase 24's decode lengths (the script's default is 2,16,64)


def phase_multi_lora_bench() -> None:
    """Phase 24: the port's ``scripts/bench_multi_lora.py`` at its defaults
    (gemma3-1b, vit-b-16, batch 8, rank 8, a bank of 4) but for the
    lengths, MLORA_LENGTHS: plain and bank ms a token and fixed cost, K1
    launched by both."""
    from multimodal_concept_learning_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_concept_learning_tpu_torch.scripts import bench_multi_lora

    flash_attention.launches = 0
    res = bench_multi_lora.main(["--device", "cuda", "--lengths", MLORA_LENGTHS])
    print(f"[multi-lora-bench] plain {res['plain']['ms_per_token']:.3f} ms/token + "
          f"{res['plain']['fixed_ms']:.1f} ms fixed; bank {res['bank']['ms_per_token']:.3f} "
          f"ms/token + {res['bank']['fixed_ms']:.1f} ms fixed; per-token overhead "
          f"{100 * res['overhead']:+.1f}%; K1 launches {flash_attention.launches}", flush=True)
    shapes = {k: v.shape for k, v in res["tokens"].items()}
    longest = int(MLORA_LENGTHS.rsplit(",", 1)[1])
    if flash_attention.launches == 0 or shapes != {"plain": (8, longest), "bank": (8, longest)}:
        fail(f"multi-LoRA bench: K1 {flash_attention.launches}, token shapes {shapes}")


VISION_CONFIG = os.path.join(REPO, "experiments/vision/color/12_colors_3k.yaml")


def _vision_batches(n: int, b: int, labels: int, seed: int) -> list:
    """``n`` numpy classifier batches of ``b`` 224px noise images (float32
    NCHW; noise keeps the samples' features apart, as in phase 8) with
    random labels."""
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal((b, 3, 224, 224)).astype(np.float32),
             "labels": rng.integers(0, labels, b).astype(np.int32),
             "valid": np.ones(b, bool)} for _ in range(n)]


def _k1_counts(fa) -> tuple:
    return (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches)


def _classifier_parity(tag: str, cfg, sd: dict, batches: list) -> None:
    """Three classifier micro-steps with accumulation 2, dropout 0, on the
    card (K1 forward, dQ and dK/dV: exactly one of each a layer and
    micro-step) and on the CPU (plain versions) from the weights ``sd``:
    the first batch's gradient of every tensor within 1e-4 relative in norm
    (but the key biases, whose gradient is rounding alone: phase 8), then
    the same losses (1e-4 relative) and parameters (each tensor within 1e-4
    relative in norm, but the key biases)."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.vit import ViTForImageClassification
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops.losses import cross_entropy_loss
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_classifier_train_step,
    )

    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = ViTForImageClassification(cfg)
        model.load_state_dict(sd, strict=True)
        first = to_device(batches[0], dev)
        cross_entropy_loss(model(first["images"]), first["labels"]).backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        opt = build_optimizer(model, 1e-4, weight_decay=0.1, max_grad_norm=1.0,
                              accumulation_steps=2)
        state = TrainState(model=model, optimizer=opt)
        step = make_classifier_train_step(model, torch.Generator(device=dev).manual_seed(SEED))
        before, losses = _k1_counts(fa), []
        for batch in batches:
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
        launched = tuple(n - b for n, b in zip(_k1_counts(fa), before))
        runs[dev] = (losses, grads,
                     {k: v.detach().float().cpu() for k, v in model.state_dict().items()},
                     launched, {k: v.cpu() for k, v in (opt.master or {}).items()})
    (cl, cg, csd, claunch, cmaster), (pl, pg, psd, plaunch, _) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, pl))
    held = [n for n in cg if not n.endswith("key.bias")]
    grad_errs = sorted((((cg[n] - pg[n]).norm() / pg[n].norm()).item(), n) for n in held)
    flat = torch.cat([csd[n].flatten() - psd[n].flatten() for n in sd])
    param_err = (flat.norm() / torch.cat([psd[n].flatten() for n in sd]).norm()).item()
    tensor_errs = sorted((((csd[n] - psd[n]).norm() / psd[n].norm()).item(), n) for n in held)
    moved = sum(not torch.equal(csd[n], sd[n]) for n in csd)
    n = cfg.num_hidden_layers * len(batches)
    expected = (n, n, n)  # one a layer and micro-step
    print(f"[{tag}] dropout 0: losses cuda {cl} cpu {pl}: max rel err {loss_err:.2e}; "
          f"first gradients of {len(held)} tensors: max norm-relative err "
          f"{grad_errs[-1][0]:.2e} (largest: "
          + ", ".join(f"{n} {e:.2e}" for e, n in grad_errs[-3:]) + "); parameters after 3 "
          f"micro-steps: all {len(sd)} as one vector norm-relative err {param_err:.2e}; of "
          f"the {len(held)} held, max {tensor_errs[-1][0]:.2e} (largest: "
          + ", ".join(f"{n} {e:.2e}" for e, n in tensor_errs[-3:])
          + f"); {moved}/{len(csd)} tensors moved; K1 launches (fwd, dq, dkv) cuda {claunch} "
          f"(expected {expected}) cpu {plaunch}", flush=True)
    if not (loss_err <= 1e-4 and grad_errs[-1][0] <= 1e-4 and tensor_errs[-1][0] <= 1e-4
            and moved == len(csd)):
        fail(f"{tag}: classifier training parity CUDA vs CPU")
    if claunch != expected or max(plaunch) != 0:
        fail(f"{tag}: launches cuda {claunch} != {expected}, cpu {plaunch}")


def phase_vision_parity() -> None:
    """Phase 17: the full-width vit-b-16 classifier (12 labels) at 2 layers,
    float32, batch 8.  Dropout 0, on the card (K1 forward, dQ and dK/dV:
    exactly 2 of each a micro-step) and on the CPU (plain versions): the
    first batch's gradient of every tensor within 1e-4 relative in norm
    (but the key biases, whose gradient is rounding alone: phase 8), then
    three micro-steps with accumulation 2 with the same losses (1e-4
    relative) and parameters (each tensor within 1e-4 relative in norm, but
    the key biases: AdamW turns their rounding-alone gradients into full
    steps of either sign).  Dropout 0.1 (the configs'): a training micro-step launches
    no K1 kernel; a CUDA generator's masks are bitwise equal on a rerun with
    its seed, another seed's are not; the keep rate lies within 4 sigma of
    0.9."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops.attention import dropout
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_classifier_train_step,
    )

    cfg = dataclasses.replace(ViTConfig.preset("vit-b-16", num_labels=12), num_hidden_layers=2,
                              dtype=torch.float32)
    model0 = init_random_weights_(ViTForImageClassification(cfg),
                                  torch.Generator().manual_seed(SEED))
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    batches = _vision_batches(3, 8, 12, SEED)
    _classifier_parity("vision-parity", cfg, sd, batches)

    drop_cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.1,
                                   attention_probs_dropout_prob=0.1, dtype=torch.bfloat16)
    with torch.device("cuda"):
        model = ViTForImageClassification(drop_cfg)
    model.load_state_dict(sd, strict=True)
    state = TrainState(model=model, optimizer=build_optimizer(model, 1e-4, weight_decay=0.1,
                                                              max_grad_norm=1.0))
    step = make_classifier_train_step(model, torch.Generator(device="cuda").manual_seed(SEED))
    before = _k1_counts(fa)
    for batch in batches[:2]:
        state, m = step(state, to_device(batch, "cuda"))
    drop_launched = tuple(n - b for n, b in zip(_k1_counts(fa), before))
    x = torch.ones(4_000_000, device="cuda")
    masks = [dropout(x, 0.1, torch.Generator(device="cuda").manual_seed(seed), False) != 0
             for seed in (7, 7, 8)]
    keep = masks[0].float().mean().item()
    sigma = (0.1 * 0.9 / x.numel()) ** 0.5
    same, other = torch.equal(masks[0], masks[1]), torch.equal(masks[0], masks[2])
    print(f"[vision-parity] dropout 0.1, bf16: K1 launches in 2 training micro-steps "
          f"{drop_launched}, loss {float(m['loss']):.4f}; CUDA generator masks: same seed "
          f"bitwise equal {same}, another seed equal {other}; keep rate {keep:.6f} "
          f"(0.9 +- 4 sigma = {4 * sigma:.6f})", flush=True)
    if drop_launched != (0, 0, 0) or not np.isfinite(float(m["loss"])):
        fail(f"vision parity with dropout: K1 launches {drop_launched}")
    if not (same and not other and abs(keep - 0.9) <= 4 * sigma):
        fail("vision parity: dropout masks")


def phase_vision_slice(report: dict, root: str, images_per_color: int = 64) -> str:
    """Phase 18: the port's vision trainer CLI (``vision_training.main``) on
    experiments/vision/color/12_colors_3k.yaml as it stands (vit-b-16 at
    224, bf16, dropout 0.1, batch 64, 4 micro-steps an update), one epoch on
    a generated 12-color dataset of ``images_per_color`` images a color.
    Checks the reference-format lines, both checkpoints loading strict into
    the port's classifier, finite losses and exact K1 launches: 12 a
    validation or test batch, none in a training micro-step (dropout takes
    the dense branch).  Returns the path of its ``best_model.pt``."""
    import contextlib
    import io

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.vision_training import main as vision_main

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, images_per_color)
    results = os.path.join(root, "results")
    cfg = _write_config(VISION_CONFIG, root, {"data_dir": data_dir, "mapping_path": data_dir,
                                              "results_dir": results, "epochs": "1"})
    parsed = VisionTrainingConfig.from_params(cfg["parsed"])
    print(f"[vision] {images_per_color} images per color generated ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s; config {parsed.hidden_size} wide, "
          f"{parsed.num_hidden_layers} layers, batch {parsed.batch_size}, effective "
          f"{parsed.effective_batch_size}, dropout {parsed.hidden_dropout_prob} / "
          f"{parsed.attention_dropout_prob}, {parsed.num_workers} loader workers", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                ac.attention_core_fwd, ac.attention_core_bwd)
    for fn in counters:
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = vision_main(["--config_path", cfg["path"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = tuple(fn.launches for fn in counters)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[vision-cli] {line}", flush=True)

    b = parsed.batch_size
    micro = sizes["train"] // b  # drop_last
    evals = -(-sizes["val"] // b) + -(-sizes["test"] // b)
    expected = (parsed.num_hidden_layers * evals, 0, 0, 0, 0)
    epoch = out["history"][0]
    lines_ok = all(re.search(p, text, re.M) for p in (
        r"^Epoch 1/1 completed in \d+\.\d\ds$",
        r"^Train Loss: \d+\.\d{4}, Train Acc: \d+\.\d\d%$",
        r"^Val Loss: \d+\.\d{4}, Val Acc: \d+\.\d\d%$", r"^Learning Rate: \d\.\d{6}$",
        r"^Best val loss: \d+\.\d{4}$", r"^Test Results:$", r"^Test Loss: \d+\.\d{4}$",
        r"^Test Accuracy: \d+\.\d\d%$"))
    models = os.path.join(results, "models")
    vcfg = ViTConfig.from_training_config(parsed)  # num_labels 12, the dataset's classes
    loaded = []
    for name in ("best_model.pt", "final_model.pt"):
        with torch.device("meta"):
            clf = ViTForImageClassification(vcfg)
        sd = load_state_dict(os.path.join(models, name))
        clf.load_state_dict(sd, strict=True, assign=True)
        loaded.append(all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in sd.values()))
    finite = all(np.isfinite(epoch[k]) for k in ("train_loss", "val_loss")) and np.isfinite(
        out["test_loss"])
    steps_s = epoch["micro_steps"] / epoch["train_time"]
    print(f"[vision] one epoch: {epoch['micro_steps']} micro-steps (batch {b}, "
          f"{parsed.effective_batch_size // b} per update) in {epoch['train_time']:.3f} s: "
          f"{steps_s:.3f} micro-steps/s, {b * steps_s:.1f} images/s; epoch wall time (train + "
          f"val) {epoch['epoch_time']:.3f} s; whole CLI run {wall:.1f} s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"[vision] train loss {epoch['train_loss']:.4f}, val loss {epoch['val_loss']:.4f}, "
          f"test {out['test_loss']:.4f} / {out['test_acc']:.2f}%; launches (K1 fwd, dq, dkv, "
          f"K2 fwd, bwd) {launches} (expected {expected}: one a layer of a val or test "
          f"batch, 0 a training micro-step); lines {bool(lines_ok)}; checkpoints load strict {loaded}",
          flush=True)
    if not (lines_ok and all(loaded) and finite and epoch["micro_steps"] == micro):
        fail("vision slice checks")
    if launches != expected:
        fail(f"vision slice launches {launches} != {expected}")
    return os.path.join(models, "best_model.pt")


def phase_analysis(root: str) -> None:
    """Phase 19 (after phase 15, on phase 7's results dir): the port's
    token-embedding analysis CLI prints the RGB-vs-embedding Pearson r,
    finite; without matplotlib it prints that the figures were skipped."""
    import contextlib
    import io

    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
        FIGURES_SKIPPED,
        pyplot,
    )
    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis import (
        main as analysis_main,
    )

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = analysis_main(["--results_dir", os.path.join(root, "results"),
                           "--output_dir", os.path.join(root, "analysis")])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[analysis] {line}", flush=True)
    skipped = FIGURES_SKIPPED in text
    print(f"[analysis] Pearson r {r:.6f} in {wall:.1f} s; matplotlib installed "
          f"{pyplot() is not None}, figures skipped line {skipped}", flush=True)
    if not (np.isfinite(r) and "Pearson correlation coefficient:" in text):
        fail("analysis: no finite Pearson r")
    if skipped != (pyplot() is None):
        fail("analysis: the figures-skipped line does not match matplotlib's presence")


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


def _clip_parity(tag: str, fused: bool, expected: dict, rows=None, bf16: bool = False,
                 tol: float = 1e-4) -> dict:
    """Full widths (ViT-B/32; text 512 wide, 8 heads), 2 vision + 2 text
    layers, float32, batch 8, the JAX initialisers, on the card (kernels)
    and on the CPU (plain versions): the first batch's gradient of every
    tensor within 1e-4 relative in norm; then three train steps with the
    same losses (1e-4 relative) and parameters (1e-4 relative in norm).
    ``fused`` puts the vision tower on K6; the card's launch counts over the
    four passes must equal ``expected`` (every other CLIP kernel 0), the
    CPU's all 0.  ``rows`` partitions the text embedding
    (``active_vocab_rows``); ``bf16`` stores the parameters in bf16 with
    float32 masters (``bf16_params``), and ``tol`` then bounds losses,
    gradients and parameters alike.  Returns the card's run: {"losses",
    "state" (host tensors after the steps), "init" (before), "launches"}.

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
    base = CLIPConfig.create(vocab_size=len(tokenizer), dtype=torch.float32,
                             active_vocab_rows=rows)
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
        if bf16:
            for p in model.parameters():
                p.data = p.data.to(torch.bfloat16)
        before = {n: fn.launches for n, fn in counters.items()}
        first = to_device(batches[0], dev)
        contrastive_loss(*model(images_from_batch(first), first["input_ids"],
                                first["attention_mask"])).backward()
        grads = {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
        model.zero_grad(set_to_none=True)
        opt = build_optimizer(model, 5e-4, weight_decay=0.2, max_grad_norm=1.0,
                              fp32_master=bf16)
        state, step = TrainState(model=model, optimizer=opt), make_clip_train_step(model)
        losses = []
        for batch in batches:
            state, m = step(state, to_device(batch, dev))
            losses.append(float(m["loss"]))
        launched = {n: fn.launches - before[n] for n, fn in counters.items()}
        runs[dev] = (losses, grads,
                     {k: v.detach().float().cpu() for k, v in model.state_dict().items()},
                     launched, {k: v.cpu() for k, v in (opt.master or {}).items()})
    (cl, cg, csd, claunch, cmaster), (pl, pg, psd, plaunch, _) = runs["cuda"], runs["cpu"]
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
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    init = {n: (t.bfloat16() if bf16 else t).float() for n, t in sd.items()}
    # bf16: a step may stay below half a bf16 ulp (a LayerNorm scale at 1.0), so the
    # float32 masters show the motion
    after = dict(csd, **cmaster)
    moved = all(torch.equal(after[n], init[n]) == (n in frozen) for n in sd)
    shown = {n: c for n, c in claunch.items() if c or expected.get(n)}
    print(f"[{tag}] losses cuda {cl} cpu {pl}: max rel err {loss_err:.2e}; first "
          f"gradients of {len(held)} tensors: max norm-relative err {grad_errs[-1][0]:.2e} "
          f"(largest: " + ", ".join(f"{n} {e:.2e}" for e, n in grad_errs[-3:]) + "); "
          f"parameters after 3 steps: norm-relative err {param_err:.2e}, largest tensor "
          + ", ".join(f"{n} {e:.2e}" for e, n in tensor_errs[-3:]) + f"; every trained tensor "
          f"moved and the frozen ones {sorted(frozen)} bitwise unchanged {moved}; kernel "
          f"launches cuda {shown} (expected {expected}), cpu {sum(plaunch.values())}; "
          f"tolerance {tol:g}", flush=True)
    if not (loss_err <= tol and grad_errs[-1][0] <= tol and param_err <= tol and moved):
        fail(f"{tag}: CLIP training parity CUDA vs CPU")
    if claunch != {n: expected.get(n, 0) for n in counters} or any(plaunch.values()):
        fail(f"{tag} launches: cuda {claunch} (expected {expected}), cpu {plaunch}")
    return {"losses": cl, "state": csd, "init": init, "launches": claunch}


CLIP_PARITY_K2 = {"attention_core_fwd": 16, "attention_core_bwd": 16}


def phase_clip_parity() -> dict:
    """Phase 8: the default CLIP (K2 in both towers): 4 passes x (2 vision
    + 2 text) layers of K2 forward and backward.  Returns the card's run."""
    return _clip_parity("clip-parity", False, CLIP_PARITY_K2)


def phase_partitioned_parity(dense: dict) -> None:
    """Phase 25: phase 8's CLIP with its text embedding partitioned
    (``active_vocab_rows``: every id of phase 8's batches, padding
    included).  On the card and the CPU, three steps at phase 8's
    tolerances (``_clip_parity``); the card's partitioned run merged
    (``merged_embedding`` with the inactive rows' decay) against phase 8's
    dense card run ``dense`` (the same initial table) at
    tests/test_sparse_embed.py's bounds, rtol 2e-5 and atol 1e-7 (key
    biases, which softmax leaves rounding alone to move: 3 lr); the frozen
    table bitwise unchanged; K2 launches equal to the dense run's.  Then the
    same three steps under ``bf16_params``, card against CPU, within 1e-2: a
    bf16 gradient or parameter one ulp (2^-8 relative) apart in two float32
    summation orders moves AdamW's update by as much, so two ulps (7.8e-3)
    rounded up."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import (
        active_rows_from_corpus,
        inactive_decay,
        merged_embedding,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    tokenizer = load_tokenizer("concept-tokenizer")
    batches = _noise_batches(len(tokenizer), tokenizer.pad_token_id, 3, 8, SEED)
    rows = active_rows_from_corpus([b["input_ids"] for b in batches])
    run = _clip_parity("partitioned-parity", False, CLIP_PARITY_K2, rows=rows)
    table, active = "text.token_embedding.weight", "text.token_embedding.active"
    psd, dsd = run["state"], dense["state"]
    merged = merged_embedding(psd[table], psd[active], rows,
                              inactive_decay([5e-4] * 3, 0.2))
    worst, bitwise, largest = (float("-inf"), ""), 0, 0.0
    for name, want in dsd.items():
        got = merged if name == table else psd[name]
        err = ((got - want).abs() - 1e-7 - 2e-5 * want.abs()).max().item()
        if name.endswith(("key.bias", ".k.bias")):
            err = (got - want).abs().max().item() - 3 * 5e-4
        worst = max(worst, (err, name))
        bitwise += torch.equal(got, want)
        largest = max(largest, (got - want).abs().max().item())
    frozen_same = torch.equal(psd[table], run["init"][table])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], dense["losses"]))
    print(f"[partitioned-parity] {len(rows)} active rows of {len(tokenizer)}: merged against "
          f"phase 8's dense card run: {bitwise} of {len(dsd)} tensors bitwise equal, largest "
          f"difference {largest:.3e}, worst excess over rtol 2e-5 / atol 1e-7 {worst[0]:.3e} "
          f"({worst[1]}), losses rel err {loss_err:.2e}; frozen table bitwise unchanged "
          f"{frozen_same}; K2 launches {run['launches']} vs dense {dense['launches']}",
          flush=True)
    if not (worst[0] <= 0 and loss_err <= 1e-5 and frozen_same):
        fail("partitioned CLIP against the dense run on the card")
    if run["launches"] != dense["launches"]:
        fail(f"partitioned launches {run['launches']} != dense {dense['launches']}")
    _clip_parity("partitioned-parity bf16_params", False, CLIP_PARITY_K2, rows=rows, bf16=True,
                 tol=1e-2)


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


def _steady_step_ms(state, steps: int = 3, batch=None) -> float:
    """ms per train step of ``state.model`` on one fixed device batch
    (``batch``, or the slice's circles and captions; no input path), after
    one warm-up step; the model trains on."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel.train_step import make_clip_train_step
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer

    if batch is None:
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
    return {"config": config, "data_dir": data_dir, "launches": launches,
            "steps_per_s": rate, "images_per_s": CLIP_BATCH * rate,
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
                "flash_fwd", "flash_bwd", "paged_")  # the port's attention kernels, by name
K1_GROUPS = {"K1 forward": "flash_fwd", "K1 dQ": "flash_bwd_dq",
             "K1 dK/dV": "flash_bwd_dkv"}  # K1's kernels by name, both dtypes


def _clip_step_setup(variant: bool = False):
    """(config, tokenizer, state, step, batch): the full CLIP train step
    (batch 256, bf16 compute, the trainer's optimizer) on a fixed device
    batch; ``variant``: the fused vision tower (K6, K2-bd)."""
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
    model = (_variant_model(config, len(tokenizer)) if variant
             else init_model(config, len(tokenizer), "cuda"))
    opt = build_optimizer(model, config.learning_rate, weight_decay=config.weight_decay,
                          max_grad_norm=config.max_grad_norm)
    return (config, tokenizer, TrainState(model=model, optimizer=opt),
            make_clip_train_step(model), batch)


def profile_clip(steps: int = 6, warmup: int = 4) -> None:
    """``--profile``: the full CLIP train step (batch 256, bf16 compute, the
    trainer's optimizer) on a fixed device batch, on the default path (K2)
    and on the kernel variants (fused vision tower under
    MCL_ATTN_CORE_BD=1: K6 and K2-bd), then the input path alone."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader

    config, tokenizer, state, step, batch = _clip_step_setup()
    _profile_step("default", state, step, batch, steps, warmup, CLIP_BATCH, "images")
    del state, step
    torch.cuda.empty_cache()
    os.environ["MCL_ATTN_CORE_BD"] = "1"
    try:
        _, _, state, step, batch = _clip_step_setup(variant=True)
        _profile_step("variant", state, step, batch, steps, warmup, CLIP_BATCH, "images")
    finally:
        del os.environ["MCL_ATTN_CORE_BD"]
    def clip_loader(train):
        return BatchLoader(train, batch_size=CLIP_BATCH, shuffle=True, drop_last=True,
                           seed=config.seed, collate_fn=ClipCollator(
                               tokenizer, config.caption_template, config.context_length))

    _time_loader(config, clip_loader, 108, True)


def _mllm_step_setup():
    """(config, state, step, batch): the full 12_colors_3k MLLM micro-step
    (batch 2, bf16 compute, the trainer's optimizer with 4 micro-steps an
    update, the vision tower and the LM's non-embedding weights frozen) on a
    fixed device batch."""
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
    return config, TrainState(model=model, optimizer=opt), make_mllm_train_step(model), batch


def profile_mllm(root: str, steps: int = 6, warmup: int = 4) -> None:
    """``--profile-mllm [ROOT]``: ``_mllm_step_setup``'s micro-step from the
    port package of the checkout at ``root`` (``sys.path`` puts it first; a
    parent checkout, which has no such flag, is profiled this way), with
    K1's forward, dQ and dK/dV in ms a micro-step."""
    print(f"[ab] kernels of {os.path.abspath(root)}", flush=True)
    config, state, step, batch = _mllm_step_setup()
    _profile_step("mllm", state, step, batch, steps, warmup, config.batch_size, "samples",
                  groups=K1_GROUPS)


def _vision_step_setup():
    """(config, state, step, batch): one micro-step of the vision trainer
    at its slice's shape (experiments/vision/color/12_colors_3k.yaml:
    vit-b-16 at 224, bf16, dropout 0.1, batch 64, 4 micro-steps an update)
    on a fixed device batch, with the CLI's model, optimizer and step."""
    import torch

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_classifier_train_step,
    )
    from multimodal_concept_learning_tpu_torch.train.vision_training import init_model

    with open(VISION_CONFIG) as f:
        config = VisionTrainingConfig.from_params(miniyaml.safe_load(f))
    model = init_model(config, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    opt = build_optimizer(model, config.learning_rate, weight_decay=config.weight_decay,
                          max_grad_norm=1.0,
                          accumulation_steps=config.effective_batch_size // config.batch_size)
    step = make_classifier_train_step(model, torch.Generator(device="cuda").manual_seed(SEED))
    batch = to_device(_vision_batches(1, config.batch_size, config.num_labels, SEED)[0], "cuda")
    return config, TrainState(model=model, optimizer=opt), step, batch


def profile_vision(steps: int = 6, warmup: int = 4) -> None:
    """``--profile-vision``: ``_vision_step_setup``'s micro-step, then the
    CLI's input path alone."""
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader

    config, state, step, batch = _vision_step_setup()
    print(f"[profile vision] vit-b-16 classifier, batch {config.batch_size}, dropout "
          f"{config.hidden_dropout_prob} / {config.attention_dropout_prob}, bf16 compute",
          flush=True)
    _profile_step("vision", state, step, batch, steps, warmup, config.batch_size, "images",
                  groups=K1_GROUPS)

    def vision_loader(train):  # the CLI's train loader
        return BatchLoader(train, batch_size=config.batch_size, shuffle=True, drop_last=True,
                           seed=config.seed, num_workers=config.num_workers,
                           prefetch_batches=config.prefetch_factor,
                           uint8_images=config.device_normalize)

    _time_loader(config, vision_loader, 128, False)


def profile_decode(root: str, steps: int = 6, warmup: int = 4, int8_kv: bool = False) -> None:
    """``--profile-decode [ROOT]``: the paged decode step of the full-width
    gemma3-1b MLLM (seeded random weights, bf16) at batch 8 on a fixed
    batch: prompts of 197 vision + 65-72 text tokens (262-269, the serving
    shape) prefilled into pages of 16, then decode steps that each attend
    the same positions (lengths held, one token written at each row's next
    slot), each step's next token by argmax; from the port package of the
    checkout at ``root`` (``sys.path`` puts it first; a parent checkout is
    profiled this way).  K3 unless ``MCL_PAGED_KERNEL=2`` (K4); with
    ``int8_kv`` the pools are int8, read by a gather, a dequantize and K1.
    Prints the unprofiled ms a step, device busy, idle share and the
    attention kernel's ms a step."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig
    from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
        init_paged_kv_cache,
        pages_needed,
    )

    kernel = "K4" if os.environ.get("MCL_PAGED_KERNEL") == "2" else "K3"
    if int8_kv:
        kernel = "K1"
    print(f"[ab] kernels of {os.path.abspath(root)}; paged decode through {kernel}"
          f"{' over int8 pools' if int8_kv else ''}", flush=True)
    cfg = MLLMConfig.create(vocab_size=1148)
    with torch.device("cuda"):
        model = MLLM(cfg)
    init_random_weights_(model, torch.Generator(device="cuda").manual_seed(SEED))
    cast_for_compute(model, cfg.dtype)
    model.eval()
    rng = np.random.default_rng(SEED)
    b, text = 8, [65 + i for i in range(8)]
    t = cfg.num_vision_tokens + max(text)
    ids = rng.integers(4, cfg.lm.vocab_size, size=(b, t - cfg.num_vision_tokens))
    mask = np.zeros_like(ids)
    for i, n in enumerate(text):
        mask[i, :n] = 1
    ids[mask == 0] = 0
    mask = np.concatenate([np.ones((b, cfg.num_vision_tokens), mask.dtype), mask], axis=1)
    ids = np.concatenate([np.zeros((b, cfg.num_vision_tokens), ids.dtype), ids], axis=1)
    images = np.stack([_circle([255 - 30 * i, 30 * i, 128]) for i in range(b)])
    images, ids, mask = (torch.from_numpy(x).to("cuda") for x in (images, ids, mask))
    ids, mask = ids.to(torch.int32), mask.to(torch.int32)
    lm = model.language_model
    np_max = pages_needed(t + 9, 16)
    pools = init_paged_kv_cache(lm.cfg, 1 + b * np_max, 16, device="cuda", quantized=int8_kv)
    pt = torch.arange(1, 1 + b * np_max, dtype=torch.int32, device="cuda").reshape(b, np_max)
    rows = torch.arange(b, device="cuda")
    with torch.inference_mode():
        hidden = model.prefill_paged(images, ids, mask, pools, pt)
        seq = mask.sum(dim=1).to(torch.int32)
        tok = torch.argmax(lm.lm_head(hidden[rows, seq.long() - 1]), dim=-1).to(torch.int32)
    print(f"[profile decode] rows of {seq.tolist()} tokens, {np_max} pages of 16 a row, "
          f"{lm.cfg.num_layers} layers", flush=True)

    def step(tok, _batch):
        with torch.inference_mode():
            h = lm.decode_step_paged(lm.embed(tok[:, None]), pools, pt, seq)
            nxt = torch.argmax(lm.lm_head(h[:, 0]), dim=-1).to(torch.int32)
        return nxt, {"token": nxt[0]}

    frag = {"K4": "paged_mp_kernel", "K3": "paged_decode_kernel", "K1": "flash_fwd"}[kernel]
    _profile_step("decode", tok, step, None, steps, warmup, b, "tokens",
                  groups={kernel: frag}, note="token")


def _profile_step(tag: str, state, step, batch, steps: int, warmup: int, batch_size: int,
                  unit: str, groups: dict = None, note: str = "loss") -> None:
    """Steady ms per step unprofiled; a ``torch.profiler`` window of
    ``steps`` steps tracing the card only: device busy time (union of kernel
    intervals) and the idle share, against the unprofiled step and against
    the window's own wall time; then a window tracing host and card: aten
    ops per step, device time by kernel (the port's kernels and the matrix
    products summed, and each of ``groups``: {label: name fragment}), and
    how far host tracing stretches the step.  ``note``: the key of the
    step's metrics printed beside the unprofiled step."""
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
          f"{batch_size * 1e3 / step_ms:.1f} {unit}/s ({note} {float(m[note]):.4f})", flush=True)

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


def _time_loader(config, make_loader, images_per_color: int, return_synset: bool) -> None:
    """A CLI's input path alone: one epoch of the train loader that
    ``make_loader(train_dataset)`` builds (PNG decode, the config's
    transforms, collation) over a generated 12-color dataset of
    ``images_per_color`` images a color (``return_synset``: the color names
    as labels, as CLIP's captions need), each batch moved to the card, no
    model.  The steady rate leaves out the first batch, which waits for the
    workers to fill."""
    import shutil
    import tempfile

    import torch

    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ColorDataset,
        load_split_datasets,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    root = tempfile.mkdtemp(prefix="_smoke_loader_", dir=REPO)
    try:
        data_dir, _ = _generate_colors(root, images_per_color)
        train, _, _ = load_split_datasets(ColorDataset, data_dir, data_dir,
                                          create_transforms(config, True, config.seed),
                                          create_transforms(config, False, config.seed),
                                          return_synset)
        loader = make_loader(train)
        stamps = [time.perf_counter()]
        for batch in loader:
            to_device(batch, "cuda")
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n, b, dt = len(stamps) - 1, loader.batch_size, stamps[-1] - stamps[0]
    steady = (f", the other {n - 1} {(n - 1) * b / (stamps[-1] - stamps[1]):.1f} images/s"
              if n > 1 else "")
    print(f"[profile] input path alone: {n} batches of {b} ({loader.num_workers} workers) in "
          f"{dt:.3f} s = {1e3 * dt / n:.1f} ms a batch, {n * b / dt:.1f} images/s; first batch "
          f"{1e3 * (stamps[1] - stamps[0]):.1f} ms{steady}", flush=True)


def _run_cli(tag: str, fn, argv: list):
    """(``fn(argv)``'s return, its stdout), each line printed under ``tag``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[{tag}] {line}", flush=True)
    return out, text


def _bench_caption_ids(rng, batch: int = 128, context: int = 77, n_classes: int = 96):
    """bench.py's CLIP captions (``_caption_ids``, bench.py:80-103): the
    templated ids, their mask and the active rows (numpy)."""
    template = np.asarray([49406, 320, 1125, 539, 320, 4532, 49407], np.int64)
    class_ids = 2 + rng.choice(40000, size=(n_classes, 2), replace=False)
    ids = np.zeros((batch, context), np.int64)
    mask = np.zeros((batch, context), np.int64)
    cls = rng.integers(0, n_classes, size=batch)
    for i in range(batch):
        row = np.concatenate([template[:-1], class_ids[cls[i]], template[-1:]])
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    active = tuple(int(t) for t in np.unique(
        np.concatenate([ids.ravel(), class_ids.ravel(), template])))
    return ids.astype(np.int32), mask.astype(np.int32), active


def _bench_clip_steps(card: str) -> None:
    """bench.py's CLIP cell (bench.py:66-71, 105-170: ViT-B/32 + 12 x 512
    text, vocab 49408, batch 128, context 77, its caption ids, noise images,
    AdamW lr 1e-4, weight decay 0.2, clipping 1.0), built by the port (bf16
    compute over float32 parameters, the seeded init on the card), dense and
    with the text embedding partitioned to the captions' rows: the steady
    step on one fixed device batch, dense / partitioned / dense /
    partitioned, 5 steps each after one warm-up.  A measurement, no claim."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import TrainState

    ids, mask, active = _bench_caption_ids(np.random.default_rng(1))
    images = np.random.default_rng(0).normal(size=(128, 3, 224, 224)).astype(np.float32)
    batch = to_device({"images": images, "input_ids": ids, "attention_mask": mask}, "cuda")
    states = {}
    for tag, rows in (("dense", None), ("partitioned", active)):
        cfg = CLIPConfig.create(vocab_size=49408, vision_preset="vit-b-32", image_size=224,
                                text_width=512, text_layers=12, text_heads=8, context_length=77,
                                embed_dim=512, dtype=torch.bfloat16, active_vocab_rows=rows)
        with torch.device("cuda"):
            model = CLIPModel(cfg)
        init_random_weights_(model, torch.Generator(device="cuda").manual_seed(SEED))
        states[tag] = TrainState(model=model, optimizer=build_optimizer(
            model, 1e-4, weight_decay=0.2, max_grad_norm=1.0))
    times = []
    for tag in ("dense", "partitioned", "dense", "partitioned"):
        times.append((tag, _steady_step_ms(states[tag], 5, batch)))
    print(f"[clip-bench-cell] {card}: steady step, bench.py's CLIP cell (batch 128, vocab "
          f"49408, {len(active)} active rows): " + ", ".join(f"{t} {ms:.2f} ms"
                                                              for t, ms in times), flush=True)


def phase_partitioned_clip_slice(root: str, clip_run: dict, card: str) -> None:
    """Phase 26: the contrastive CLI on a copy of
    experiments/contrastive/color/12_colors_3k.yaml with
    ``partition_text_embedding: true`` and ``bf16_params: true``, one epoch
    on phase 9's data: JAX's "Partitioned text embedding" line with the
    captions' rows, phase 9's exact K2 launches, a zero-shot accuracy, and
    the saved table the merged one (the subtable's rows; the other rows the
    initial bf16 table times the weight decay's product, rounded as JAX
    rounds it), which a dense model loads ``strict=True``.  Then
    ``_bench_clip_steps``."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
    from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops.sparse_embed import (
        active_rows_from_corpus,
        inactive_decay,
    )
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.train.contrastive_training import init_model, main

    sub = os.path.join(root, "partitioned")
    os.makedirs(sub)
    data_dir = clip_run["data_dir"]
    cfg = _write_config(CLIP_CONFIG, sub, {
        "mapping_path": os.path.join(data_dir, "train_mapping.csv"), "image_root": data_dir,
        "results_dir": os.path.join(sub, "results"), "epochs": "1",
        "partition_text_embedding": "true", "bf16_params": "true"})
    config = ContrastiveTrainingConfig.from_params(cfg["parsed"])
    assert config.partition_text_embedding and config.bf16_params and config.epochs == 1
    tokenizer = load_tokenizer("concept-tokenizer")
    collator = ClipCollator(tokenizer, config.caption_template, config.context_length)
    rows = active_rows_from_corpus([collator.caption_ids(n)[0] for n in sorted(_color_names())])
    torch.cuda.empty_cache()
    ac.attention_core_fwd.launches = ac.attention_core_bwd.launches = 0
    t0 = time.perf_counter()
    out, text = _run_cli("clip-partitioned-cli", main,
                         ["--config_path", cfg["path"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {"attention_core_fwd": ac.attention_core_fwd.launches,
                "attention_core_bwd": ac.attention_core_bwd.launches}
    line = f"Partitioned text embedding: {len(rows)} active rows of {len(tokenizer)}"
    state, epoch = out["state"], out["history"][0]
    emb = state.model.text.token_embedding
    sd = load_state_dict(out["checkpoint"])
    init = init_model(config, len(tokenizer), "cuda", rows).text.token_embedding.weight
    opt = state.optimizer
    lrs = [float(np.float32(opt.lr(i))) for i in range(opt.count)]
    decay = torch.tensor(inactive_decay(lrs, config.weight_decay), dtype=torch.float32)
    want = (init.detach().bfloat16().float().cpu() * decay).bfloat16().float()
    want[list(rows)] = emb.active.detach().float().cpu()
    merged = torch.equal(sd["text.token_embedding.weight"], want)
    frozen = torch.equal(emb.weight, init.detach().bfloat16())
    with torch.device("meta"):
        dense = CLIPModel(dataclasses.replace(state.model.cfg, active_vocab_rows=None))
    dense.load_state_dict(sd, strict=True, assign=True)
    acc = out["zero_shot_acc"]
    print(f"[clip-partitioned] {card}: one epoch, {epoch['steps']} steps of batch "
          f"{config.batch_size}, bf16 parameters, {len(rows)} active rows, in "
          f"{epoch['epoch_time']:.3f} s ({epoch['steps'] / epoch['epoch_time']:.3f} steps/s; "
          f"phase 9 dense {clip_run['steps_per_s']:.3f}); whole CLI {wall:.1f} s; train loss "
          f"{epoch['train_loss']}, zero-shot {acc}%; log line {line in text}; saved table "
          f"merged (decay {decay.item():.9f} over {opt.count} updates) {merged}; frozen "
          f"table unchanged {frozen}; K2 launches {launches} (phase 9 "
          f"{clip_run['launches']})", flush=True)
    del out, state, emb, init, dense
    if not (line in text and merged and frozen and np.isfinite(epoch["train_loss"])
            and 0.0 <= acc <= 100.0 and decay.item() < 1.0):
        fail("partitioned bf16_params CLIP CLI checks")
    if launches != clip_run["launches"]:
        fail(f"partitioned CLI launches {launches} != phase 9's {clip_run['launches']}")
    _bench_clip_steps(card)


def _snapshot(state) -> dict:
    """A TrainState's model and optimizer tensors (clones on their device)."""
    flat = {f"model.{k}": v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for key in ("mu", "nu", "master", "acc"):
        flat.update({f"{key}.{n}": t.clone() for n, t in (opt[key] or {}).items()})
    return flat


def _same_run(tag: str, got: dict, want: dict, tol: float = 1e-4) -> str:
    """'bitwise' when every tensor is equal; else every tensor within
    ``tol`` relative in norm (phases 6 and 17's bound), or fail."""
    import torch

    assert sorted(got) == sorted(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if not differ:
        return "bitwise"
    errs = sorted((((got[k].float() - want[k].float()).norm()
                    / want[k].float().norm().clamp(min=1e-30)).item(), k) for k in differ)
    print(f"[{tag}] {len(differ)} of {len(want)} tensors not bitwise equal; largest "
          f"norm-relative differences " + ", ".join(f"{k} {e:.2e}" for e, k in errs[-3:]),
          flush=True)
    if errs[-1][0] > tol:
        fail(f"{tag}: resumed run against the uninterrupted one beyond {tol:g}")
    return f"within {tol:g} relative in norm, not bitwise"


VISION_RESUME_IMAGES = 28  # a color: 264 train images, 4 micro-steps of 64, one update
MM_RESUME_IMAGES = 4  # a color, a cut of phase 7's 8: 18 micro-steps and 6 eval batches


def phase_vision_resume(root: str, card: str) -> None:
    """Phase 27: the vision CLI on experiments/vision/color/12_colors_3k.yaml
    at full width (vit-b-16, dropout 0.1, batch 64, 4 micro-steps an update)
    with ``resume: true``, one epoch on ``VISION_RESUME_IMAGES`` images a
    color: uninterrupted, then in a subprocess that sends itself SIGTERM
    after micro-step 2 (between two micro-steps of an accumulation) and
    saves, then resumed in this process (the dropout generator restored):
    JAX's lines, the resumed run's K1 launches (12 a val or test batch, none
    in a dropout micro-step), and its final model and optimizer against the
    uninterrupted run's (``_same_run``)."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.vision_training import main as vision_main

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, VISION_RESUME_IMAGES)
    paths = {}
    for tag in ("uninterrupted", "resumed"):
        os.makedirs(os.path.join(root, tag))
        cfg = _write_config(VISION_CONFIG, os.path.join(root, tag), {
            "data_dir": data_dir, "mapping_path": data_dir, "epochs": "1", "resume": "true",
            "results_dir": os.path.join(root, tag, "results")})
        paths[tag] = cfg["path"]
    b = cfg["parsed"]["batch_size"]
    print(f"[vision-resume] {sizes} images generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = ["--device", "cuda", "--config_path"]
    ref, _ = _run_cli("vision-resume uninterrupted", vision_main, argv + [paths["uninterrupted"]])
    want = _snapshot(ref["state"])
    del ref
    torch.cuda.empty_cache()
    code = (
        "import json, os, signal, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from multimodal_concept_learning_tpu_torch.train import vision_training as vt\n"
        "make = vt.make_classifier_train_step\n"
        "def preempting(*args, **kwargs):\n"
        "    step, n = make(*args, **kwargs), [0]\n"
        "    def run(state, batch):\n"
        "        out = step(state, batch)\n"
        "        n[0] += 1\n"
        "        if n[0] == 2:\n"
        "            os.kill(os.getpid(), signal.SIGTERM)\n"
        "        return out\n"
        "    return run\n"
        "vt.make_classifier_train_step = preempting\n"
        f"print('RESULT', json.dumps(vt.main({argv + [paths['resumed']]!r})))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"[vision-resume preempted] {line}", flush=True)
    preempted_ok = (proc.returncode == 0 and 'RESULT {"preempted": true}' in proc.stdout
                    and "Preempted (SIGTERM): saved mid-epoch checkpoint (epoch 1, batch 2); "
                        "exiting" in proc.stdout)
    print(f"[vision-resume] the preempted subprocess: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; lines {preempted_ok}", flush=True)
    if not preempted_ok:
        fail(f"vision preemption subprocess: {proc.stderr[-2000:]}")
    before = (fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, text = _run_cli("vision-resume resumed", vision_main, argv + [paths["resumed"]])
    launches = tuple(n - b for n, b in zip((fa.flash_attention.launches,
                                           fa.flash_attention_bwd_dq.launches,
                                           fa.flash_attention_bwd_dkv.launches), before))
    evals = -(-sizes["val"] // b) + -(-sizes["test"] // b)
    expected = (cfg["parsed"]["num_hidden_layers"] * evals, 0, 0)
    resume_dir = os.path.join(root, "resumed", "results", "resume")
    line = (f"Resuming from epoch 0 checkpoint in {resume_dir} (mid-epoch: skipping 2 "
            f"batches)")
    how = _same_run("vision-resume", _snapshot(out["state"]), want)
    print(f"[vision-resume] {card}: resumed run against the uninterrupted one: {how}; resume "
          f"line {line in text}; K1 launches (fwd, dq, dkv) {launches} (expected {expected}); "
          f"micro-steps after the resume {out['history'][0]['micro_steps']}", flush=True)
    if not (line in text and "Epoch 1/1 completed in" in text):
        fail("vision resume lines")
    if launches != expected or out["history"][0]["micro_steps"] != sizes["train"] // b - 2:
        fail(f"vision resume launches {launches} != {expected}")


MM_RESUME_DEPTH = (2, 2)  # phase 28's ViT and LM layers


@contextlib.contextmanager
def _cut_depth(vision_layers: int, lm_layers: int):
    """The MLLM trainer CLI, and the serving loader behind the fronts and
    the answer CLI, build the model at these depths, widths kept: a
    full-depth MLLM checkpoint is ~3.1 GB, and what a call writes to its
    disk counts against a fixed budget even once deleted."""
    import dataclasses

    from multimodal_concept_learning_tpu_torch.serve import loader
    from multimodal_concept_learning_tpu_torch.train import multimodal_training as mt

    full = loader.model_config

    def cut(*args, **kwargs):
        cfg = full(*args, **kwargs)
        return dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=vision_layers),
            lm=dataclasses.replace(cfg.lm, num_layers=lm_layers))

    mt.model_config = loader.model_config = cut
    try:
        yield
    finally:
        mt.model_config = loader.model_config = full


def phase_mllm_resume(root: str, card: str) -> None:
    """Phase 28: the MLLM trainer CLI on experiments/multimodal/color/
    12_colors_3k.yaml at full width and ``MM_RESUME_DEPTH`` (vit-b-16 +
    gemma3-1b widths at 2 + 2 layers, bf16, batch 2, 4 micro-steps an
    update, constant learning rate) with ``resume: true`` on
    ``MM_RESUME_IMAGES`` images a color, every class mapped to an ``<ood N>``
    answer (a yes/no question draws from the collator's stream, which no
    checkpoint carries, in JAX as in the port: ROADMAP.md queue C):
    uninterrupted for 2 epochs; then 1 epoch, and the config extended to 2,
    resumed ("Resuming from epoch 0 checkpoint", no "Epoch 1/2"); the
    resumed run's K1 launches exact (one forward a layer of a micro-step or
    eval batch, one dQ and one dK/dV an LM layer of a micro-step), its final
    model and optimizer against the uninterrupted run's (``_same_run``).
    Its three runs write ~1 GB at this depth, ~20 GB at full depth."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    data_dir, sizes = _generate_colors(root, MM_RESUME_IMAGES)
    mapping = os.path.join(root, "ood_mapping.json")
    with open(mapping, "w") as f:
        json.dump({n: f"<ood {i + 1}>" for i, n in enumerate(_color_names())}, f)

    def config(tag: str, epochs: int) -> str:
        os.makedirs(os.path.join(root, tag), exist_ok=True)
        return _write_config(MM_CONFIG, os.path.join(root, tag), {
            "mapping_path": os.path.join(data_dir, "train_mapping.csv"), "image_root": data_dir,
            "labels_mapping_path": mapping, "results_dir": os.path.join(root, tag, "results"),
            "epochs": str(epochs), "num_workers": "2", "vision_path": "null",
            "resume": "true", "save_every_epoch": "false"})["path"]

    print(f"[mllm-resume] {sizes} images generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = ["--device", "cuda", "--config_path"]
    vision_layers, lm_layers = MM_RESUME_DEPTH
    with _cut_depth(vision_layers, lm_layers):
        ref, _ = _run_cli("mllm-resume uninterrupted", train_main, argv + [config("ref", 2)])
        want = _snapshot(ref[0])
        del ref
        torch.cuda.empty_cache()
        _run_cli("mllm-resume first epoch", train_main, argv + [config("run", 1)])
        torch.cuda.empty_cache()
        counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
        for fn in counters:
            fn.launches = 0
        out, text = _run_cli("mllm-resume resumed", train_main, argv + [config("run", 2)])
    launches = tuple(fn.launches for fn in counters)
    micro = sizes["train"] // 2
    evals = -(-sizes["val"] // 2) + -(-sizes["test"] // 2)
    expected = ((vision_layers + lm_layers) * (micro + evals), lm_layers * micro,
                lm_layers * micro)
    line = f"Resuming from epoch 0 checkpoint in {os.path.join(root, 'run', 'results', 'resume')}"
    how = _same_run("mllm-resume", _snapshot(out[0]), want)
    print(f"[mllm-resume] {card}: resumed run against the uninterrupted one: {how}; resume "
          f"line {line in text}; K1 launches (fwd, dq, dkv) {launches} (expected {expected}: "
          f"{micro} micro-steps, {evals} eval batches)", flush=True)
    del out
    torch.cuda.empty_cache()
    if not (line in text and "Epoch 2/2" in text and "Epoch 1/2" not in text):
        fail("MLLM resume lines")
    if launches != expected:
        fail(f"MLLM resume launches {launches} != {expected}")


REFERENCE_VOCAB = 262_144  # Gemma-3's vocabulary: the reference checkpoint's table rows


def phase_remap_chain(root: str, float_rows: list) -> None:
    """Phase 29: phase 7's trained ``best_model.pt``, its embedding rows
    scattered into a synthetic 262,144-row reference-layout table at
    shuffled ids (a synthetic source vocabulary, the port tokenizer's tokens
    at those ids and filler tokens elsewhere), remapped back by
    ``vocab_remap.remap_state_dict_vocab`` (bitwise the original) into a
    copy of phase 7's results dir, which the answer CLI (float) loads
    ``strict=True`` into the full MLLM on the card: the same JSONL rows as
    phase 15's float run on the weights loaded directly; then the analysis
    CLI (phase 19's) on it."""
    import shutil

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict, save_state_dict
    from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
    from multimodal_concept_learning_tpu_torch.vocab_remap import EMBED_KEY, remap_state_dict_vocab

    t0 = time.perf_counter()
    models = os.path.join(root, "results", "models")
    sd = load_state_dict(os.path.join(models, "best_model.pt"))
    dst_vocab = load_tokenizer(os.path.join(models, "tokenizer")).get_vocab()
    emb = sd[EMBED_KEY]
    assert sorted(dst_vocab.values()) == list(range(emb.shape[0]))
    rng = np.random.default_rng(SEED)
    src_ids = rng.permutation(REFERENCE_VOCAB)
    src_vocab = {f"<synthetic {i}>": int(i) for i in src_ids[emb.shape[0]:]}
    src_vocab.update({tok: int(src_ids[i]) for tok, i in dst_vocab.items()})
    table = torch.zeros(REFERENCE_VOCAB, emb.shape[1])
    table[torch.from_numpy(src_ids[:emb.shape[0]])] = emb
    reference = dict(sd, **{EMBED_KEY: table})
    remapped, copied = remap_state_dict_vocab(reference, src_vocab, dst_vocab,
                                              torch.zeros_like(emb))
    bitwise = sorted(remapped) == sorted(sd) and all(torch.equal(remapped[k], sd[k]) for k in sd)
    remap_root = os.path.join(root, "remap")
    out_models = os.path.join(remap_root, "results", "models")
    os.makedirs(out_models)
    shutil.copytree(os.path.join(models, "tokenizer"), os.path.join(out_models, "tokenizer"))
    shutil.copy(os.path.join(models, "training_config.json"), out_models)
    save_state_dict(remapped, os.path.join(out_models, "best_model.pt"))
    # a one-epoch run: its epoch checkpoint is its best one
    os.link(os.path.join(out_models, "best_model.pt"), os.path.join(out_models, "epoch_0_model.pt"))
    os.link(os.path.join(models, "initial_model.pt"), os.path.join(out_models, "initial_model.pt"))
    print(f"[remap] {len(src_vocab)}-token source vocabulary, a {tuple(table.shape)} table: "
          f"{copied} rows copied back, the state dict bitwise the original {bitwise}; in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del sd, table, reference, remapped
    if not (bitwise and copied == emb.shape[0] and len(src_vocab) == REFERENCE_VOCAB):
        fail("remap chain: the remapped state dict is not the original")
    rows = phase_answer_slice(remap_root, runs=ANSWER_RUNS[:1], prefix="remap-answers")["float"]
    same = rows == float_rows
    print(f"[remap] answer rows equal to phase 15's float rows on the weights loaded directly: "
          f"{same} ({len(rows)} rows)", flush=True)
    if not same:
        fail("remap chain: the answers differ from phase 15's")
    phase_analysis(remap_root)


JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
IMAGENET_CONFIGS = (
    ("vision", "experiments/vision/imagenet/imagenet100.yaml"),
    ("vision", "experiments/vision/imagenet/imagenet100_timm_settings.yaml"),
    ("multimodal", "experiments/multimodal/imagenet/imagenet1k_vit.yaml"),
    ("multimodal", "experiments/multimodal/imagenet/imagenet1k_timm_vit.yaml"),
)
IMAGENET_ROOT_WNID = "n00000001"  # the synthetic devkit's root synset


def jpeg_fixtures() -> list:
    """The fixture files of tests/data/jpeg (sorted; digests.json aside)."""
    return sorted(n for n in os.listdir(JPEG_FIXTURES) if n != "digests.json")


def write_imagenet_tree(root: str, names: dict, per_class: dict, n_val: int) -> str:
    """A synthetic ILSVRC2012 layout under ``root``, images copied from the
    JPEG fixtures in turn (a PNG named ``.JPEG`` among them, as ImageNet
    has): ``train/<wnid>/<wnid>_<j>.JPEG`` (``per_class[wnid]`` files; every
    wnid of ``names`` gets a directory), ``val/ILSVRC2012_val_<j>.JPEG``
    with ground truth round robin over the wnids that have training images,
    and ``ILSVRC2012_devkit_t12/data`` with ``words.txt`` (``names``),
    ``wordnet.is_a.txt`` (a root over two internal synsets over the wnids
    in turn), ``meta.mat`` written by ``scipy.io.savemat`` (ILSVRC2012_ID
    1..N in ``names`` order) and the val ground truth.  Returns ``root``."""
    import shutil

    import scipy.io

    files = [os.path.join(JPEG_FIXTURES, n) for n in jpeg_fixtures()]
    wnids = list(names)
    data = os.path.join(root, "ILSVRC2012_devkit_t12", "data")
    os.makedirs(data, exist_ok=True)
    mids = ("n00000002", "n00000003")
    with open(os.path.join(data, "words.txt"), "w") as f:
        f.write(f"{IMAGENET_ROOT_WNID}\tentity\n{mids[0]}\tgroup one\n{mids[1]}\tgroup two\n")
        for wnid in wnids:
            f.write(f"{wnid}\t{names[wnid]}\n")
    with open(os.path.join(data, "wordnet.is_a.txt"), "w") as f:
        f.write("".join(f"{IMAGENET_ROOT_WNID} {m}\n" for m in mids))
        f.write("".join(f"{mids[i % 2]} {w}\n" for i, w in enumerate(wnids)))
    dt = np.dtype([("ILSVRC2012_ID", "O"), ("WNID", "O")])
    synsets = np.zeros((len(wnids), 1), dtype=dt)
    for i, wnid in enumerate(wnids):
        synsets[i, 0] = (np.array([[i + 1]]), np.array([wnid]))
    scipy.io.savemat(os.path.join(data, "meta.mat"), {"synsets": synsets})
    k = 0
    for wnid in wnids:
        d = os.path.join(root, "train", wnid)
        os.makedirs(d, exist_ok=True)
        for j in range(per_class.get(wnid, 0)):
            shutil.copyfile(files[k % len(files)], os.path.join(d, f"{wnid}_{j}.JPEG"))
            k += 1
    os.makedirs(os.path.join(root, "val"), exist_ok=True)
    with_images = [i + 1 for i, w in enumerate(wnids) if per_class.get(w, 0)]
    truth = []
    for j in range(n_val):
        shutil.copyfile(files[(k + j) % len(files)],
                        os.path.join(root, "val", f"ILSVRC2012_val_{j + 1:08d}.JPEG"))
        truth.append(with_images[j % len(with_images)])
    with open(os.path.join(data, "ILSVRC2012_validation_ground_truth.txt"), "w") as f:
        f.write("".join(f"{t}\n" for t in truth))
    return root


def _load_training_config(kind: str, path: str):
    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.configs import (
        MultimodalTrainingConfig,
        VisionTrainingConfig,
    )

    cls = VisionTrainingConfig if kind == "vision" else MultimodalTrainingConfig
    with open(path) as f:
        return cls.from_params(miniyaml.safe_load(f))


def pipeline_digests(images: list, seeds) -> dict:
    """{config: {train|val: {seed: [sha256 of each output]}}}: the port's
    train and val pipelines of the four ImageNet configs over ``images``
    in order, one ``Compose`` per seed (tests/make_jpeg_fixtures.py records
    the JAX pipelines' digests the same way)."""
    import hashlib

    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    out = {}
    for kind, rel in IMAGENET_CONFIGS:
        config = _load_training_config(kind, os.path.join(REPO, rel))
        out[rel] = {split: {str(seed): [
            hashlib.sha256(np.ascontiguousarray(np.asarray(t(img), np.float32)).tobytes())
            .hexdigest()
            for t in [create_transforms(config, is_train=split == "train", seed=seed)]
            for img in images] for seed in seeds} for split in ("train", "val")}
    return out


def phase_imagenet_data(root: str) -> None:
    """Phase 30, on the host alone (this machine has no Pillow): every JPEG
    fixture decoded by the port (``data/jpeg.py``, its C++ built here) to
    the sha256 that Pillow's ``convert("RGB")`` gave when the fixtures were
    written; the train and val pipelines of the four ImageNet configs over
    the decoded fixtures at seeds 0 and 1 to the JAX pipelines' recorded
    digests (every op bitwise: ROADMAP.md lists none as bounded); ms an
    image of the decode alone at 500x375 (4:2:0, q75 and q95); and the
    loader alone (``BatchLoader``, 8 workers) on imagenet100's train
    pipeline at batch 64, images/s past the first batch."""
    import hashlib

    from multimodal_concept_learning_tpu_torch.data import jpeg
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    t0 = time.perf_counter()
    jpeg.build()
    print(f"[imagenet-data] JPEG decoder built in {time.perf_counter() - t0:.1f} s "
          f"({jpeg.library_path().name})", flush=True)
    with open(os.path.join(JPEG_FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    names = jpeg_fixtures()
    images, wrong = [], []
    for name in names:
        img = jpeg.read_image(os.path.join(JPEG_FIXTURES, name))
        images.append(img)
        want = digests["decode"][name]
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        if got != want["sha256"] or list(img.shape) != want["shape"]:
            wrong.append(name)
    print(f"[imagenet-data] {len(names) - len(wrong)} of {len(names)} fixtures decode to "
          f"Pillow's recorded sha256; wrong {wrong}", flush=True)
    if wrong or sorted(digests["decode"]) != names:
        fail(f"JPEG decode differs from Pillow's: {wrong}")
    t0 = time.perf_counter()
    got = pipeline_digests(images, digests["seeds"])
    seconds = time.perf_counter() - t0
    bad = [(rel, split, seed, i) for rel, per in digests["pipelines"].items()
           for split, by_seed in per.items() for seed, want in by_seed.items()
           for i, (a, b) in enumerate(zip(got[rel][split][seed], want)) if a != b]
    total = sum(len(w) for per in digests["pipelines"].values() for by_seed in per.values()
                for w in by_seed.values())
    print(f"[imagenet-data] pipelines (4 configs x train/val x seeds {digests['seeds']} x "
          f"{len(images)} images): {total - len(bad)} of {total} outputs equal to the JAX "
          f"pipelines' recorded sha256 in {seconds:.1f} s; different {bad[:8]}", flush=True)
    if bad or sorted(got) != sorted(digests["pipelines"]):
        fail("ImageNet pipelines differ from the JAX pipelines' digests")
    for name in ("q75_420_500x375.jpg", "q95_420_500x375.jpg"):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        jpeg.decode_jpeg(data)
        n = 50
        t0 = time.perf_counter()
        for _ in range(n):
            jpeg.decode_jpeg(data)
        print(f"[imagenet-data] decode alone, {name} ({len(data)} bytes): "
              f"{1e3 * (time.perf_counter() - t0) / n:.2f} ms an image (one thread)",
              flush=True)

    csv_path = os.path.join(root, "loader_mapping.csv")
    big = [n for n in names if n.startswith(("q75", "q95", "q90", "progressive_420"))]
    with open(csv_path, "w") as f:
        f.write("image_path,target_synset,class_name\n")
        for i in range(320):
            f.write(f"{big[i % len(big)]},n{i % 10:08d},class{i % 10}\n")
    config = _load_training_config("vision", os.path.join(REPO, IMAGENET_CONFIGS[0][1]))
    dataset = ImageNetDataset(csv_path, JPEG_FIXTURES, create_transforms(config, True, SEED),
                              verbose=False)
    loader = BatchLoader(dataset, 64, shuffle=True, drop_last=True, seed=SEED, num_workers=8,
                         prefetch_batches=2)
    stamps = [time.perf_counter()]
    for batch in loader:
        stamps.append(time.perf_counter())
    n = len(stamps) - 1
    shape = batch["images"].shape
    steady = (n - 1) * 64 / (stamps[-1] - stamps[1])
    print(f"[imagenet-data] loader alone (imagenet100 train pipeline: RandomResizedCrop 224, "
          f"flip, RandAugment 2 ops, ToTensor, Normalize, RandomErasing; 8 workers): {n} "
          f"batches of 64 {shape}, first batch {stamps[1] - stamps[0]:.3f} s, then "
          f"{steady:.1f} images/s (the vision micro-step takes 909-1003 images/s: PERF.md)",
          flush=True)
    if shape != (64, 3, 224, 224) or not np.isfinite(batch["images"]).all():
        fail(f"loader batch {shape}")


def _imagenet100_tree(root: str) -> tuple:
    """Phase 31's tree: the 100 target synsets of
    experiments/datasets/imagenet/imagenet100.yaml, 12 training images
    each and 100 val images; then the port's builder CLI on a copy of that
    YAML with only the paths and the per-class counts (11 train, 1 val, 1
    test) cut.  Returns (mapping dir, tree root, {split: size})."""
    import csv

    from multimodal_concept_learning_tpu_torch import miniyaml
    from multimodal_concept_learning_tpu_torch.data.imagenet_builder import main as build_main

    with open(os.path.join(REPO, "experiments/datasets/imagenet/imagenet100.yaml")) as f:
        targets = miniyaml.safe_load(f)["target_synsets"]
    tree = write_imagenet_tree(os.path.join(root, "imagenet"),
                               {w: f"synset {w}" for w in targets}, dict.fromkeys(targets, 12),
                               n_val=100)
    os.makedirs(os.path.join(root, "dataset"))
    cfg = _write_config(os.path.join(REPO, "experiments/datasets/imagenet/imagenet100.yaml"),
                        os.path.join(root, "dataset"),
                        {"data_dir": tree, "output_dir": root, "per_class_train": "11",
                               "per_class_val": "1", "per_class_test": "1"})
    _run_cli("imagenet-builder", build_main, ["--config_path", cfg["path"]])
    mapping_dir = os.path.join(root, cfg["parsed"]["dataset_name"])
    sizes = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(mapping_dir, f"{split}_mapping.csv")) as f:
            sizes[split] = sum(1 for _ in csv.DictReader(f))
    return mapping_dir, tree, sizes


def phase_imagenet_vision(root: str) -> None:
    """Phase 31: the vision classifier on ImageNet.  A synthetic tree of
    imagenet100's 100 target synsets (``_imagenet100_tree``, through the
    port's builder CLI), then the vision CLI on a copy of
    experiments/vision/imagenet/imagenet100.yaml with only the paths and
    ``epochs`` (1) changed: ViT-B/16 at 224, 100 labels, dropout 0.1, label
    smoothing 0.1, batch 64, 16 micro-steps an update, the full train
    pipeline (RandomResizedCrop, flip, RandAugment, RandomErasing) over
    JPEGs decoded by the port; 1100 training images, one update.  K1
    forward exactly 12 a validation or test batch, none in training
    (dropout), K1's backward never; then three classifier micro-steps at
    dropout 0 (2 layers, float32, batch 8) on batches of the train
    pipeline, card against CPU (``_classifier_parity``: phase 17's
    tolerances)."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ImageNetDataset,
        load_split_datasets,
    )
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
    )
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.vision_training import main as vision_main

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    mapping_dir, tree, sizes = _imagenet100_tree(root)
    results = os.path.join(root, "results")
    src = os.path.join(REPO, IMAGENET_CONFIGS[0][1])
    cfg = _write_config(src, root, {"data_dir": tree, "mapping_path": mapping_dir,
                                    "results_dir": results, "epochs": "1"})
    parsed = VisionTrainingConfig.from_params(cfg["parsed"])
    print(f"[imagenet-vision] tree and mapping CSVs ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s; config {parsed.hidden_size} wide, "
          f"{parsed.num_hidden_layers} layers, {parsed.image_size} px, batch "
          f"{parsed.batch_size}, effective {parsed.effective_batch_size}, dropout "
          f"{parsed.hidden_dropout_prob}, label smoothing {parsed.label_smoothing}", flush=True)
    if sizes["train"] < parsed.effective_batch_size:
        fail(f"imagenet vision: {sizes['train']} training images make no update")
    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                ac.attention_core_fwd, ac.attention_core_bwd)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out, text = _run_cli("imagenet-vision-cli", vision_main,
                         ["--config_path", cfg["path"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = tuple(fn.launches for fn in counters)
    b = parsed.batch_size
    micro = sizes["train"] // b
    evals = -(-sizes["val"] // b) + -(-sizes["test"] // b)
    expected = (parsed.num_hidden_layers * evals, 0, 0, 0, 0)
    epoch = out["history"][0]
    lines_ok = (f"Loaded imagenet100 dataset with {sizes['train']} train samples" in text
                and all(re.search(p, text, re.M) for p in (
                    r"^Epoch 1/1 completed in \d+\.\d\ds$", r"^Best val loss: \d+\.\d{4}$",
                    r"^Test Accuracy: \d+\.\d\d%$")))
    finite = all(np.isfinite(epoch[k]) for k in ("train_loss", "val_loss")) and np.isfinite(
        out["test_loss"])
    updates = out["state"].optimizer.count
    steps_s = epoch["micro_steps"] / epoch["train_time"]
    print(f"[imagenet-vision] one epoch: {epoch['micro_steps']} micro-steps, {updates} "
          f"update(s) in {epoch['train_time']:.3f} s: {b * steps_s:.1f} images/s (loader "
          f"included); epoch wall time {epoch['epoch_time']:.3f} s; whole CLI run {wall:.1f} s; "
          f"launches (K1 fwd, dq, dkv, K2 fwd, bwd) {launches} (expected {expected}); "
          f"{parsed.num_labels} labels; lines {lines_ok}", flush=True)
    if not (lines_ok and finite and epoch["micro_steps"] == micro and updates >= 1
            and parsed.num_labels == 100):
        fail("imagenet vision slice checks")
    if launches != expected:
        fail(f"imagenet vision slice launches {launches} != {expected}")

    vcfg = dataclasses.replace(ViTConfig.preset("vit-b-16", num_labels=100),
                               num_hidden_layers=2, dtype=torch.float32)
    model0 = init_random_weights_(ViTForImageClassification(vcfg),
                                  torch.Generator().manual_seed(SEED))
    sd = {k: v.clone() for k, v in model0.state_dict().items()}
    train, _, _ = load_split_datasets(ImageNetDataset, mapping_dir, tree,
                                      create_transforms(parsed, True, SEED),
                                      create_transforms(parsed, False, SEED))
    batches = []
    for batch in BatchLoader(train, 8, shuffle=True, drop_last=True, seed=SEED, num_workers=8):
        batches.append(batch)
        if len(batches) == 3:
            break
    _classifier_parity("imagenet-parity", vcfg, sd, batches)


def _imagenet1k_tree(root: str) -> tuple:
    """Phase 32's tree: all 1000 synsets of the imagenet1k_vit config's
    labels mapping (their names: the mapping's, OOD markers stripped), 264
    of them with 2 training images, 16 val images; the port's
    imagenet_configs CLI (1 train, 1 val, 1 test a class) and builder CLI
    on it.  Returns (train CSV path, tree root, {split: size}, the
    generated labels mapping equal to the repo's)."""
    import contextlib
    import csv
    import io

    from multimodal_concept_learning_tpu_torch.data.imagenet_builder import main as build_main
    from multimodal_concept_learning_tpu_torch.data.imagenet_configs import main as configs_main

    with open(IMAGENET1K_MAPPING) as f:
        mapping = json.load(f)
    names = {w: v[len("<ood_"):-1] if v.startswith("<ood_") else v for w, v in mapping.items()}
    wnids = sorted(names)
    per_class = dict.fromkeys(wnids[::3][:264], 2)
    tree = write_imagenet_tree(os.path.join(root, "imagenet"), names, per_class, n_val=16)
    name = "imagenet1k_100ood"
    _, text = _run_cli("imagenet-configs", configs_main, [
        "--data_dir", tree, "--dataset_name", name, "--num_ood", "100", "--per_class_train", "1",
        "--per_class_val", "1", "--per_class_test", "1", "--output_root", root])
    with open(os.path.join(root, "experiments", "multimodal", "imagenet",
                           f"{name}_labels_mapping.json")) as f:
        same_mapping = json.load(f) == mapping
    cwd = os.getcwd()
    buf = io.StringIO()
    os.chdir(root)  # the generated YAML's output_dir is relative, as the JAX CLI writes it
    try:
        with contextlib.redirect_stdout(buf):
            build_main(["--config_path", os.path.join(
                root, "experiments", "datasets", "imagenet", f"{name}.yaml")])
    finally:
        os.chdir(cwd)
    lines = buf.getvalue().splitlines()
    print(f"[imagenet-builder] {len(lines)} lines, "
          f"{sum('No training images' in ln for ln in lines)} of them synsets without images; "
          + "; ".join(ln for ln in lines if ln.startswith(("Created", "Dataset"))), flush=True)
    mapping_dir = os.path.join(root, "data", "multimodal_concept_learning", "imagenet1k", name)
    sizes = {}
    for split in ("train", "val", "test"):
        with open(os.path.join(mapping_dir, f"{split}_mapping.csv")) as f:
            sizes[split] = sum(1 for _ in csv.DictReader(f))
    return os.path.join(mapping_dir, "train_mapping.csv"), tree, sizes, same_mapping


IMAGENET1K_MAPPING = os.path.join(
    REPO, "experiments/multimodal/imagenet/imagenet1k_100ood_labels_mapping.json")


def phase_imagenet_mllm(root: str) -> None:
    """Phase 32: the MLLM on ImageNet.  A synthetic tree of the 1000
    synsets of imagenet1k_vit's labels mapping (``_imagenet1k_tree``,
    through the port's imagenet_configs and builder CLIs), then the trainer
    CLI on a copy of experiments/multimodal/imagenet/imagenet1k_vit.yaml
    with only the paths and ``epochs`` (1) changed: vit-b-16 + gemma3-1b,
    bf16, batch 8, 32 micro-steps an update, language_embed_only, its
    train pipeline (Resize 256, RandomResizedCrop 224, flip) over JPEGs
    decoded by the port; 264 training images, one update.  K1 forward
    exactly 38 a micro-step or eval batch, dQ and dK/dV exactly 26 a
    micro-step, K2 never; then ``generate_answers`` on its checkpoint (16
    test samples, 8 tokens, batch 8: K1 38 a prefill and 26 a decode step)
    and the ImageNet analysis CLI on its epoch checkpoints with the
    synthetic devkit's hierarchy."""
    import torch

    from multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis_imagenet import (
        main as analysis_main,
    )
    from multimodal_concept_learning_tpu_torch.ops import attention_core as ac
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.train.generate_answers import main as answers_main
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    train_csv, tree, sizes, same_mapping = _imagenet1k_tree(root)
    results = os.path.join(root, "results")
    cfg = _write_config(os.path.join(REPO, IMAGENET_CONFIGS[2][1]), root, {
        "mapping_path": train_csv, "image_root": tree, "labels_mapping_path": IMAGENET1K_MAPPING,
        "results_dir": results, "epochs": "1"})
    parsed = _load_training_config("multimodal", cfg["path"])
    print(f"[imagenet-mllm] tree and mapping CSVs ({sizes}) in "
          f"{time.perf_counter() - t0:.1f} s; the generated labels mapping equals the repo's "
          f"{same_mapping}; config {parsed.vision_model_name} + {parsed.language_model_name}, "
          f"{parsed.mixed_precision}, batch {parsed.batch_size}, effective "
          f"{parsed.effective_batch_size}, {parsed.trainable_params_setting}", flush=True)
    if sizes["train"] < parsed.effective_batch_size:
        fail(f"imagenet mllm: {sizes['train']} training images make no update")
    torch.cuda.empty_cache()
    counters = (fa.flash_attention, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                ac.attention_core_fwd, ac.attention_core_bwd)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    (state, test_metrics, logged), _ = _run_cli("imagenet-mllm-cli", train_main,
                                                ["--config_path", cfg["path"], "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = tuple(fn.launches for fn in counters)
    b = parsed.batch_size
    micro = sizes["train"] // b
    evals = -(-sizes["val"] // b) + -(-sizes["test"] // b)
    expected = (38 * (micro + evals), 26 * micro, 26 * micro, 0, 0)
    epoch = logged[0]
    updates = state.optimizer.count
    del state
    finite = all(np.isfinite(epoch[k]) for k in ("train_loss", "val_loss")) and np.isfinite(
        test_metrics["test_loss"])
    models = os.path.join(results, "models")
    layout = ["initial_model.pt", "best_model.pt", "epoch_0_model.pt", "training_config.json",
              "tokenizer"]
    missing = [n for n in layout if not os.path.exists(os.path.join(models, n))]
    print(f"[imagenet-mllm] one epoch: {epoch['micro_steps']} micro-steps, {updates} update(s) "
          f"in {epoch['train_time']:.3f} s: {b * epoch['micro_steps'] / epoch['train_time']:.2f} "
          f"samples/s (loader included); whole CLI run {wall:.1f} s; train loss "
          f"{epoch['train_loss']:.4f}, val loss {epoch['val_loss']:.4f}, test {test_metrics}; "
          f"launches (K1 fwd, dq, dkv, K2 fwd, bwd) {launches} (expected {expected}); missing "
          f"files {missing}", flush=True)
    if not (finite and updates >= 1 and epoch["micro_steps"] == micro and not missing):
        fail("imagenet mllm slice checks")
    if launches != expected:
        fail(f"imagenet mllm slice launches {launches} != {expected}")

    torch.cuda.empty_cache()
    out_path = os.path.join(root, "generations.jsonl")
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res, text = _run_cli("imagenet-answers", answers_main, [
        "--results_dir", results, "--output", out_path, "--limit", "16", "--max_new_tokens", "8",
        "--batch_size", "8", "--device", "cuda"])
    launches = tuple(fn.launches for fn in counters)
    expected = (_answer_k1("float", res["batches"], 8)[0], 0, 0, 0, 0)
    with open(out_path) as f:
        rows = [json.loads(line) for line in f]
    print(f"[imagenet-answers] {res['n']} test samples in {res['batches']} batches, "
          f"{time.perf_counter() - t0:.1f} s; launches {launches} (expected {expected}); rows "
          f"{rows[:2]} ...", flush=True)
    if not (res["n"] == min(16, sizes["test"]) == len(rows)
            and re.search(r"^Exact-Match Accuracy: \d+\.\d\d%$", text, re.M)):
        fail("imagenet answers")
    if launches != expected:
        fail(f"imagenet answers launches {launches} != {expected}")

    t0 = time.perf_counter()
    _, text = _run_cli("imagenet-analysis", analysis_main, [
        "--results_dir", results, "--data_dir", tree, "--parent_level", "1",
        "--output_dir", os.path.join(root, "plots")])
    print(f"[imagenet-analysis] {time.perf_counter() - t0:.1f} s", flush=True)
    if not ("OOD tokens selected: 100" in text and "Regular tokens selected: 900" in text
            and "Target epoch for plots: epoch_0" in text and "Analysis complete." in text):
        fail("imagenet analysis")


MOE_EXPERTS, MOE_TOP_K = 4, 2  # phases 33-35: the owed cell (BASELINE.md:559-584)
MOE_CASES = (("dense", 1.25), ("sparse", 1.25), ("sparse", 0.5))  # cf 0.5 drops


def _moe_parity_model(dispatch: str, cf: float, sd: dict = None):
    """Phase 4's float32 MLLM (full widths, 2 ViT + 2 LM layers, window 64
    on the first LM layer) with every LM MLP a 4-expert top-2 MoE: (cfg,
    state dict from SEED; ``sd`` when given, the weights of another
    dispatch or capacity factor, which hold the same tensors)."""
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig

    base = MLLMConfig.create(vocab_size=1148, dtype=torch.float32)
    cfg = dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, num_hidden_layers=2),
        lm=dataclasses.replace(base.lm, num_layers=2, sliding_window=64,
                               sliding_window_pattern=2, moe_experts=MOE_EXPERTS,
                               moe_top_k=MOE_TOP_K, moe_dispatch=dispatch,
                               moe_capacity_factor=cf))
    if sd is None:
        sd = init_random_weights_(MLLM(cfg), torch.Generator().manual_seed(SEED)).state_dict()
    return cfg, sd


def _k_counts() -> dict:
    from multimodal_concept_learning_tpu_torch.ops import flash_attention as fa
    from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
        paged_decode_attention,
    )

    return {"K1f": fa.flash_attention, "K1q": fa.flash_attention_bwd_dq,
            "K1kv": fa.flash_attention_bwd_dkv, "K3": paged_decode_attention}


def _moe_run(cfg, sd, dev: str, inputs, batches) -> dict:
    """One device's MoE parity run: hidden states and per-layer aux of the
    prompt batch, greedy paged tokens, three language_only micro-steps
    (accumulation 2) with the first micro-step's gradients and the
    accumulated gradient that makes the update; the launches of each part
    (from 0)."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.models.mllm import (
        MLLM,
        paged_generate,
        trainable_mask,
    )
    from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux, router_stats
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    counters = _k_counts()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        got = fn()
        return got, {k: c.launches for k, c in counters.items()}

    out = {}
    with torch.device(dev):
        model = MLLM(cfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    rec = MoEAux(keep_logits=True)
    args = [x.to(dev) for x in inputs]
    with torch.no_grad():
        hidden, out["fwd"] = counted(lambda: model(*args, moe_aux=rec)["hidden_states"])
    out["hidden"] = hidden.float().cpu()
    out["aux"] = [a.item() for a in rec.aux]
    out["stats"] = router_stats(rec.logits, MOE_TOP_K, cfg.lm.moe_capacity_factor)
    tokens, out["gen"] = counted(lambda: paged_generate(model, *inputs, max_new_tokens=8,
                                                        page_size=16))
    out["tokens"] = tokens.cpu().numpy()
    if batches:
        mask = trainable_mask(model, "language_only")
        opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                              accumulation_steps=2)
        state, step = TrainState(model=model, optimizer=opt), make_mllm_train_step(model)
        taken, take = [], opt._take_grads

        def take_and_keep():  # micro-steps 1 and 2's raw gradients (the update's inputs)
            grads = take()
            if len(taken) < 2:
                taken.append({n: g.detach().cpu().clone() for n, g in grads.items()})
            return grads

        opt._take_grads = take_and_keep

        def steps():
            return [float(step(state, to_device(b, dev))[1]["loss"]) for b in batches]

        out["losses"], out["train"] = counted(steps)
        g1, g2 = taken
        out["grads"] = g1
        # the optimizer's running mean over micro-steps 1-2, in its own arithmetic
        out["grads12"] = {n: g1[n] + (g2[n] - g1[n]) / 2 for n in g1}
        del taken, g2
        out["trained"] = {n: p.detach().cpu() for n, p in model.named_parameters() if mask[n]}
    del model
    return out


def phase_moe_parity() -> None:
    """Phase 33: phase 4's model (full widths, 2 + 2 layers, float32) with a
    4-expert top-2 MoE in every LM block, dense and sparse at cf 1.25 and
    sparse at cf 0.5 (which drops), on the card and on the CPU: hidden
    states and aux within 1e-4, the same router_stats drops, equal greedy
    paged tokens; three language_only micro-steps with accumulation 2
    (dense, sparse 1.25): losses within 1e-4 relative; for each trained
    tensor, the first micro-step's gradient and the gradient accumulated
    over micro-steps 1-2 (the update's) within 1e-4 of its norm, and the
    change the update makes (p - p0) within 1e-4 of its norm, over the
    elements whose CPU accumulated gradient is zero or above 1e-4 of the
    tensor's RMS gradient (the gradient gate's tolerance an element:
    Adam's first update moves an element by about one learning rate
    whatever its gradient's size, so an element at roundoff may take
    either sign under another summation order; their count is printed);
    exact
    launches on the card (a forward: K1f 2 ViT + 2 LM; a micro-step also
    K1q 2, K1kv 2; generation: K1f 4, K3 2 a decode step), none on the
    CPU."""
    import torch

    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, training_config

    with open(MAPPING) as f:
        labels_mapping = json.load(f)
    tokenizer, _ = build_tokenizer(training_config(dict(TRAINING_CONFIG,
                                                        labels_mapping_path=MAPPING)))
    inputs = _parity_inputs(SEED)
    batches = [_train_batch(tokenizer, labels_mapping, seed=i) for i in range(3)]
    zero = {"K1f": 0, "K1q": 0, "K1kv": 0, "K3": 0}
    want = {"fwd": dict(zero, K1f=4), "gen": dict(zero, K1f=4, K3=2 * 7),
            "train": dict(zero, K1f=4 * 3, K1q=2 * 3, K1kv=2 * 3)}
    runs, sd = {}, None
    for dispatch, cf in MOE_CASES:
        cfg, sd = _moe_parity_model(dispatch, cf, sd)
        steps = batches if cf >= 1.0 else []
        seconds = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[dev] = _moe_run(cfg, sd, dev, inputs, steps)
            seconds[dev] = round(time.perf_counter() - t0, 1)
        cuda, cpu = runs["cuda"], runs["cpu"]
        mask = inputs[2].bool()
        hid_err = (cuda["hidden"] - cpu["hidden"])[mask].abs().max().item()
        aux_err = max(abs(a - b) for a, b in zip(cuda["aux"], cpu["aux"]))
        same_tokens = bool((cuda["tokens"] == cpu["tokens"]).all())
        drops = (cuda["stats"]["drop_frac"], cpu["stats"]["drop_frac"])
        ok = hid_err <= 1e-4 and aux_err <= 1e-4 and same_tokens and drops[0] == drops[1]
        line = (f"[moe-parity] {dispatch} cf {cf}: hidden max err {hid_err:.2e}, aux "
                f"{cuda['aux']} (max err {aux_err:.2e}), router drop_frac cuda {drops[0]:.4f} "
                f"cpu {drops[1]:.4f} (capacity {cuda['stats']['capacity']}), tokens equal "
                f"{same_tokens} {cuda['tokens'].tolist()}")
        if steps:
            loss_err = max(abs(a - b) / abs(b) for a, b in zip(cuda["losses"], cpu["losses"]))

            def rel(a, b):
                return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

            grad_err = {n: rel(cuda["grads"][n], g) for n, g in cpu["grads"].items()}
            acc_err = {n: rel(cuda["grads12"][n], g) for n, g in cpu["grads12"].items()}
            delta_err, at_roundoff, elements = {}, 0, 0
            for n, p in cpu["trained"].items():
                g = cpu["grads12"][n]
                keep = (g == 0) | (g.abs() > 1e-4 * g.square().mean().sqrt())
                at_roundoff, elements = at_roundoff + int((~keep).sum()), elements + g.numel()
                delta_err[n] = rel((cuda["trained"][n] - sd[n])[keep], (p - sd[n])[keep])
            moved = all(not torch.equal(cpu["trained"][n], sd[n]) for n in cpu["trained"]
                        if ".moe." in n)
            worst = {k: max(e.items(), key=lambda kv: kv[1])
                     for k, e in (("first", grad_err), ("accumulated", acc_err),
                                  ("update", delta_err))}
            ok = ok and loss_err <= 1e-4 and moved and all(e <= 1e-4 for _, e in worst.values())
            line += (f"; micro-steps losses cuda {cuda['losses']} cpu {cpu['losses']} (max rel "
                     f"err {loss_err:.2e}); worst norm-relative err a tensor: "
                     + ", ".join(f"{k} gradient {e:.2e} ({n})" if k != "update" else
                                 f"update p - p0 {e:.2e} ({n})" for k, (n, e) in worst.items())
                     + f", {at_roundoff} of {elements} elements at roundoff left out of the "
                     f"update's; experts and router moved {moved}")
        launches = {k: cuda[k] for k in want if k in cuda}
        line += (f"; launches cuda {launches}, cpu {[cpu[k] for k in launches]}; seconds "
                 f"{seconds}")
        print(line, flush=True)
        if not ok:
            fail(f"MoE parity {dispatch} cf {cf}")
        if launches != {k: want[k] for k in launches} or any(cpu[k] != zero for k in launches):
            fail(f"MoE parity launches {launches} != {want}")
        if cf < 1.0 and not drops[0] > 0:
            fail("MoE parity: capacity factor 0.5 dropped nothing")


MOE_SLICE_DEPTH = (12, 2)  # phase 34: the whole ViT, 2 MoE LM layers (~1.1 GB a checkpoint)


def phase_moe_slice(root: str, data: tuple) -> None:
    """Phase 34 (on phase 7's data): a copy of 12_colors_3k.yaml with
    ``lm_moe_experts: 4`` (besides: paths, epochs, workers, no
    ``vision_path``, ``save_every_epoch: false``; the LM cut to 2 layers,
    since a full-depth 4-expert checkpoint is ~10.6 GB and a call's disk
    budget is fixed) through the trainer CLI for one epoch, dense then
    sparse (cf 1.25): exact K1f (14 a forward), K1q and K1kv (2 a
    micro-step) counts, finite losses, the table and projector moved and
    every other tensor (the experts too) bitwise, micro-steps/s, samples/s,
    peak memory; the sparse run served on the paged front (16 requests; K1f
    and K3, never K4 or K5) and through the answer CLI (float; K1f 14 a
    prefill + 2 a decode step); ``--int4`` refused as in JAX."""
    import contextlib
    import io

    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.train.generate_answers import main as answers_main
    from multimodal_concept_learning_tpu_torch.train.multimodal_training import main as train_main

    data_dir, sizes = data
    vl, ll = MOE_SLICE_DEPTH
    counters = _k_counts()
    micro = sizes["train"] // 2
    evals = -(-sizes["val"] // 2) + -(-sizes["test"] // 2)
    trained = ("language_model.model.embed_tokens.weight", "projector.weight", "projector.bias")
    results = None
    with _cut_depth(vl, ll):
        for dispatch in ("dense", "sparse"):
            sub = os.path.join(root, dispatch)
            os.makedirs(sub, exist_ok=True)
            results = os.path.join(sub, "results")
            cfg = _write_config(MM_CONFIG, sub, {
                "mapping_path": os.path.join(data_dir, "train_mapping.csv"),
                "image_root": data_dir, "labels_mapping_path": MAPPING, "results_dir": results,
                "epochs": "1", "num_workers": "2", "vision_path": "null",
                "save_every_epoch": "false", "lm_moe_experts": str(MOE_EXPERTS),
                "lm_moe_top_k": str(MOE_TOP_K), "lm_moe_dispatch": dispatch,
                "lm_moe_capacity_factor": "1.25"})
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            state, test_metrics, logged = train_main(["--config_path", cfg["path"],
                                                      "--device", "cuda"])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = {k: c.launches for k, c in counters.items()}
            expected = {"K1f": (vl + ll) * (micro + evals), "K1q": ll * micro,
                        "K1kv": ll * micro, "K3": 0}
            epoch = logged[0]
            models = os.path.join(results, "models")
            init_sd = load_state_dict(os.path.join(models, "initial_model.pt"))
            best_sd = load_state_dict(os.path.join(models, "best_model.pt"))
            moved = all(not torch.equal(init_sd[n], best_sd[n]) for n in trained)
            experts = [n for n in init_sd if ".moe." in n]
            frozen = bool(experts) and all(torch.equal(init_sd[n], best_sd[n])
                                           for n in init_sd if n not in trained)
            del init_sd, best_sd, state
            finite = all(np.isfinite(epoch[k]) for k in ("train_loss", "val_loss"))
            rate = epoch["micro_steps"] / epoch["train_time"]
            print(f"[moe-slice] {dispatch}: one epoch, {epoch['micro_steps']} micro-steps in "
                  f"{epoch['train_time']:.3f} s: {rate:.3f} micro-steps/s, {2 * rate:.3f} "
                  f"samples/s; whole CLI run {wall:.1f} s; peak memory {peak:.2f} GiB; train "
                  f"loss {epoch['train_loss']}, val loss {epoch['val_loss']}, test "
                  f"{test_metrics}; launches {launches} (expected {expected}); table and "
                  f"projector moved {moved}, the rest ({len(experts)} MoE tensors among them) "
                  f"bitwise {frozen}", flush=True)
            if not (finite and moved and frozen):
                fail(f"MoE slice {dispatch} checks")
            if launches != expected:
                fail(f"MoE slice {dispatch} launches {launches} != {expected}")
        run = _serve(results, "moe-serve")
        served = run["launches"]
        if not (served["flash_attention_fwd"] and served["paged_decode_attention"]
                and not served["paged_decode_attention_mp"] and not served["int4_matmul"]):
            fail(f"MoE serving launches {served}")
        for c in counters.values():
            c.launches = 0
        out_path = os.path.join(root, "moe_generations.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            res = answers_main(["--results_dir", results, "--output", out_path, *ANSWER_ARGS])
        launches = {k: c.launches for k, c in counters.items()}
        want_k1 = res["batches"] * (vl + ll + ll * 7)
        print(f"[moe-answers] {res['n']} samples in {res['batches']} batches: "
              f"{res['n'] / res['seconds']:.3f} samples/s, yes/no {res['yes_no_acc']:.2f}%; "
              f"launches {launches} (K1f expected {want_k1})", flush=True)
        if res["n"] != 16 or launches["K1f"] != want_k1 or launches["K3"]:
            fail(f"MoE answer CLI: n {res['n']}, launches {launches}")
        refused = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                answers_main(["--results_dir", results, "--output", out_path, *ANSWER_ARGS,
                              "--int4"])
        except ValueError as e:
            refused = str(e)
        print(f"[moe-answers] --int4 refused: {refused}", flush=True)
        if not refused or "MoE expert" not in refused:
            fail("the answer CLI did not refuse --int4 on an MoE model")


BENCH_MOE = ["--batch", "16", "--moe_experts", str(MOE_EXPERTS), "--moe_top_k", str(MOE_TOP_K),
             "--moe_capacity_factor", "1.25", "--moe_stats", "--device", "cuda"]


def phase_moe_bench(card: str) -> None:
    """Phase 35: the port's scripts/bench_mllm.py on the JAX script's cell
    (vit-b-16 + gemma3-1b at full depth, language_embed_only, batch 16),
    E=4, top-2, cf 1.25, dense against sparse dispatch, with --moe_stats:
    images/s, concept-token updates/s, peak memory, drop_frac before and
    after the steps, and exact K1 launches (38 forward, 26 dQ and 26 dK/dV
    a step; 38 each router probe)."""
    import contextlib
    import io

    import torch

    from multimodal_concept_learning_tpu_torch.scripts import bench_mllm

    counters = _k_counts()
    steps = bench_mllm.INNER * (1 + bench_mllm.REPEATS)
    rows = {}
    for dispatch in ("dense", "sparse"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rec = bench_mllm.run(BENCH_MOE + ["--moe_dispatch", dispatch])
        launches = {k: c.launches for k, c in counters.items()}
        for line in err.getvalue().splitlines():
            print(f"[moe-bench-{dispatch}] {line}", flush=True)
        want = {"K1f": 38 * (steps + 2), "K1q": 26 * steps, "K1kv": 26 * steps, "K3": 0}
        pre, post = rec["router_stats_pre"], rec["router_stats_post"]
        rows[dispatch] = rec
        print(f"[moe-bench] {dispatch}: {rec['value']} images/s, "
              f"{rec['concept_token_updates_per_sec']} concept-token updates/s, "
              f"{rec['steps_per_sec']:.4f} steps/s, peak {rec['peak_memory_gb']:.2f} GiB, "
              f"loss {rec['loss']:.4f}; drop_frac at cf 1.25 before {pre['drop_frac']:.4f} "
              f"after {post['drop_frac']:.4f} (worst layer {post['drop_frac_worst_layer']:.4f}, "
              f"capacity {post['capacity']}, aux {post['aux']:.4f}, entropy "
              f"{post['entropy']:.3f}); launches {launches} (expected {want}); {card}",
              flush=True)
        if not (np.isfinite(rec["loss"]) and rec["value"] > 0):
            fail(f"MoE bench {dispatch}")
        if launches != want:
            fail(f"MoE bench {dispatch} launches {launches} != {want}")
    print(f"[moe-bench] sparse / dense images/s: "
          f"{rows['sparse']['value'] / rows['dense']['value']:.3f}", flush=True)


def profile_moe(steps: int = 6, warmup: int = 4) -> None:
    """``--profile-moe``: one step of phase 35's bench cell (E=4, top-2, cf
    1.25, batch 16, full depth), dense then sparse dispatch, through
    ``_profile_step``: device busy, idle share, aten ops and device time
    by kernel."""
    import torch

    from multimodal_concept_learning_tpu_torch.scripts import bench_mllm

    for dispatch in ("dense", "sparse"):
        args = bench_mllm.parse_args(BENCH_MOE + ["--moe_dispatch", dispatch])
        model, batch = bench_mllm.build(args, torch.device("cuda"))
        state, step = bench_mllm.train_state(model, args)
        _profile_step(f"moe-{dispatch}", state, step, batch, steps, warmup, args.batch,
                      "images", groups=K1_GROUPS)
        del model, state, step, batch
        torch.cuda.empty_cache()


DP_CLIS = ("mllm", "vision", "clip")
DP_IMAGES = {"mllm": 4, "vision": 28, "clip": 28}  # a color: 18, 4 and 1 (micro-)steps
DP_STEADY = {"mllm": (_mllm_step_setup, 5), "vision": (_vision_step_setup, 5),
             "clip": (lambda: _clip_step_setup()[2:], 4)}  # (setup, micro-steps a window)


def _dp_steady_rates() -> dict:
    """{trainer: {"group": [micro-steps/s], "alone": [...]}} under a
    process group: each trainer's full model (the MLLM at phase 7's depth)
    stepped on a fixed device batch, windows alternating (G A A G G A)
    between the group's path (each collective a NCCL call) and the same
    process with the collectives off (``multihost.is_distributed`` False
    for the window: the single-process path), after 2 warm-up micro-steps
    of each; one process, so the two differ by the collectives alone."""
    import torch

    from multimodal_concept_learning_tpu_torch.parallel import multihost

    in_group = multihost.is_distributed
    rates = {}
    for trainer in DP_CLIS:
        setup, n = DP_STEADY[trainer]
        *_, state, step, batch = setup()

        def window(mode: str, k: int) -> float:
            nonlocal state
            multihost.is_distributed = in_group if mode == "group" else (lambda: False)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(k):
                    state, _ = step(state, batch)
                torch.cuda.synchronize()
                return k / (time.perf_counter() - t0)
            finally:
                multihost.is_distributed = in_group

        window("group", 2)
        window("alone", 2)
        rates[trainer] = {"group": [], "alone": []}
        for mode in ("group", "alone", "alone", "group", "group", "alone"):
            rates[trainer][mode].append(window(mode, n))
        del state, step, batch
        torch.cuda.empty_cache()
    return rates


def dp_worker(jobs_path: str) -> None:
    """``--dp-worker JOBS``, run under torchrun: each job's CLI ``main``
    (trainer, config, depth cut or None, device) once in this one process
    (the process group the first run joins serves the rest), then
    ``_dp_steady_rates`` under the group, then phase 37's world-size-1
    NCCL case (``_nccl_world_one``); writes each run's epoch records, the
    group's backend and world size, the steady rates and the NCCL case
    beside the jobs file."""
    import torch

    from multimodal_concept_learning_tpu_torch.device import set_reference_numerics
    from multimodal_concept_learning_tpu_torch.train import (
        contrastive_training,
        multimodal_training,
        vision_training,
    )

    set_reference_numerics()
    mains = {"mllm": multimodal_training.main, "vision": vision_training.main,
             "clip": contrastive_training.main}
    with open(jobs_path) as f:
        jobs = json.load(f)
    out, seconds = {}, {"start": time.perf_counter() - PROCESS_T0}
    for trainer, cfg_path, depth, device in jobs:
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if depth:
                stack.enter_context(_cut_depth(*depth))
            res = mains[trainer](["--config_path", cfg_path, "--device", device])
        out[trainer] = {"history": res[2] if isinstance(res, tuple) else res["history"],
                        "backend": torch.distributed.get_backend(),
                        "world": torch.distributed.get_world_size()}
        del res
        torch.cuda.empty_cache()
        seconds[trainer] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["steady"] = _dp_steady_rates()
    torch.cuda.empty_cache()
    seconds["steady"], t0 = time.perf_counter() - t0, time.perf_counter()
    nccl = _nccl_world_one()
    out["nccl1"] = dict(nccl, tokens=nccl["tokens"].tolist())
    seconds["nccl1"] = time.perf_counter() - t0
    out["seconds"] = seconds
    with open(os.path.join(os.path.dirname(jobs_path), "dp_results.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _dp_rate(trainer: str, epoch: dict) -> float:
    """Micro-steps (CLIP: steps) a second of an epoch's record."""
    if trainer == "clip":
        return epoch["steps"] / epoch["epoch_time"]
    return epoch["micro_steps"] / epoch["train_time"]


def _files(path: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def phase_dp(root: str, card: str) -> dict:
    """Phase 36: data parallel at world size 1.  Copies of the MLLM (the LM
    cut to 2 layers in both runs: the disk budget), vision and CLIP configs
    on small generated data, each run once in this process (no process
    group) and once under ``torchrun --standalone --nproc_per_node 1``
    (NCCL; every step's collectives, rank-0 writes; the first run in a
    fresh process): the same per-epoch losses and saved weights (bitwise
    expected; held within 1e-6), the same files, and the epochs'
    micro-steps/s beside the single process's; then ``_dp_steady_rates`` from the torchrun process: the steady
    micro-step rates the DP layer's cost is read from (the epochs above
    are a few micro-steps, mostly loader and start-up).  Returns phase
    37's world-size-1 NCCL case, run in the same torchrun process."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import load_state_dict
    from multimodal_concept_learning_tpu_torch.train import (
        contrastive_training,
        multimodal_training,
        vision_training,
    )

    srcs = {"mllm": MM_CONFIG, "vision": VISION_CONFIG, "clip": CLIP_CONFIG}
    mains = {"mllm": multimodal_training.main, "vision": vision_training.main,
             "clip": contrastive_training.main}
    saved = {"mllm": "models/best_model.pt", "vision": "models/final_model.pt",
             "clip": None}  # CLIP: its one checkpoints/step_{N}.pt
    depth = {"mllm": list(MM_RESUME_DEPTH), "vision": None, "clip": None}
    plain, plain_s, jobs, results = {}, {}, [], {}
    for trainer in DP_CLIS:
        sub = os.path.join(root, trainer)
        os.makedirs(sub, exist_ok=True)
        data_dir, _ = _generate_colors(sub, DP_IMAGES[trainer])
        paths = {"vision": {"data_dir": data_dir, "mapping_path": data_dir},
                 "mllm": {"mapping_path": os.path.join(data_dir, "train_mapping.csv"),
                          "image_root": data_dir, "labels_mapping_path": MAPPING,
                          "vision_path": "null", "save_every_epoch": "false",
                          "num_workers": "2"},
                 "clip": {"mapping_path": os.path.join(data_dir, "train_mapping.csv"),
                          "image_root": data_dir}}[trainer]
        for tag in ("plain", "dp"):
            os.makedirs(os.path.join(sub, tag), exist_ok=True)
            results[trainer, tag] = os.path.join(sub, tag, "results")
            cfg = _write_config(srcs[trainer], os.path.join(sub, tag),
                                dict(paths, results_dir=results[trainer, tag], epochs="1"))
            if tag == "dp":
                jobs.append((trainer, cfg["path"], depth[trainer], "cuda"))
                continue
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if depth[trainer]:
                    stack.enter_context(_cut_depth(*depth[trainer]))
                res = mains[trainer](["--config_path", cfg["path"], "--device", "cuda"])
            plain_s[trainer] = round(time.perf_counter() - t0, 1)
            plain[trainer] = res[2] if isinstance(res, tuple) else res["history"]
            del res
    jobs_path = os.path.join(root, "dp_jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", os.path.join(REPO, "chip_smoke.py"),
                           "--dp-worker", jobs_path], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = (proc.stdout + proc.stderr).splitlines()
    for line in lines:
        if line.startswith("distributed:"):
            print(f"[dp-torchrun] {line}", flush=True)
    if proc.returncode != 0:
        print("\n".join(lines[-80:]), flush=True)
        fail(f"torchrun exited {proc.returncode}")
    with open(os.path.join(root, "dp_results.json")) as f:
        dp = json.load(f)
    print(f"[dp] torchrun --standalone --nproc_per_node 1 ran the three CLIs, the steady "
          f"windows and phase 37's NCCL case in {wall:.1f} s (one process; seconds "
          f"{ {k: round(v, 1) for k, v in dp['seconds'].items()} }, 'start' up to its "
          f"first CLI; the single process's CLIs {plain_s})", flush=True)
    for trainer in DP_CLIS:
        got, want = dp[trainer], plain[trainer]
        files, want_files = _files(results[trainer, "dp"]), _files(results[trainer, "plain"])
        ckpt = saved[trainer] or next(f for f in want_files if f.startswith("checkpoints/"))
        loss_keys = [k for k in ("train_loss", "val_loss") if k in want[0]]
        loss_err = max(abs(got["history"][0][k] - want[0][k]) for k in loss_keys)
        a = load_state_dict(os.path.join(results[trainer, "dp"], ckpt))
        b = load_state_dict(os.path.join(results[trainer, "plain"], ckpt))
        same_keys = sorted(a) == sorted(b)
        w_err = max((a[n] - b[n]).abs().max().item() for n in b) if same_keys else float("inf")
        bitwise = same_keys and all(torch.equal(a[n], b[n]) for n in b)
        del a, b
        rate, plain_rate = _dp_rate(trainer, got["history"][0]), _dp_rate(trainer, want[0])
        print(f"[dp] {trainer}: backend {got['backend']}, world {got['world']}; losses "
              f"{[got['history'][0][k] for k in loss_keys]} vs single process "
              f"{[want[0][k] for k in loss_keys]} (max err {loss_err:.2e}); {ckpt} "
              f"bitwise {bitwise} (max err {w_err:.2e}); rank-0 files {files} (single "
              f"process {want_files}); {rate:.3f} micro-steps/s (the torchrun process's "
              f"first run of it) vs {plain_rate:.3f} single process; {card}", flush=True)
        if got["backend"] != "nccl" or got["world"] != 1:
            fail(f"DP {trainer}: backend {got['backend']}, world {got['world']}")
        if not (loss_err <= 1e-6 and w_err <= 1e-6 and files == want_files):
            fail(f"DP {trainer} at world size 1 differs from the single process")
    for trainer in DP_CLIS:
        got, want = dp["steady"][trainer]["group"], dp["steady"][trainer]["alone"]
        print(f"[dp] {trainer} steady micro-steps/s over {DP_STEADY[trainer][1]} a window "
              f"(full model, fixed device batch, the torchrun process, windows G A A G G A): "
              f"the group's path (NCCL, world 1) {[round(r, 3) for r in got]}, the "
              f"single-process path {[round(r, 3) for r in want]}; ratio of medians "
              f"{np.median(got) / np.median(want):.3f}; {card}", flush=True)
    return dp["nccl1"]


# -- phases 37-39: meshes over two ranks sharing the card ---------------------------------

MESH_WORLD = 2  # two ranks share the one card (Gloo, staged through host memory)
MESH_NEW = 8  # tokens a prompt, phase 37
MESH_LENS = [24, 20, 17, 12, 9, 24, 5, 14]  # the 8 prompts' text lengths (after 197 vision)
MESH_PAGE = 16
EP_DEPTH = (2, 2)  # phase 38's MoE case: phase 33's 2 ViT + 2 LM layers, full widths
PIPE_MICRO = 4  # phase 39: 2 stages of 3 LM blocks, 4 microbatches of one row
# phases 37-39's MLLM: the whole ViT, the LM cut to 6 of its 26 blocks (5 sliding-window
# blocks and the global one, as gemma3-1b's pattern repeats), full widths
MESH_DEPTH = (12, 6)
RING_SHAPE = (2, 222, 4, 1, 256)  # [B, T, Hq, Hk, D]: the LM's training shape, T padded even


def _mesh_cfg(dtype, moe: str = None, depth=MESH_DEPTH):
    """The 12_colors_3k MLLM (vit-b-16 + gemma3-1b, vocabulary 1148) in
    ``dtype`` at full widths, cut to ``depth`` (ViT, LM layers); ``moe``
    puts a 4-expert top-2 MoE ("dense" or "sparse" at cf 2.0: no drops) in
    every LM block."""
    import dataclasses

    from multimodal_concept_learning_tpu_torch.models.mllm import MLLMConfig

    cfg = MLLMConfig.create(vocab_size=1148, dtype=dtype)
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=depth[0]),
        lm=dataclasses.replace(cfg.lm, num_layers=depth[1]))
    if moe is not None:
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
            cfg.lm, moe_experts=4, moe_top_k=2, moe_dispatch=moe, moe_capacity_factor=2.0))
    return cfg


def _mesh_model(cfg, trainable: str = None):
    """The MLLM of ``cfg`` on the card, weights drawn on the card from SEED
    (the same tensors in every process), float32 parameters; the linear
    weights in the compute dtype (the frozen ones only, under a
    ``trainable`` setting, as the trainer stores them)."""
    import torch

    from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
    from multimodal_concept_learning_tpu_torch.device import cast_for_compute
    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, trainable_mask

    with torch.device("meta"):
        model = MLLM(cfg)
    model.to_empty(device="cuda")
    init_random_weights_(model, torch.Generator(device="cuda").manual_seed(SEED))
    if trainable is not None:
        trainable_mask(model, trainable)
        return cast_for_compute(model, cfg.dtype, only_frozen=True)
    return cast_for_compute(model, cfg.dtype).eval()


def _mesh_prompts():
    """Phase 37's 8 right-padded prompts [images, ids, mask] (CPU tensors)."""
    import torch

    rng = np.random.default_rng(SEED + 37)
    t = 197 + max(MESH_LENS)
    ids = rng.integers(4, 1148, size=(len(MESH_LENS), t)).astype(np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(MESH_LENS):
        mask[i, : 197 + n] = 1
    ids[mask == 0] = 0
    names = _color_names()
    images = np.stack([_circle(_rgb(names[i % len(names)])) for i in range(len(MESH_LENS))])
    return [torch.from_numpy(x) for x in (images, ids, mask)]


def _mesh_requests():
    """Phase 37's 8 engine submissions: (image, prompt)."""
    names = _color_names()
    return [(_circle(_rgb(names[i])).astype(np.float32),
             TRAINING_CONFIG["prompt_template"].format(class_name=names[(i * 5) % len(names)]))
            for i in range(8)]


def _launches() -> dict:
    return {k: w.launches for k, w in _k_counts().items()}


def _zero_launches() -> None:
    for w in _k_counts().values():
        w.launches = 0


def _serve_paths(model, mesh=None) -> dict:
    """Phase 37's four serving paths on ``model`` (sharded over ``mesh``
    when given): tokens, prefill last-position logits and, each path
    driven with the counts set to 0 just before it, its kernel launches
    and collectives."""
    import threading

    import torch

    from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache
    from multimodal_concept_learning_tpu_torch.models.mllm import generate, paged_generate
    from multimodal_concept_learning_tpu_torch.parallel import collectives as col
    from multimodal_concept_learning_tpu_torch.parallel import multihost
    from multimodal_concept_learning_tpu_torch.parallel.serving import (
        make_sharded_generate,
        make_sharded_paged_generate,
    )
    from multimodal_concept_learning_tpu_torch.serve.continuous import (
        ContinuousBatcher,
        ContinuousEngine,
    )

    images, ids, mask = _mesh_prompts()
    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        _zero_launches()
        col.reset_counts()
        t0 = time.perf_counter()
        tokens = fn()
        torch.cuda.synchronize()
        out[name] = dict(tokens=tokens, launches=_launches(), collectives=dict(col.COUNTS),
                         s=time.perf_counter() - t0)

    if mesh is None:
        run("generate", lambda: generate(model, images, ids, mask, MESH_NEW).cpu())
        run("paged", lambda: paged_generate(model, images, ids, mask, MESH_NEW, MESH_PAGE).cpu())
        run("paged_int8", lambda: paged_generate(model, images, ids, mask, MESH_NEW, MESH_PAGE,
                                                 quant_kv=True).cpu())
    else:
        gen, _ = make_sharded_generate(model, mesh, MESH_NEW, data_axis="data")
        run("generate", lambda: gen(images, ids, mask).cpu())
        for name, quant in (("paged", False), ("paged_int8", True)):
            pgen, _ = make_sharded_paged_generate(model, mesh, MESH_NEW, page_size=MESH_PAGE,
                                                  quant_kv=quant)
            run(name, lambda pgen=pgen: pgen(images, ids, mask).cpu())
    lm = model.language_model
    dev = torch.device("cuda")
    def logits(rows):
        with torch.inference_mode():
            lens = mask[rows].sum(dim=1).to(torch.int32).to(dev)
            caches = init_kv_cache(lm.cfg, len(rows), ids.shape[1], dev)
            hidden = model.prefill(images[rows].to(dev), ids[rows].to(dev), mask[rows].to(dev),
                                   caches, kv_lens=lens)
            last = hidden[torch.arange(len(rows), device=dev), lens.long() - 1]
            return lm.lm_head(last).float().cpu(), caches

    trace = []  # the first LM blocks' attention and MLP outputs of the prefill
    hooks = [mod.register_forward_hook(lambda m, a, o: trace.append(o.detach().float().cpu()))
             for layer in lm.model.layers[:2] for mod in (layer.self_attn, layer.mlp)]
    out["logits"], caches = logits(list(range(len(MESH_LENS))))
    for h in hooks:
        h.remove()
    out["trace"] = trace
    if mesh is None:  # the single process's own spread: the same rows in another batch order
        back, _ = logits(list(reversed(range(len(MESH_LENS)))))
        out["logits_reordered"] = back.flip(0)
    out["heads"] = (lm.cfg.num_heads, lm.cfg.num_kv_heads, int(caches[0]["k"].shape[2]))

    loaded = _fronts_loaded_model(model)
    eng = ContinuousEngine(loaded, num_slots=8, max_new_tokens=MESH_NEW,
                           max_prompt_len=max(MESH_LENS), mesh=mesh)
    calls = {"admit": 0}
    admit = eng._admit

    def counted(*a, **kw):
        calls["admit"] += 1
        return admit(*a, **kw)

    eng._admit = counted
    torch.cuda.synchronize()
    _zero_launches()
    col.reset_counts()
    t0 = time.perf_counter()
    if multihost.rank() == 0:
        batcher = ContinuousBatcher(eng)
        results = {}

        def call(i, img, prompt):
            results[i] = batcher.submit(img, prompt, timeout=300)

        threads = [threading.Thread(target=call, args=(i, *r))
                   for i, r in enumerate(_mesh_requests())]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        batcher.shutdown()
        eng.close()
    else:
        results = None
        eng.follow()
    torch.cuda.synchronize()
    out["continuous"] = dict(texts=results, launches=_launches(), collectives=dict(col.COUNTS),
                             admit_calls=calls["admit"], decode_steps=eng.decode_steps,
                             s=time.perf_counter() - t0)
    return out


def _fronts_loaded_model(model):
    """``model`` as a serving engine's loaded model (the 12_colors_3k
    tokenizer and config)."""
    import torch

    from multimodal_concept_learning_tpu_torch.serve.loader import (
        LoadedMLLM,
        build_tokenizer,
        training_config,
    )

    config = training_config(dict(TRAINING_CONFIG, labels_mapping_path=MAPPING,
                                  results_dir=REPO))
    tokenizer, mapping = build_tokenizer(config)
    return LoadedMLLM(model, tokenizer, config, mapping, torch.device("cuda"))


def _serving_k_counts(res: dict) -> dict:
    """The exact launches of each path of ``_serve_paths`` (MESH_DEPTH: 12
    ViT + 6 LM layers a prefill, 6 a decode step)."""
    steps = MESH_NEW - 1
    zero = {"K1f": 0, "K1q": 0, "K1kv": 0, "K3": 0}
    cont = res["continuous"]
    pre, lm = sum(MESH_DEPTH), MESH_DEPTH[1]
    return {"generate": dict(zero, K1f=pre + lm * steps),
            "paged": dict(zero, K1f=pre, K3=lm * steps),
            "paged_int8": dict(zero, K1f=pre + lm * steps),
            "continuous": dict(zero, K1f=pre * cont["admit_calls"] + lm * cont["decode_steps"])}


def _train_micro_steps(model, batches, mesh=None, fsdp=None, model_axis="model"):
    """Three micro-steps (accumulation 2) of the MLLM trainer's step on
    ``model`` (sharded over ``mesh`` first when given): losses, each
    micro-step's launches (from 0), the collectives, the gradients of the
    first micro-step as the optimizer accumulated them (summed over the
    data axes, before any update) and the trained tensors, both at their
    full shape and by state-dict name."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import to_device
    from multimodal_concept_learning_tpu_torch.parallel import collectives as col
    from multimodal_concept_learning_tpu_torch.parallel import sharding_rules as sr
    from multimodal_concept_learning_tpu_torch.parallel.mesh import batch_sharding
    from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
    from multimodal_concept_learning_tpu_torch.parallel.train_step import (
        TrainState,
        make_mllm_train_step,
    )

    if mesh is not None:
        sr.shard_params(model, mesh, model_axis=model_axis, fsdp_axis=fsdp)
        place = batch_sharding(mesh, sr.layout_of(model).data_axes)
        batches = [{k: place.local(torch.as_tensor(v)) for k, v in b.items()} for b in batches]
    opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                          accumulation_steps=2)
    state, step = TrainState(model=model, optimizer=opt), make_mllm_train_step(model)
    losses, launches, grads = [], [], {}
    col.reset_counts()
    seconds = 0.0
    for batch in batches:
        torch.cuda.synchronize()
        _zero_launches()
        t0 = time.perf_counter()
        state, m = step(state, to_device(batch, "cuda"))
        losses.append(float(m["loss"]))
        launches.append(_launches())
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        if not grads:  # accumulation 2: the accumulator holds this micro-step's gradients
            for n, acc in opt.acc.items():
                g = acc.clone()
                if mesh is not None:
                    g._mcl_shard = opt.params[n]._mcl_shard
                    g = sr.gather_full(g)
                grads[sr.canonical_name(n)] = g.float().cpu()
    trained = {n: p for n, p in sr.local_tensors(model).items()
               if isinstance(p, torch.nn.Parameter) and p.requires_grad} if mesh is not None \
        else {n: p for n, p in model.named_parameters() if p.requires_grad}
    full = {n: sr.gather_full(p).float().cpu() for n, p in trained.items()}
    return dict(losses=losses, launches=launches, collectives=dict(col.COUNTS), trained=full,
                grads=grads, s=seconds)


def _mesh_train_batches(n: int = 3, b: int = 2) -> list:
    """``n`` collated 224px training batches of ``b`` 12_colors_3k prompts."""
    from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, training_config

    with open(MAPPING) as f:
        labels_mapping = json.load(f)
    tokenizer, _ = build_tokenizer(training_config(dict(TRAINING_CONFIG,
                                                        labels_mapping_path=MAPPING)))
    return [_train_batch(tokenizer, labels_mapping, seed=i, b=b) for i in range(n)]


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def _of_max(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


def _ep_case(dispatch: str, mesh):
    """Phase 38's expert-parallel case on this rank: the MoE MLLM (2 + 2
    layers, full widths, float32) single-process and sharded over
    ``mesh``'s model axis: the loss (a forward with labels and the aux),
    the hidden states and the gradients of every trainable tensor
    (language_only)."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux
    from multimodal_concept_learning_tpu_torch.parallel import sharding_rules as sr

    batch = {k: torch.as_tensor(v).cuda() for k, v in _mesh_train_batches()[0].items()}
    runs = []
    for sharded in (False, True):
        model = _mesh_model(_mesh_cfg(torch.float32, moe=dispatch, depth=EP_DEPTH),
                            trainable="language_only")
        if sharded:
            sr.shard_params(model, mesh)
        aux = MoEAux()
        _zero_launches()
        out = model(batch["images"], batch["input_ids"], batch["attention_mask"],
                    batch["labels"], moe_aux=aux)
        loss = out["loss"] + 0.01 * sum(aux.aux) / len(aux.aux)
        loss.backward()
        grads = {sr.canonical_name(n): p for n, p in model.named_parameters()
                 if p.requires_grad}
        full = {}
        for n, p in grads.items():
            g = p.grad
            if sharded:
                g = g.clone()
                g._mcl_shard = p._mcl_shard
                g = sr.gather_full(g)
            full[n] = g.float()
        runs.append(dict(loss=float(loss), hidden=out["hidden_states"].detach().float(),
                         grads=full, launches=_launches(),
                         experts=int(sr.local_tensors(model)[
                             "language_model.model.layers.0.moe.experts_gate"].shape[0])))
        del model
    single, ep = runs
    return dict(loss=(ep["loss"], single["loss"]),
                hidden_err=_of_max(ep["hidden"], single["hidden"]),
                grad_err=max((_rel(ep["grads"][n], g), n) for n, g in single["grads"].items()),
                local_experts=ep["experts"], launches=ep["launches"])


def _pipeline_case(mesh):
    """Phase 39's pipeline on this rank: the MLLM at full widths (float32,
    language_only; the LM cut to MESH_DEPTH's 6 blocks) unpipelined and
    with the LM stack over the pipe axis (3 blocks a stage, 4
    microbatches of one row): the loss and every gradient this stage
    holds."""
    import torch

    from multimodal_concept_learning_tpu_torch.parallel import collectives as col
    from multimodal_concept_learning_tpu_torch.parallel.pipeline import (
        make_pipelined_mllm_loss,
        shard_pipeline_params,
    )

    raw = _mesh_train_batches(n=1, b=PIPE_MICRO)[0]
    batch = {k: torch.as_tensor(raw[k]).cuda()
             for k in ("images", "input_ids", "attention_mask", "labels")}
    cfg = _mesh_cfg(torch.float32)
    plain = _mesh_model(cfg, trainable="language_only")
    loss = plain(batch["images"], batch["input_ids"], batch["attention_mask"],
                 batch["labels"])["loss"]
    loss.backward()
    want = {n: p.grad.detach() for n, p in plain.named_parameters() if p.requires_grad}
    plain_loss = float(loss)
    del plain, loss
    torch.cuda.empty_cache()
    model = _mesh_model(cfg, trainable="language_only")
    shard_pipeline_params(model, mesh)
    first = model.language_model._mcl_pipe["first"]
    col.reset_counts()
    _zero_launches()
    t0 = time.perf_counter()
    loss = make_pipelined_mllm_loss(model, mesh, PIPE_MICRO)(batch)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    errs = []
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if ".layers." in n:
            j = int(n.split(".layers.")[1].split(".")[0])
            n = n.replace(f".layers.{j}.", f".layers.{first + j}.", 1)
        errs.append((_rel(p.grad, want[n]), n))
    return dict(loss=(float(loss), plain_loss), grad_err=max(errs), tensors=len(errs),
                launches=_launches(), collectives=dict(col.COUNTS), s=seconds,
                first=first, blocks=len(model.language_model.model.layers))


def _dense_attention(q, k, v, bias, scale):
    """The plain dense attention the ring is held to: float32 logits with
    the -1e30 bias, softmax, GQA k/v repeated to the query heads."""
    import torch

    rep = q.shape[2] // k.shape[2]
    k, v = (torch.repeat_interleave(x, rep, dim=2).float() for x in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k) + bias.float()
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v).to(q.dtype)


def _ring_case(mesh, dtype):
    """Phase 39's ring attention on this rank: [2, 222, 4/1, 256] blocks
    over the seq axis, a padding bias (row 1's last 40 keys masked, and
    the key that pads T to an even 222 in every row), output and
    gradients (a fixed weighting of the output) against
    ``_dense_attention`` on the card."""
    import torch

    from multimodal_concept_learning_tpu_torch.ops.attention import make_attention_bias
    from multimodal_concept_learning_tpu_torch.parallel import collectives as col
    from multimodal_concept_learning_tpu_torch.parallel.ring_attention import (
        make_ring_attention,
        shard_seq,
    )

    b, t, hq, hk, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 39)
    q = torch.randn(b, t, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, t, hk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, t, hk, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(b, t, hq, d, generator=gen, device="cuda")
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    mask[:, -1] = 0
    mask[1, -41:] = 0
    bias = make_attention_bias(mask, True, t, t)
    scale = 256.0 ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = _dense_attention(*leaves, bias, scale)
    (want.float() * w).sum().backward()
    want_grads = [x.grad for x in leaves]
    ring = make_ring_attention(mesh)
    group = col.mesh_group(mesh, "seq")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    col.reset_counts()
    local = ring(*(shard_seq(x, mesh) for x in leaves), shard_seq(bias, mesh, dim=2), scale)
    (local.float() * shard_seq(w, mesh)).sum().backward()
    got = col.all_gather(local.detach(), group, 1)
    got_grads = [col.all_reduce(x.grad, group) for x in leaves]
    if dtype == torch.float32:  # JAX's test: output rtol/atol 2e-6, gradients rtol 2e-5 atol 2e-6
        errs = [_over(got, want, 2e-6, 2e-6)] + [_over(a, e, 2e-5, 2e-6)
                                                 for a, e in zip(got_grads, want_grads)]
        what = "max |err| / (atol + rtol |want|), within 1"
    else:
        errs = [_of_max(got, want)] + [_of_max(a, e) for a, e in zip(got_grads, want_grads)]
        what = "of each max, within 2e-2"
    limit = 1.0 if dtype == torch.float32 else 2e-2
    return dict(errs=errs, limit=limit, what=what, collectives=dict(col.COUNTS))


def _over(a, e, rtol: float, atol: float) -> float:
    """max |a - e| / (atol + rtol |e|): at most 1 where ``allclose`` holds."""
    return ((a.float() - e.float()).abs() / (atol + rtol * e.float().abs())).max().item()


def mesh_worker(argv) -> None:
    """One rank of phases 37-39 (``chip_smoke.py --mesh-worker PHASES RANK
    WORLD PORT JOBDIR BACKEND``): joins the group (two ranks on the one
    card over Gloo), runs each of the comma-separated PHASES in turn and
    writes ``JOBDIR/{phase}_rank{R}.pt`` as each one ends (written whole,
    then renamed, so the parent reads only finished files), with the
    ``time.perf_counter`` stamps of the process's start, its joining the
    group and the phase's start and end (one monotonic clock for every
    process of the machine)."""
    import torch

    from multimodal_concept_learning_tpu_torch.parallel import multihost, sharding_rules
    from multimodal_concept_learning_tpu_torch.parallel.mesh import make_mesh

    phases, rank, world, port, jobdir, backend = argv
    rank, world = int(rank), int(world)
    multihost.init_distributed("cuda", init_method=f"tcp://localhost:{port}", world_size=world,
                               rank=rank, backend=backend, device_index=0, timeout_s=600)
    joined = time.perf_counter()
    for phase in phases.split(","):
        t0 = time.perf_counter()
        out = {"backend": torch.distributed.get_backend(), "world": world,
               "stamps": {"began": PROCESS_T0, "joined": joined, "start": t0}}
        if phase == "serve":
            mesh = make_mesh("cuda", ("data", "model"), (1, world))
            for dtype in (torch.float32, torch.bfloat16):
                out[str(dtype)] = _serve_paths(_mesh_model(_mesh_cfg(dtype)), mesh)
                torch.cuda.empty_cache()
            out["int4"] = _int4_refused(mesh)
        elif phase == "train":
            batches = _mesh_train_batches()
            for dtype in (torch.float32, torch.bfloat16):
                for tag, shape, names, fsdp in (("tp", (world,), ("model",), None),
                                                ("fsdp", (world,), ("data",), "data")):
                    mesh = make_mesh("cuda", names, shape)
                    model = _mesh_model(_mesh_cfg(dtype), trainable="language_embed_only")
                    out[f"{tag}_{dtype}"] = _train_micro_steps(model, batches, mesh, fsdp)
                    emb = [n for n in out[f"{tag}_{dtype}"]["trained"] if "embed_tokens" in n]
                    out[f"{tag}_{dtype}"]["emb_local_rows"] = int(
                        sharding_rules.local_tensors(model)[emb[0]].shape[0])
                    out[f"{tag}_{dtype}"]["heads"] = (model.cfg.lm.num_heads,
                                                      model.cfg.lm.num_kv_heads)
                    del model
                    torch.cuda.empty_cache()
            mesh = make_mesh("cuda", ("model",), (world,))
            for dispatch in ("dense", "sparse"):
                out[f"ep_{dispatch}"] = _ep_case(dispatch, mesh)
                torch.cuda.empty_cache()
        elif phase == "pipe":
            out["pipeline"] = _pipeline_case(make_mesh("cuda", ("pipe",), (world,)))
            torch.cuda.empty_cache()
            mesh = make_mesh("cuda", ("seq",), (world,))
            for dtype in (torch.float32, torch.bfloat16):
                out[f"ring_{dtype}"] = _ring_case(mesh, dtype)
        else:
            raise ValueError(f"unknown mesh phase {phase!r}")
        out["s"] = time.perf_counter() - t0
        out["stamps"]["end"] = time.perf_counter()
        path = os.path.join(jobdir, f"{phase}_rank{rank}.pt")
        torch.save(out, path + ".part")
        os.replace(path + ".part", path)
    multihost.barrier()
    multihost.shutdown()


def _int4_refused(mesh) -> bool:
    import dataclasses

    import torch

    from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
    from multimodal_concept_learning_tpu_torch.parallel.serving import (
        make_sharded_generate,
        make_sharded_paged_generate,
    )

    cfg = _mesh_cfg(torch.bfloat16)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, int4_weights=True))
    with torch.device("meta"):
        model = MLLM(cfg)
    refused = 0
    for fn in (make_sharded_generate, make_sharded_paged_generate):
        try:
            fn(model, mesh, MESH_NEW)
        except ValueError as e:
            refused += "int4" in str(e)
    return refused == 2


def _nccl_world_one() -> dict:
    """World size 1 over NCCL: ``make_sharded_generate`` on a (1 data x 1
    model) mesh in float32, and every collective primitive once over a
    one-rank NCCL group."""
    import torch
    import torch.distributed as dist

    from multimodal_concept_learning_tpu_torch.parallel import collectives as col
    from multimodal_concept_learning_tpu_torch.parallel.mesh import make_mesh
    from multimodal_concept_learning_tpu_torch.parallel.serving import make_sharded_generate

    mesh = make_mesh("cuda", ("data", "model"), (1, 1))
    model = _mesh_model(_mesh_cfg(torch.float32))
    gen, _ = make_sharded_generate(model, mesh, MESH_NEW)
    images, ids, mask = _mesh_prompts()
    tokens = gen(images, ids, mask).cpu()
    group = col.AxisGroup(("one",), [0], dist.new_group([0]))
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    col.reset_counts()
    ok = (torch.equal(col.all_reduce(x, group), x)
          and torch.equal(col.all_gather(x, group, 1), x)
          and torch.equal(col.reduce_scatter(x, group, 0), x)
          and torch.equal(col.broadcast(x, group, 0), x)
          and float(col.all_reduce_max(x.max().reshape(1), group)) == 11.0)
    return dict(tokens=tokens, primitives_ok=ok, collectives=dict(col.COUNTS),
                backend=dist.get_backend())


def timed(fn, *fn_args, **fn_kwargs):
    """``fn(*fn_args, **fn_kwargs)``, its seconds printed as ``[timing]``."""
    t0 = time.perf_counter()
    out = fn(*fn_args, **fn_kwargs)
    print(f"[timing] {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


SIDE_PHASES = "27, 28, 30-32 and 36"  # the phases the second process runs


def side_worker(root: str) -> None:
    """``--side ROOT``: the phases that share no state with the others
    (phase 36, then 27, 28 and 30-32), each in its own directory under
    ROOT, removed after it; phase 36's world-size-1 NCCL case goes to
    ``ROOT/nccl1.json`` for phase 37."""
    import shutil

    card = phase_card()
    nccl = timed(phase_dp, os.path.join(root, "dp"), card)
    with open(os.path.join(root, "nccl1.json"), "w") as f:
        json.dump(nccl, f)
    for fn, sub in ((phase_vision_resume, "vision-resume"), (phase_mllm_resume, "mllm-resume"),
                    (phase_imagenet_data, "imagenet"), (phase_imagenet_vision, "imagenet-vision"),
                    (phase_imagenet_mllm, "imagenet-mllm")):
        path = os.path.join(root, sub)
        os.makedirs(path)
        try:
            timed(fn, path, card) if fn in (phase_vision_resume, phase_mllm_resume) \
                else timed(fn, path)
        finally:
            shutil.rmtree(path, ignore_errors=True)
    print("[side] every phase passed", flush=True)


class _Side:
    """The second process (this script's ``--side``): phases 27, 28, 30-32
    and 36, started after phase 3 and run beside this process's phases
    from 4 on (the rates and seconds of both share the card and the
    host's cores); its output goes to ``ROOT/side.log``, printed here when
    it is joined."""

    def __init__(self, root: str, timeout: float):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        self.root, self.log = root, os.path.join(root, "side.log")
        self.deadline = time.perf_counter() + timeout
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                                          "--side", root], cwd=REPO, env=env, stdout=log,
                                         stderr=subprocess.STDOUT)

    def join(self) -> dict:
        """Waits for the process, prints its output and returns phase
        36's NCCL case; fails if it failed."""
        t0 = time.perf_counter()
        try:
            code = self.proc.wait(timeout=max(1.0, self.deadline - t0))
        except subprocess.TimeoutExpired:
            code = None
        with open(self.log) as f:
            text = f.read()
        print(f"[side] the second process's output (phases {SIDE_PHASES}, run beside this "
              f"process's; this one waited {time.perf_counter() - t0:.1f} s for it):", flush=True)
        print(text.rstrip("\n"), flush=True)
        if code != 0 or "[side] every phase passed" not in text:
            self.stop()
            fail(f"the second process (phases {SIDE_PHASES}) exited {code}")
        with open(os.path.join(self.root, "nccl1.json")) as f:
            return json.load(f)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class _Ranks:
    """The ``world`` ranks of phases 37-39, started once (this script's
    --mesh-worker, all on the one card) to run ``phases`` in turn beside
    this process's later phases; each rank's output goes to
    ``JOBDIR/rank{R}.log``."""

    def __init__(self, phases: tuple, jobdir: str, world: int, backend: str, timeout: float):
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        self.jobdir, self.world = jobdir, world
        self.logs = [os.path.join(jobdir, f"rank{r}.log") for r in range(world)]
        self.spawned = time.perf_counter()
        self.deadline = self.spawned + timeout
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mesh-worker",
                     ",".join(phases), str(r), str(world), str(port), jobdir, backend],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))

    def _failed(self, why: str) -> None:
        self.stop()
        for r, path in enumerate(self.logs):
            with open(path) as f:
                print(f"[mesh] rank {r}'s output:\n{f.read()[-6000:]}", flush=True)
        fail(why)

    def results(self, phase: str) -> list:
        """Each rank's results of ``phase``, in rank order, once all are
        written; fails the phase if a rank exits without them (or the
        ranks outlive their time)."""
        import torch

        t0 = time.perf_counter()
        paths = [os.path.join(self.jobdir, f"{phase}_rank{r}.pt") for r in range(self.world)]
        while not all(os.path.exists(p) for p in paths):
            if time.perf_counter() > self.deadline:
                self._failed(f"mesh phase {phase}: the ranks outlived their time")
            for r, p in enumerate(self.procs):
                code = p.poll()
                if code is not None and (code != 0 or not os.path.exists(paths[r])):
                    self._failed(f"mesh phase {phase}: rank {r} exited {code}")
            time.sleep(0.2)
        waited = time.perf_counter() - t0
        out = [torch.load(p, weights_only=False) for p in paths]
        for r, res in enumerate(out):
            st = {k: v - self.spawned for k, v in res["stamps"].items()}
            print(f"[mesh] {phase} rank {r}, seconds after the spawn: process began "
                  f"{st['began']:.1f}, joined the group {st['joined']:.1f}, phase ran "
                  f"{st['start']:.1f}-{st['end']:.1f} ({res['s']:.1f} s); this process waited "
                  f"{waited:.1f} s for the ranks", flush=True)
        return out

    def join(self) -> None:
        for r, p in enumerate(self.procs):
            try:
                code = p.wait(timeout=max(1.0, self.deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                self._failed(f"mesh ranks: rank {r} did not exit")
            if code != 0:
                self._failed(f"mesh ranks: rank {r} exited {code}")

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _compute_mode() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unknown ({e})"


def phase_mesh_serving(procs: _Ranks, card: str, nccl: dict) -> None:
    """Phase 37: sharded serving at full width.  The 12_colors_3k MLLM
    (vit-b-16 + gemma3-1b at full widths, the LM cut to MESH_DEPTH's 6
    blocks, seeded weights) on a (1 data x 2
    model) mesh of two ranks sharing the card (Gloo), float32 then bf16:
    ``make_sharded_generate``, ``make_sharded_paged_generate`` on float and
    on int8 pools, and ``ContinuousEngine(mesh=)`` through its batcher (8
    submissions), against the same paths single-process on the card.
    Gates: float32 tokens (and the engine's texts) equal, prefill
    last-position logits within 1e-4 of their max; bf16 last-position
    logits no farther from the float32 single process's than the
    single-process bf16 logits are, or within 2e-2 of the max.  Their
    distance to the single-process bf16 logits is printed against 2e-2
    of the max, met or missed, with the bf16 tokens, and not gated: two
    bf16 runs differ by both runs' roundings (most of the first LM
    block's outputs already differ by one); each rank's K1f and K3
    launches exact, at 2 query heads and 1 KV head a rank; the
    collectives counted; int4 refused.  Then the same
    ``make_sharded_generate`` at world size 1 over NCCL (``nccl``: run in
    phase 36's torchrun process, with each collective primitive once over
    a one-rank NCCL group).  The ranks ran beside phases 8-35: the seconds
    printed beside each other were not taken on a quiet card."""
    import torch

    print(f"[mesh] compute mode {_compute_mode()}; {MESH_WORLD} ranks share the card "
          f"(Gloo, collectives staged through host memory); {card}", flush=True)
    refs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _mesh_model(_mesh_cfg(dtype))
        refs[dtype] = _serve_paths(model)
        del model
        torch.cuda.empty_cache()
    ranks = procs.results("serve")
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        ref = refs[dtype]
        for r, res in enumerate(ranks):
            got = res[str(dtype)]
            want_k = _serving_k_counts(got)
            for path in ("generate", "paged", "paged_int8", "continuous"):
                same = (torch.equal(got[path]["tokens"], ref[path]["tokens"])
                        if path != "continuous" else None)
                if path == "continuous" and r == 0:
                    same = got[path]["texts"] == ref[path]["texts"]
                kexact = got[path]["launches"] == want_k[path]
                print(f"[mesh-serve] {dtype} rank {r} {path}: tokens equal single-process "
                      f"{same}; launches {got[path]['launches']} (want {want_k[path]}, "
                      f"{'exact' if kexact else 'DIFFER'}); collectives "
                      f"{got[path]['collectives']}; {got[path]['s']:.2f} s (single process "
                      f"{ref[path]['s']:.2f} s); two-ranks-one-card, not scaling; {card}",
                      flush=True)
                ok = ok and kexact and (dtype != torch.float32 or same is not False)
                ok = ok and sum(got[path]["collectives"].values()) > 0
            err = _of_max(got["logits"], ref["logits"])
            rows = [round(_of_max(a, b), 5) for a, b in zip(got["logits"], ref["logits"])]
            floor = _of_max(ref["logits_reordered"], ref["logits"])
            f32 = refs[torch.float32]["logits"]
            own, single_own = _of_max(got["logits"], f32), _of_max(ref["logits"], f32)
            layers = [(round(_of_max(a, b), 6), round(float((a != b).float().mean()), 6))
                      for a, b in zip(got["trace"], ref["trace"])]
            print(f"[mesh-serve] {dtype} rank {r}: logits against the float32 single process: "
                  f"sharded {own:.4e}, single process {single_own:.4e}; first layers' "
                  f"outputs sharded vs single (max of max, share differing) {layers}", flush=True)
            heads_ok = got["heads"] == (2, 1, 1)
            stated = "" if dtype == torch.float32 else (
                f" (the 2e-2 bound against the single-process bf16 logits "
                f"{'met' if err <= 2e-2 else 'MISSED'}; gated against float32 below)")
            print(f"[mesh-serve] {dtype} rank {r}: prefill last-position logits within "
                  f"{err:.4e} of their max{stated} (each row against its own max {rows}; the "
                  f"single process against itself with the rows reversed {floor:.4e}); local "
                  f"heads (q, kv, cache kv) {got['heads']}; int4 refused {res['int4']}",
                  flush=True)
            if dtype == torch.float32:
                good = err <= 1e-4
            else:  # the single process's bf16 logits carry their own error against float32:
                # the sharded ones must be no farther from float32 than they are (or 2e-2)
                good = own <= max(2e-2, single_own)
            ok = ok and good and heads_ok and res["int4"]
    if not ok:
        fail("mesh serving (phase 37)")
    want = refs[torch.float32]["generate"]["tokens"]
    same = torch.equal(torch.tensor(nccl["tokens"], dtype=want.dtype), want)
    print(f"[mesh-serve] world size 1 over {nccl['backend']}: tokens equal single-process "
          f"{same}; the primitives over a one-rank NCCL group {nccl['primitives_ok']} "
          f"{nccl['collectives']}", flush=True)
    if not (same and nccl["primitives_ok"] and nccl["backend"] == "nccl"):
        fail("mesh serving at world size 1 over NCCL")


def phase_mesh_training(procs: _Ranks, card: str) -> None:
    """Phase 38: sharded training at full width.  The MLLM trainer's step
    at phase 7's settings (language_embed_only, batch 2, AdamW lr 5e-4,
    accumulation 2) for 3 micro-steps on the 12_colors_3k MLLM at full
    widths (the LM cut to MESH_DEPTH's 6 blocks),
    float32 then bf16, on (model 2) tensor parallelism (the trainable
    embedding vocab-sharded) and on (data 2) with FSDP over data (the
    embedding vocab-extended), against the single process on the card.
    Gates: the first micro-step's gradients, tensor by tensor, within
    1e-4 of their norm in float32 and 5e-2 in bf16 (a gradient doubled,
    halved or missing a rank's partial sum reads 0.5 or more); float32
    losses within 1e-5 relative and trained tensors within 1e-4 of their
    norm; bf16 losses within 2e-2; K1f 18, K1q 6, K1kv 6 a micro-step
    on every rank.  The bf16 trained tensors are printed against 2e-2 of
    each tensor's max, not gated: Adam's first update is about lr times
    the gradient's sign, so an element whose bf16 gradient is near zero
    moves by lr either way.  Then expert parallelism: the 4-expert MoE
    MLLM (2 + 2 layers, full widths, float32) over (model 2), dense and
    sparse at cf 2.0: loss, hidden states and every gradient against the
    single process in the rank."""
    import torch

    refs = {}
    batches = _mesh_train_batches()
    for dtype in (torch.float32, torch.bfloat16):
        model = _mesh_model(_mesh_cfg(dtype), trainable="language_embed_only")
        refs[dtype] = _train_micro_steps(model, batches)
        del model
        torch.cuda.empty_cache()
    ranks = procs.results("train")
    ok = True
    want_k = {"K1f": sum(MESH_DEPTH), "K1q": MESH_DEPTH[1], "K1kv": MESH_DEPTH[1], "K3": 0}
    f32 = refs[torch.float32]
    noise = {n.rsplit(".", 2)[-2] + "." + n.rsplit(".", 1)[-1]: f"{_rel(g, f32['grads'][n]):.2e}"
             for n, g in refs[torch.bfloat16]["grads"].items()}
    print(f"[mesh-train] single-process bf16 gradients against float32, of each norm: {noise}",
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        ref = refs[dtype]
        grad_tol = 1e-4 if dtype == torch.float32 else 5e-2
        for tag in ("tp", "fsdp"):
            for r, res in enumerate(ranks):
                got = res[f"{tag}_{dtype}"]
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
                g_errs = {n: _rel(got["grads"][n], g) for n, g in ref["grads"].items()}
                g_err = max(g_errs.values())
                short = {n.rsplit(".", 2)[-2] + "." + n.rsplit(".", 1)[-1]: f"{e:.2e}"
                         for n, e in g_errs.items()}
                good = (set(got["grads"]) == set(ref["grads"]) and g_err <= grad_tol
                        and loss_err <= (1e-5 if dtype == torch.float32 else 2e-2))
                if dtype == torch.float32:
                    p_err = max(_rel(got["trained"][n], t) for n, t in ref["trained"].items())
                    good = good and p_err <= 1e-4
                    p_note = f"trained tensors within {p_err:.2e} of their norm"
                else:
                    p_err = max(_of_max(got["trained"][n], t) for n, t in ref["trained"].items())
                    p_note = (f"trained tensors within {p_err:.2e} of each max (2e-2 "
                              f"{'met' if p_err <= 2e-2 else 'missed'}; not gated)")
                kexact = all(k == want_k for k in got["launches"])
                print(f"[mesh-train] {dtype} {tag} rank {r}: losses {got['losses']} vs "
                      f"{ref['losses']} (max rel err {loss_err:.2e}); first micro-step's "
                      f"gradients of each norm {short} (within {grad_tol:g}: "
                      f"{'met' if g_err <= grad_tol else 'MISSED'}); {p_note}; embedding rows "
                      f"a rank {got['emb_local_rows']}; local heads {got['heads']}; launches a "
                      f"micro-step {got['launches']} ({'exact' if kexact else 'DIFFER'}); "
                      f"collectives {got['collectives']}; {got['s']:.2f} s for 3 micro-steps "
                      f"(single process {ref['s']:.2f} s); two-ranks-one-card, not scaling; "
                      f"{card}", flush=True)
                ok = ok and good and kexact and got["emb_local_rows"] == 1148 // 2
    for dispatch in ("dense", "sparse"):
        for r, res in enumerate(ranks):
            e = res[f"ep_{dispatch}"]
            loss_err = abs(e["loss"][0] - e["loss"][1]) / abs(e["loss"][1])
            print(f"[mesh-ep] {dispatch} rank {r}: loss {e['loss'][0]:.6f} vs single process "
                  f"{e['loss'][1]:.6f} (rel err {loss_err:.2e}); hidden within "
                  f"{e['hidden_err']:.2e} of max; worst gradient {e['grad_err'][0]:.2e} of its "
                  f"norm ({e['grad_err'][1]}); local experts {e['local_experts']}; launches "
                  f"{e['launches']}", flush=True)
            ok = ok and loss_err <= 1e-5 and e["hidden_err"] <= 1e-4 and e["grad_err"][0] <= 1e-4
            ok = ok and e["local_experts"] == 2
    if not ok:
        fail("mesh training (phase 38)")


def phase_mesh_pipeline(procs: _Ranks, card: str) -> None:
    """Phase 39: ``make_pipelined_mllm_loss`` over (pipe 2): the MLLM at
    full widths (float32, language_only; the LM cut to MESH_DEPTH's 6
    blocks), 3 LM blocks a stage, 4 microbatches: loss within 1e-5
    relative and every gradient a stage holds within 1e-4 of its norm
    against the unpipelined loss on the card; K1 launches a rank exact (a
    stage's 3 blocks x 4 microbatches, plus the replicated ViT's 12).
    Then ``make_ring_attention`` over (seq 2) at [2, 222, 4/1, 256] (the
    LM's training shape, T padded to even with one masked key) with a
    padding bias: output and gradients against the plain dense attention
    on the card (float32 2e-6; bf16 2e-2 of the max)."""
    import torch

    ranks = procs.results("pipe")
    procs.join()
    ok = True
    vit, stage = MESH_DEPTH[0], MESH_DEPTH[1] // MESH_WORLD
    want_k = {"K1f": vit + stage * PIPE_MICRO, "K1q": stage * PIPE_MICRO,
              "K1kv": stage * PIPE_MICRO, "K3": 0}
    for r, res in enumerate(ranks):
        p = res["pipeline"]
        loss_err = abs(p["loss"][0] - p["loss"][1]) / abs(p["loss"][1])
        kexact = p["launches"] == want_k
        print(f"[mesh-pipe] rank {r} (blocks {p['first']}..{p['first'] + p['blocks'] - 1}): "
              f"loss {p['loss'][0]:.6f} vs unpipelined {p['loss'][1]:.6f} (rel err "
              f"{loss_err:.2e}); worst of {p['tensors']} gradients {p['grad_err'][0]:.2e} of "
              f"its norm ({p['grad_err'][1]}); launches {p['launches']} "
              f"({'exact' if kexact else 'DIFFER'}); collectives {p['collectives']}; "
              f"{p['s']:.2f} s; two-ranks-one-card, not scaling; {card}", flush=True)
        ok = ok and loss_err <= 1e-5 and p["grad_err"][0] <= 1e-4 and kexact
        for dtype in (torch.float32, torch.bfloat16):
            g = res[f"ring_{dtype}"]
            print(f"[mesh-ring] {dtype} rank {r}: output, dq, dk, dv "
                  f"{[f'{e:.2e}' for e in g['errs']]} ({g['what']}); collectives "
                  f"{g['collectives']}", flush=True)
            ok = ok and max(g["errs"]) <= g["limit"]
    if not ok:
        fail("pipeline / ring (phase 39)")


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


def serving_and_training_phases(report: dict, card: str) -> None:
    """Phases 4-7, 10, 11, 14, 15, 17-23, 29, 33 and 34, in this process."""
    import shutil
    import tempfile

    timed(phase_parity)
    timed(phase_quant_parity)
    timed(phase_generate_parity)
    timed(phase_fronts_parity)
    root = tempfile.mkdtemp(prefix="_smoke_results_", dir=REPO)  # listed in .gitignore
    try:
        float_run = timed(phase_slice, report, root)
        timed(phase_quant_slice, report, root, float_run)
        timed(phase_fronts_slice, root, float_run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    serving_k1 = report["flash_attention_fwd"]["launches"]
    timed(phase_train_parity)
    timed(phase_vision_parity)
    timed(phase_lora_parity)
    timed(phase_moe_parity)
    root = tempfile.mkdtemp(prefix="_smoke_train_", dir=REPO)
    try:
        vision_best = timed(phase_vision_slice, report, os.path.join(root, "vision"))
        data = timed(phase_train_slice, report, root, vision_path=vision_best)
        answers = timed(phase_answer_slice, root)  # on phase 7's results dir and data
        timed(phase_analysis, root)
        timed(phase_lora_slice, root, data)  # on phase 7's data
        timed(phase_remap_chain, root, answers["float"])  # phase 7's weights, 15's answers
        timed(phase_moe_slice, os.path.join(root, "moe"), data)  # on phase 7's data
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[timing] K1 forward launches: serving slice {serving_k1}, training slice "
          f"{report['flash_attention_fwd']['launches']}", flush=True)


def clip_and_bench_phases(report: dict, card: str) -> None:
    """Phases 8, 9, 12, 13, 24-26 and 35, in this process."""
    import shutil
    import tempfile

    dense_clip = timed(phase_clip_parity)
    timed(phase_partitioned_parity, dense_clip)
    timed(phase_variant_parity)
    root = tempfile.mkdtemp(prefix="_smoke_clip_", dir=REPO)
    try:
        clip_run = timed(phase_clip_slice, report, root)
        timed(phase_variant_slice, report, clip_run)  # on phase 9's generated data
        timed(phase_partitioned_clip_slice, root, clip_run, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    timed(phase_moe_bench, card)
    timed(phase_multi_lora_bench)


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
                             "forward and backward beside K2, K6's forward and backward, K1's "
                             "backward, K5, K5v3a and K5v3b, K3 and K4 (bf16, graph replay) "
                             "beside their library calls; no other phase")
    parser.add_argument("--profile-mllm", metavar="ROOT", nargs="?", const=".",
                        help="build the kernels of the checkout at ROOT (default: this one), "
                             "then profile the full MLLM micro-step; no other phase")
    parser.add_argument("--profile-vision", action="store_true",
                        help="build, then profile one vision-trainer micro-step at its "
                             "slice's shape; no other phase")
    parser.add_argument("--profile-decode", metavar="ROOT", nargs="?", const=".",
                        help="build the kernels of the checkout at ROOT (default: this one), "
                             "then profile the full MLLM's paged decode step at batch 8 "
                             "(K3; MCL_PAGED_KERNEL=2: K4); no other phase")
    parser.add_argument("--int8-kv", action="store_true",
                        help="with --profile-decode: int8 page pools (gather, dequantize, K1)")
    parser.add_argument("--profile-moe", action="store_true",
                        help="build, then profile one step of phase 35's E=4 bench cell, "
                             "dense then sparse dispatch; no other phase")
    parser.add_argument("--mesh-worker", nargs=6, metavar=("PHASES", "RANK", "WORLD", "PORT",
                                                          "JOBDIR", "BACKEND"),
                        help="one rank of phases 37-39 (started by this script): the "
                             "comma-separated PHASES in turn; no other phase")
    parser.add_argument("--side", metavar="ROOT",
                        help=f"the second process (started by this script): phases "
                             f"{SIDE_PHASES} under ROOT; no other phase")
    parser.add_argument("--dp-worker", metavar="JOBS",
                        help="under torchrun (phase 36): run the trainer CLIs the JSON file "
                             "JOBS lists in this process; no other phase")
    args = parser.parse_args(argv)
    ab_root = (args.time_forwards or args.time_variants or args.profile_mllm
               or args.profile_decode)
    if ab_root:
        sys.path.insert(0, os.path.abspath(ab_root))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA device")
    if not os.path.isdir(os.path.join(REPO, "multimodal_concept_learning_tpu_torch")):
        fail(f"no multimodal_concept_learning_tpu_torch package beside {__file__}: "
             "run this script from a checkout of the repository")
    from multimodal_concept_learning_tpu_torch.device import set_reference_numerics

    set_reference_numerics()
    if args.dp_worker:
        dp_worker(args.dp_worker)
        return
    if args.mesh_worker:
        mesh_worker(args.mesh_worker)
        return
    if args.side:
        side_worker(args.side)
        return
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
    if args.profile_vision:
        profile_vision()
        return
    if args.profile_moe:
        profile_moe()
        return
    if args.profile_decode:
        profile_decode(args.profile_decode, int8_kv=args.int8_kv)
        return
    report: dict = {}
    timed(phase_kernels, report)  # alone on the card: the kernels' times
    side = _Side(tempfile.mkdtemp(prefix="_smoke_side_", dir=REPO), 1100)
    mesh_root, ranks = tempfile.mkdtemp(prefix="_smoke_mesh_", dir=REPO), None
    try:
        serving_and_training_phases(report, card)
        # the ranks of phases 37-39 run beside the CLIP and bench phases
        ranks = _Ranks(("serve", "train", "pipe"), mesh_root, MESH_WORLD, "gloo", 900)
        clip_and_bench_phases(report, card)
        nccl = side.join()
        torch.cuda.empty_cache()
        timed(phase_mesh_serving, ranks, card, nccl)
        timed(phase_mesh_training, ranks, card)
        timed(phase_mesh_pipeline, ranks, card)
    finally:
        if ranks is not None:
            ranks.stop()
        side.stop()
        shutil.rmtree(mesh_root, ignore_errors=True)
        shutil.rmtree(side.root, ignore_errors=True)
    timed(phase_ab, report)  # alone on the card again
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
