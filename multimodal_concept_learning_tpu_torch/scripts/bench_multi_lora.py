"""Multi-LoRA serving overhead: a bank of k adapters against one adapter
(counterpart of scripts/bench_multi_lora.py of the JAX package).

    python -m multimodal_concept_learning_tpu_torch.scripts.bench_multi_lora \\
        [--batch 8] [--rank 8] [--k 4] [--lengths 2,16,64] [--preset gemma3-1b] \\
        [--tiny] [--device cuda]

The model is the MLLM with rank-r adapters (vit-b-16 and the LM preset at
224 px, or vit-t-8 and nano at 32 px with ``--tiny``), seeded random
weights, stored in bf16 at full size.  Greedy generation of one batch
(prompts of the vision tokens and 24 text tokens) at each length, for

  plain  the model with its own factors (``models/mllm.greedy_generate``);
  bank   a bank of k adapters (entry 0 the identity, entries 1..k-1 seeded
         factors and projectors) with mixed per-row ids
         (``ops/multi_lora.multi_lora_generate``).

Each length runs once to warm up, then 3 times; a call is timed on the
host clock from its start to the end of the device's work.  A line fitted
to the times gives ms a token and a fixed cost (the prefill and the
call's overheads).  ``--device cpu --tiny`` rehearses the script; its times
are the host's, not a device number.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
from multimodal_concept_learning_tpu_torch.device import resolve_device, set_reference_numerics
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig, greedy_generate
from multimodal_concept_learning_tpu_torch.ops.multi_lora import (
    identity_adapter_params,
    is_adapter_name,
    multi_lora_generate,
    stack_adapter_params,
)
from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

TEXT_LEN = 24
REPEATS = 3


def build(args, dev: torch.device):
    """(model, bank, adapter ids [B], (images, ids, mask)) from the seeds."""
    if args.tiny:
        preset, vision, size, nvt, dtype = "nano", "vit-t-8", 32, 17, torch.float32
    else:
        preset, vision, size, nvt, dtype = args.preset, "vit-b-16", 224, 197, torch.bfloat16
    vocab = len(ConceptTokenizer())
    cfg = MLLMConfig.create(vocab_size=vocab, vision_preset=vision, lm_preset=preset,
                            num_vision_tokens=nvt, image_size=size, lm_lora_rank=args.rank,
                            dtype=dtype)
    with torch.device(dev):
        model = MLLM(cfg)
    init_random_weights_(model, torch.Generator(device=dev).manual_seed(0))
    for p in model.parameters():
        p.data = p.data.to(dtype)
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(7)
    sd = model.state_dict()

    def variant():
        return {k: torch.randn(v.shape, generator=gen, device=dev).to(v.dtype) * 0.02
                if is_adapter_name(k) else v for k, v in sd.items()}

    bank = stack_adapter_params([identity_adapter_params(sd)]
                                + [variant() for _ in range(args.k - 1)])
    bank = {k: v for k, v in bank.items() if is_adapter_name(k)}
    rng = np.random.default_rng(0)
    b = args.batch
    images = rng.normal(size=(b, 3, size, size)).astype(np.float32)
    ids = np.zeros((b, nvt + TEXT_LEN), np.int32)
    ids[:, nvt:] = rng.integers(4, vocab, size=(b, TEXT_LEN))
    inputs = tuple(torch.from_numpy(x).to(dev) for x in (images, ids, np.ones_like(ids)))
    aidx = torch.from_numpy(rng.integers(0, args.k, size=(b,))).to(dev)
    return model, bank, aidx, inputs


def _timed(fn, dev: torch.device):
    """(seconds a call over REPEATS calls after one warm-up, last output)."""
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = fn()
    out = out.cpu()  # waits for the device's work
    return (time.perf_counter() - t0) / REPEATS, out


def run(args) -> dict:
    dev = resolve_device(args.device)
    model, bank, aidx, inputs = build(args, dev)
    lengths = [int(x) for x in args.lengths.split(",")]
    results, outputs = {}, {}
    for name in ("plain", "bank"):
        times = {}
        for n in lengths:
            if name == "plain":
                fn = lambda n=n: greedy_generate(model, *inputs, max_new_tokens=n)  # noqa: E731
            else:
                fn = lambda n=n: multi_lora_generate(  # noqa: E731
                    model, bank, aidx, *inputs, max_new_tokens=n)
            times[n], outputs[name] = _timed(fn, dev)
            print(f"[mlora] {name} n_new={n:4d}: {times[n] * 1e3:8.1f} ms", flush=True)
        per_tok, fixed = np.polyfit(lengths, [times[n] for n in lengths], 1)
        results[name] = {"ms_per_token": 1e3 * per_tok, "fixed_ms": 1e3 * fixed,
                         "ms": {n: 1e3 * t for n, t in times.items()}}
    b = args.batch
    print(f"[mlora] batch={b} prompt={inputs[1].shape[1]} rank={args.rank} k={args.k} "
          f"lengths={lengths} adapters={aidx.tolist()}", flush=True)
    for name, r in results.items():
        print(f"[mlora]   {name:6s} {r['ms_per_token']:7.2f} ms/tok "
              f"(fixed {r['fixed_ms']:7.1f} ms)", flush=True)
    overhead = results["bank"]["ms_per_token"] / results["plain"]["ms_per_token"] - 1
    print(f"[mlora]   per-token overhead: {100 * overhead:+.1f}%", flush=True)
    results["overhead"] = overhead
    results["tokens"] = {k: v.numpy() for k, v in outputs.items()}
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--k", type=int, default=4)
    parser.add_argument("--lengths", type=str, default="2,16,64")
    parser.add_argument("--preset", type=str, default="gemma3-1b")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    set_reference_numerics()
    return run(args)


if __name__ == "__main__":
    main()
