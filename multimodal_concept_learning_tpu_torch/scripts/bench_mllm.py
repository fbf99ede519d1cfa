"""MLLM concept-learning step throughput (counterpart of scripts/bench_mllm.py
of the JAX package).

    python -m multimodal_concept_learning_tpu_torch.scripts.bench_mllm \\
        [--batch 32] [--ood 90] [--moe_experts 4 --moe_top_k 2 \\
        --moe_dispatch dense|sparse --moe_capacity_factor 1.25 --moe_stats] \\
        [--bf16_params] [--host_init] [--device cuda]

The JAX script's cell: a vit-b-16 tower and a gemma3-1b LM at 224 px, 197
vision tokens and 40 text tokens, ``language_embed_only`` training (the
embedding table and the projector train), one fixed batch made from seed
0, weights from a seeded random init made on the device (``--host_init``:
made on the host and shipped in bf16, implying ``--bf16_params``).  The
steps are the trainer's ``make_mllm_train_step`` (answer CE, plus 0.01 x the
mean MoE aux under ``--moe_experts``); 10 steps warm up, then 3 x 10 are
timed on the host clock to the end of the device's work.  It prints
images/s and concept-token updates/s (``--ood`` rows updated per step) as
the JAX script does, and a JSON line.  ``--moe_stats`` prints
``ops/moe.router_stats`` of the routers' logits on the batch before and
after the timed steps (``drop_frac`` is the share of assignments a sparse
dispatch at ``--moe_capacity_factor`` drops).  ``--device cpu`` rehearses it at
full width, slowly; its times are the host's, not a device number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.checkpoint import init_random_weights_
from multimodal_concept_learning_tpu_torch.device import cast_for_compute, resolve_device
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM, MLLMConfig, trainable_mask
from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux, router_stats
from multimodal_concept_learning_tpu_torch.parallel.optimizer import build_optimizer
from multimodal_concept_learning_tpu_torch.parallel.train_step import (
    TrainState,
    make_mllm_train_step,
)
from multimodal_concept_learning_tpu_torch.tokenizer import ConceptTokenizer

INNER = 10
REPEATS = 3
TEXT_LEN = 40


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--ood", type=int, default=90)
    parser.add_argument("--bf16_params", action="store_true")
    parser.add_argument("--moe_experts", type=int, default=0)
    parser.add_argument("--moe_top_k", type=int, default=2)
    parser.add_argument("--moe_dispatch", type=str, default="dense", choices=["dense", "sparse"])
    parser.add_argument("--moe_capacity_factor", type=float, default=1.25)
    parser.add_argument("--moe_stats", action="store_true")
    parser.add_argument("--host_init", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def build(args, dev: torch.device):
    """(model with trainable mask and storage set, batch on ``dev``, vocab)."""
    tokenizer = ConceptTokenizer()
    tokenizer.add_tokens([f"<ood {i}>" for i in range(1, args.ood + 1)])
    vocab = len(tokenizer)
    cfg = MLLMConfig.create(
        vocab_size=vocab, vision_preset="vit-b-16", lm_preset="gemma3-1b",
        num_vision_tokens=197, image_size=224, lm_moe_experts=args.moe_experts,
        lm_moe_top_k=args.moe_top_k, lm_moe_dispatch=args.moe_dispatch,
        lm_moe_capacity_factor=args.moe_capacity_factor)
    if args.host_init:
        args.bf16_params = True
        with torch.device("cpu"):
            model = MLLM(cfg)
        init_random_weights_(model, torch.Generator().manual_seed(0))
        t0 = time.time()
        model = model.to(torch.bfloat16).to(dev)
        print(f"host_init: shipped bf16 tree in {time.time() - t0:.1f}s", file=sys.stderr)
    else:
        with torch.device(dev):
            model = MLLM(cfg)
        init_random_weights_(model, torch.Generator(device=dev).manual_seed(0))
    trainable_mask(model, "language_embed_only")
    if args.bf16_params:
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    else:  # the trainer's storage: frozen weights in the compute dtype, once
        cast_for_compute(model, cfg.dtype, only_frozen=True)

    rng = np.random.default_rng(0)
    b, nvt = args.batch, 197
    t = nvt + TEXT_LEN
    ids = np.concatenate([np.zeros((b, nvt), np.int32),
                          rng.integers(4, vocab - args.ood, size=(b, TEXT_LEN)).astype(np.int32)],
                         axis=1)
    labels = np.full((b, t), -100, np.int32)
    labels[:, -2], labels[:, -1] = 7, 8
    batch = {"images": rng.normal(size=(b, 3, 224, 224)).astype(np.float32), "input_ids": ids,
             "attention_mask": np.ones((b, t), np.int32), "labels": labels,
             "kv_lens": np.full(b, t, np.int32)}
    return model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@torch.no_grad()
def probe_router(model, batch, args, label) -> dict:
    """``router_stats`` of every layer's router logits on ``batch``, printed."""
    rec = MoEAux(keep_logits=True)
    model.eval()
    model(batch["images"], batch["input_ids"], batch["attention_mask"], batch["labels"],
          kv_lens=batch["kv_lens"], moe_aux=rec)
    st = router_stats(rec.logits, args.moe_top_k, args.moe_capacity_factor)
    print(f"router_stats {label} cf={args.moe_capacity_factor} ({len(rec.logits)} layers): "
          f"drop_frac={st['drop_frac']:.4f} worst_layer={st['drop_frac_worst_layer']:.4f} "
          f"entropy={st['entropy']:.3f} aux={st['aux']:.4f} "
          f"load={np.round(st['load_frac'], 3)}", file=sys.stderr)
    return dict(st, load_frac=[float(v) for v in st["load_frac"]])


def train_state(model, args):
    """(TrainState, step): the timed optimizer and ``make_mllm_train_step``."""
    opt = build_optimizer(model, 5e-4, weight_decay=1e-4, max_grad_norm=1.0,
                          fp32_master=args.bf16_params)
    return TrainState(model=model, optimizer=opt), make_mllm_train_step(model)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    """The benchmark; returns the JSON record it prints last."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model, batch = build(args, dev)
    record = {}
    if args.moe_stats and args.moe_experts:
        record["router_stats_pre"] = probe_router(model, batch, args, "pre-train")
    state, step = train_state(model, args)

    t0 = time.time()
    for _ in range(INNER):
        state, m = step(state, batch)
    print(f"compile+warmup: {time.time() - t0:.1f}s loss={m['loss'].item():.4f}",
          file=sys.stderr)
    _sync(dev)
    t0 = time.time()
    for _ in range(INNER * REPEATS):
        state, m = step(state, batch)
    final = m["loss"].item()  # waits for the last step
    elapsed = time.time() - t0
    if args.moe_stats and args.moe_experts:
        record["router_stats_post"] = probe_router(model, batch, args,
                                                   f"post-train ({INNER * REPEATS} steps)")

    steps_per_sec = INNER * REPEATS / elapsed
    img_per_sec = args.batch * steps_per_sec
    concept_updates_per_sec = args.ood * steps_per_sec
    print(f"steps/s={steps_per_sec:.2f} imgs/s={img_per_sec:.1f} "
          f"concept-updates/s={concept_updates_per_sec:.0f} loss={final:.4f}", file=sys.stderr)
    record.update({
        "metric": "MLLM language_embed_only images/sec fwd+bwd",
        "value": round(img_per_sec, 2),
        "unit": "images/sec",
        "concept_token_updates_per_sec": round(concept_updates_per_sec, 1),
        "steps_per_sec": steps_per_sec,
        "loss": final,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 2**30
                           if dev.type == "cuda" else None),
    })
    print(json.dumps(record))
    return record


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
