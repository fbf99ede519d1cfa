"""Generation-based evaluation CLI (counterpart of
multimodal_concept_learning_tpu/train/generate_answers.py).

    python -m multimodal_concept_learning_tpu_torch.train.generate_answers \\
        --results_dir RESULTS [--checkpoint best_model.pt] [--split test] \\
        [--max_new_tokens 8] [--limit N] [--int4 | --int8 [--int8_vision]] \\
        [--num_beams K [--length_penalty A] | --draft_layers N [--draft_len G]] \\
        [--device cuda]

Loads a trained results directory (the reference layout) through the
port's ``serve/loader.load_trained_mllm``, strips each prompt of its
supervised answer span, and GENERATES the answer over dense KV caches
(``models/mllm.generate``).  The JAX CLI's flags, output lines and
``<results_dir>/generations.jsonl`` rows: the yes/no string-match accuracy
(the reference's metric) and the exact-match accuracy of the generated
answer against the target span.  ``--int4`` runs K5 in every decode
projection, ``--int8`` the int8 product; ``--device`` (default ``cuda``)
and ``--dtype`` (default ``bfloat16``, the JAX loader's compute dtype) are
the port's own.  ``--num_beams K`` decodes by beam search
(``models/beam.py``) and ``--draft_layers N`` by self-speculative greedy
decoding (``models/speculative.py``), as the JAX CLI wires them.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
from multimodal_concept_learning_tpu_torch.data.datasets import (
    ColorDataset,
    ImageNetDataset,
    load_split_datasets,
)
from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
from multimodal_concept_learning_tpu_torch.device import resolve_device
from multimodal_concept_learning_tpu_torch.models.beam import beam_generate
from multimodal_concept_learning_tpu_torch.models.mllm import generate
from multimodal_concept_learning_tpu_torch.models.speculative import speculative_generate
from multimodal_concept_learning_tpu_torch.ops.losses import IGNORE_INDEX
from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def strip_answer_span(input_ids: np.ndarray, attention_mask: np.ndarray,
                      labels: np.ndarray, pad_id: int):
    """Truncate each row at its first supervised position.

    The collator appends the answer to the prompt and marks it in
    ``labels``; generation must not see it.  Rows stay right-padded, so the
    decode path's slot == position invariant holds.
    """
    supervised = labels != IGNORE_INDEX  # [B, T]
    has_answer = supervised.any(axis=1)
    first = np.where(has_answer, supervised.argmax(axis=1), input_ids.shape[1])
    keep = np.arange(input_ids.shape[1])[None, :] < first[:, None]
    ids = np.where(keep, input_ids, pad_id).astype(np.int32)
    mask = np.where(keep, attention_mask, 0).astype(np.int32)
    return ids, mask


def _decode(tokenizer, ids) -> str:
    return tokenizer.decode([int(i) for i in ids if int(i) >= 0],
                            skip_special_tokens=True).strip()


def _images(batch, device) -> torch.Tensor:
    """The batch's NCHW float images on ``device`` (either batch contract)."""
    keys = ("images_u8", "norm_mean", "norm_std") if "images_u8" in batch else ("images",)
    return images_from_batch({k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
                              for k in keys})


def main(argv=None):
    """The CLI; returns {"yes_no_acc", "exact_acc", "n"} as the JAX CLI does,
    plus "seconds" (host time in generation, synchronised) and "batches"."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default="best_model.pt")
    parser.add_argument("--split", type=str, default="test",
                        choices=("train", "val", "test"))
    parser.add_argument("--max_new_tokens", type=int, default=8)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate at most N samples")
    parser.add_argument("--output", type=str, default=None,
                        help="default: <results_dir>/generations.jsonl")
    parser.add_argument("--int8", action="store_true",
                        help="quantize LM weights to int8 for decode (serving mode, lossy)")
    parser.add_argument("--int8_vision", action="store_true",
                        help="also quantize the vision tower (prefill)")
    parser.add_argument("--int4", action="store_true",
                        help="quantize LM weights to int4 (packed nibbles + group scales, "
                             "ops/int4.py): every decode projection runs the K5 kernel")
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy (default); >0 samples")
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--sample_seed", type=int, default=0,
                        help="seed of the torch.Generator the sampler draws from")
    parser.add_argument("--draft_layers", type=int, default=0,
                        help=">0: self-speculative greedy decoding with this early-exit "
                             "draft depth (models/speculative.py)")
    parser.add_argument("--draft_len", type=int, default=4)
    parser.add_argument("--num_beams", type=int, default=1,
                        help=">1: beam search of this width (models/beam.py; greedy path "
                             "when 1)")
    parser.add_argument("--length_penalty", type=float, default=0.0,
                        help="beam search: alpha dividing scores by len**a")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--dtype", type=str, default="bfloat16", choices=tuple(DTYPES))
    args = parser.parse_args(argv)
    if args.draft_layers > 0 and args.temperature > 0:
        parser.error("--draft_layers implies greedy (temperature 0)")
    if args.num_beams > 1 and (args.temperature > 0 or args.draft_layers > 0):
        parser.error("--num_beams implies greedy, non-speculative decoding")
    device = resolve_device(args.device)

    from multimodal_concept_learning_tpu_torch.serve.loader import load_trained_mllm

    loaded = load_trained_mllm(args.results_dir, checkpoint=args.checkpoint, int8=args.int8,
                               int8_vision=args.int8_vision, int4=args.int4, device=device,
                               dtype=DTYPES[args.dtype])
    model, tokenizer, config, labels_mapping = (loaded.model, loaded.tokenizer, loaded.config,
                                                loaded.labels_mapping)
    transform = create_transforms(config, is_train=False, seed=config.seed)
    dataset_cls = (ColorDataset if config.dataset_name == "color_multimodal"
                   else ImageNetDataset)
    splits = load_split_datasets(
        dataset_cls, mapping_dir=os.path.dirname(config.mapping_path),
        data_dir=config.image_root, train_transform=transform, val_transform=transform,
        return_synset=True)
    dataset = splits[("train", "val", "test").index(args.split)]

    collator = MultimodalCollator(
        tokenizer=tokenizer, num_vision_tokens=config.num_vision_tokens,
        prompt_template=config.prompt_template, all_class_names=dataset.unique_labels,
        labels_mapping=labels_mapping, seed=config.seed)
    batch_size = args.batch_size or config.batch_size
    loader = BatchLoader(dataset, batch_size=batch_size, collate_fn=collator,
                         num_workers=config.num_workers)

    eos_id = getattr(tokenizer, "eos_token_id", None)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    generator = torch.Generator(device=device).manual_seed(args.sample_seed)
    common = dict(eos_id=eos_id, pad_id=pad_id)
    if args.num_beams > 1:
        def gen_fn(images, ids, mask):
            return beam_generate(model, images, ids, mask, args.max_new_tokens, args.num_beams,
                                 length_penalty=args.length_penalty, **common)
    elif args.draft_layers > 0:
        def gen_fn(images, ids, mask):
            return speculative_generate(model, images, ids, mask, args.max_new_tokens,
                                        draft_layers=args.draft_layers,
                                        draft_len=args.draft_len, **common)
    else:
        def gen_fn(images, ids, mask):
            return generate(model, images, ids, mask, args.max_new_tokens,
                            generator=generator, temperature=args.temperature,
                            top_k=args.top_k, top_p=args.top_p, **common)

    out_path = args.output or os.path.join(args.results_dir, "generations.jsonl")
    n_done = yes_correct = exact_correct = batches = 0
    seconds = 0.0
    with open(out_path, "w") as sink:
        for batch in loader:
            ids, mask = strip_answer_span(
                batch["input_ids"], batch["attention_mask"], batch["labels"], pad_id)
            t0 = time.perf_counter()
            gen = gen_fn(_images(batch, device), torch.from_numpy(ids),
                         torch.from_numpy(mask)).cpu().numpy()
            seconds += time.perf_counter() - t0
            batches += 1
            valid = batch.get("valid", np.ones(gen.shape[0], bool))
            labels = batch["labels"]
            for i in range(gen.shape[0]):
                if not valid[i]:
                    continue
                if args.limit is not None and n_done >= args.limit:
                    break
                row = gen[i]
                if eos_id is not None:
                    stop = np.nonzero(row == eos_id)[0]
                    if stop.size:
                        row = row[: stop[0]]
                generated = _decode(tokenizer, row)
                target = _decode(tokenizer, labels[i][labels[i] != IGNORE_INDEX])
                prompt = _decode(tokenizer, ids[i][mask[i] == 1])
                yes_match = ("yes" in generated.lower()) == ("yes" in target.lower())
                # prefix match: a model that hasn't learned to emit EOS keeps
                # generating after the answer; credit the answer span itself
                exact = generated == target or (
                    bool(target) and generated.startswith(target + " "))
                yes_correct += int(yes_match)
                exact_correct += int(exact)
                n_done += 1
                sink.write(json.dumps({
                    "prompt": prompt, "generated": generated, "target": target,
                    "yes_no_match": yes_match, "exact_match": exact,
                }) + "\n")
            if args.limit is not None and n_done >= args.limit:
                break

    yes_acc = 100.0 * yes_correct / n_done if n_done else 0.0
    exact_acc = 100.0 * exact_correct / n_done if n_done else 0.0
    print(f"Generated answers for {n_done} samples ({args.split} split)")
    print(f"Yes/No Accuracy: {yes_acc:.2f}%")
    print(f"Exact-Match Accuracy: {exact_acc:.2f}%")
    print(f"Wrote {out_path}")
    return {"yes_no_acc": yes_acc, "exact_acc": exact_acc, "n": n_done, "seconds": seconds,
            "batches": batches}


if __name__ == "__main__":
    main()
