"""CLIP-style contrastive training CLI (counterpart of
multimodal_concept_learning_tpu/train/contrastive_training.py).

    python -m multimodal_concept_learning_tpu_torch.train.contrastive_training \\
        --config_path experiments/contrastive/color/12_colors_3k.yaml --device cuda

The same YAML schema (``ContrastiveTrainingConfig``), log lines and
per-epoch metrics as the JAX trainer: AdamW with clipping and a linear
warm-up schedule over the symmetric InfoNCE of (image, caption) batches,
then zero-shot classification of the test split against each class's
caption, embedded once.  Weights start from a seeded random init (the JAX
initialisers); compute is bf16 over float32 parameters.  Both towers'
attention runs through K2 (``ops/attention_core.py``); under
``MCL_ATTN_CORE_BD=1`` both take K2-bd, the sample-merged kernels, as the
JAX CLI does on a TPU (no flag: the variable is read at each call).  The final weights
are saved as a ``.pt`` state dict of float32 tensors,
``results_dir/checkpoints/step_{N}.pt`` (the JAX trainer writes an orbax
``step_{N}`` directory).

``partition_text_embedding: true`` builds the active rows from the caption
corpus (every class's caption, padding included), prints "Partitioned text
embedding: N active rows of V" and trains the partitioned table
(``ops/sparse_embed.py``): the full table frozen, the subtable under AdamW.
The final save folds the inactive rows' weight decay in (the schedule at
updates ``0..n-1``, ``n`` the optimizer's update count, restored ones
included) and writes the merged table under the dense name
``text.token_embedding.weight``, so the dense ``CLIPModel`` and every
reader of the dense layout get the trained values; the subtable stays
beside it as ``text.token_embedding.active``, which a dense
``strict=True`` load ignores (``models/clip.py``).  ``bf16_params: true``
stores every parameter in bf16 (the frozen table too) with float32 masters
in AdamW, as the other two trainers do; the similarity scale then follows
JAX's jitted step (the clip bound in bf16, ``exp`` in float32;
``models/clip.py``), and the merged table is rounded as JAX rounds it
(``merged_embedding``).
``resume: true`` saves the training state at each epoch's end and restores
the newest on start; SIGTERM saves a mid-epoch checkpoint and ``main``
returns ``{"preempted": True}`` (``train/common.py``).  Under ``torchrun``
it trains data parallel, as the MLLM trainer does; the InfoNCE runs over
the global batch's [B, B] logits (the ranks' features gathered with their
gradient), and rank 0 logs and writes.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.checkpoint import (
    host_state_dict,
    init_random_weights_,
    save_state_dict,
)
from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
from multimodal_concept_learning_tpu_torch.data.clip_collator import ClipCollator
from multimodal_concept_learning_tpu_torch.data.datasets import ColorDataset, load_split_datasets
from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
from multimodal_concept_learning_tpu_torch.device import resolve_device
from multimodal_concept_learning_tpu_torch.models.clip import CLIPConfig, CLIPModel
from multimodal_concept_learning_tpu_torch.ops.sparse_embed import (
    PartitionedEmbed,
    active_rows_from_corpus,
    inactive_decay,
    merged_embedding,
)
from multimodal_concept_learning_tpu_torch.parallel import multihost
from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
    build_optimizer,
    linear_warmup_schedule,
)
from multimodal_concept_learning_tpu_torch.parallel.train_step import (
    TrainState,
    make_clip_train_step,
    make_zero_shot_step,
)
from multimodal_concept_learning_tpu_torch.tokenizer import load_tokenizer
from multimodal_concept_learning_tpu_torch.train.common import (
    PreemptionGuard,
    ResumeManager,
    epoch_batches,
    epoch_metric_mean,
    process_local_loader_args,
)
from multimodal_concept_learning_tpu_torch.utils.logging import MetricsLogger


def init_model(config: ContrastiveTrainingConfig, vocab_size: int, device,
               active_rows=None) -> CLIPModel:
    """The config's CLIP (bf16 compute) with float32 parameters on
    ``device``, from the seeded random init (``torch.Generator`` on the
    device, seed ``config.seed``); ``active_rows`` partitions its text
    embedding (the same initial table as the dense model's)."""
    dev = resolve_device(device)
    cfg = CLIPConfig.create(vocab_size=vocab_size, vision_preset=config.vision_model_name,
                            image_size=config.image_size, text_width=config.text_width,
                            text_layers=config.text_layers, text_heads=config.text_heads,
                            context_length=config.context_length, embed_dim=config.embed_dim,
                            dtype=torch.bfloat16, active_vocab_rows=active_rows)
    with torch.device(dev):
        model = CLIPModel(cfg)
    return init_random_weights_(model, torch.Generator(device=dev).manual_seed(config.seed))


def export_state_dict(state: TrainState, weight_decay: float):
    """The model's float32 host state dict; a partitioned text embedding's
    table merged (``merged_embedding``, rounded to the table's dtype) with
    the inactive rows' weight decay over the optimizer's updates so far."""
    model, optimizer = state.model, state.optimizer
    sd = host_state_dict(model)
    emb = model.text.token_embedding
    if isinstance(emb, PartitionedEmbed):
        # the learning rates AdamW applied (float32), evaluated on the host
        lrs = [float(np.float32(optimizer.lr(i))) for i in range(optimizer.count)]
        merged = merged_embedding(emb.weight, emb.active, emb.active_rows,
                                  inactive_decay(lrs, weight_decay))
        sd["text.token_embedding.weight"] = merged.to(emb.weight.dtype).float().cpu()
    return sd


def run_training(model: CLIPModel, train_loader, config: ContrastiveTrainingConfig):
    """Train ``model`` (on its device) as the JAX ``run_training`` does and
    save the final weights (``export_state_dict``); returns (final
    TrainState, per-epoch metrics, checkpoint path), or None when SIGTERM
    preempted the run."""
    device = next(model.parameters()).device
    is_main = multihost.is_main_process()
    accumulation_steps = max(1, config.effective_batch_size // config.batch_size)
    total_updates = max(1, (len(train_loader) * config.epochs) // accumulation_steps)
    schedule = linear_warmup_schedule(config.learning_rate, config.warmup_steps, total_updates)
    if config.bf16_params:  # bf16 storage of every parameter, float32 masters in AdamW
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    optimizer = build_optimizer(model, schedule, weight_decay=config.weight_decay,
                                max_grad_norm=config.max_grad_norm,
                                accumulation_steps=accumulation_steps,
                                fp32_master=config.bf16_params)
    state = TrainState(model=model, optimizer=optimizer)
    resume = ResumeManager(config.results_dir, config.resume)
    state, start_epoch, meta = resume.restore(state)
    guard = PreemptionGuard(enabled=config.resume)
    skip_batches = int(meta.get("skip_batches", 0) or 0)
    train_step = make_clip_train_step(model)
    logger = MetricsLogger(enabled=is_main, use_wandb=config.use_wandb,
                           wandb_project=config.wandb_project,
                           wandb_run_name=config.wandb_run_name or config.run_name,
                           wandb_config=vars(config))
    if is_main:
        os.makedirs(config.results_dir, exist_ok=True)
    history = []
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        train_loader.set_epoch(epoch)
        losses = []  # 0-d device tensors: one host sync per epoch
        done_in_epoch = skip_batches if epoch == start_epoch else 0
        for batch in prefetch_to_device(epoch_batches(train_loader, done_in_epoch), device):
            state, m = train_step(state, batch)
            done_in_epoch += 1
            losses.append(m["loss"])
            if guard.agreed():
                resume.save_preempted(state, epoch, done_in_epoch, {})
                logger.finish()
                guard.close()
                return None
        train_loss = epoch_metric_mean(losses)
        epoch_time = time.time() - t0
        metrics = {"epoch": epoch + 1, "train_loss": train_loss, "epoch_time": epoch_time,
                   "steps": len(losses)}
        if is_main:
            print(f"Epoch {epoch + 1}/{config.epochs} completed in {epoch_time:.2f}s | "
                  f"Train Loss: {train_loss:.4f}")
        logger.log(metrics)
        history.append(metrics)
        resume.save(state, epoch, {})
    resume.finalize()
    guard.close()
    ckpt_dir = os.path.join(config.results_dir, "checkpoints")
    path = os.path.join(ckpt_dir, f"step_{state.step}.pt")
    if is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
        save_state_dict(export_state_dict(state, config.weight_decay), path)
    logger.finish()
    return state, history, path


def zero_shot_eval(model: CLIPModel, loader, class_names, collator: ClipCollator, device) -> float:
    """Zero-shot accuracy: nearest caption embedding per class."""
    ids, masks = zip(*(collator.caption_ids(name) for name in class_names))
    with torch.no_grad():
        model.eval()
        class_features = model.encode_text(torch.from_numpy(np.stack(ids)).to(device),
                                           torch.from_numpy(np.stack(masks)).to(device))
    step = make_zero_shot_step(model)
    correct, total = 0, 0
    for batch in prefetch_to_device(loader, device):
        c, n = step(model, batch, class_features)
        correct += int(c)
        total += int(n)
    acc = 100.0 * correct / max(total, 1)
    print(f"Zero-shot accuracy: {acc:.2f}% ({correct}/{total})")
    return acc


def main(argv=None):
    """The CLI; returns {"zero_shot_acc", "history" (per-epoch metrics),
    "checkpoint" (path), "state" (the final TrainState)}, or
    ``{"preempted": True}`` after SIGTERM."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if multihost.init_distributed(args.device):
        device = multihost.process_device(args.device)
        print(f"distributed: process {multihost.rank()}/{multihost.world_size()}")
    else:
        device = resolve_device(args.device)

    with open(args.config_path) as f:
        config = ContrastiveTrainingConfig.from_params(miniyaml.safe_load(f))
    random.seed(config.seed)
    np.random.seed(config.seed)
    tokenizer = load_tokenizer("concept-tokenizer")

    train_dataset, val_dataset, test_dataset = load_split_datasets(
        ColorDataset, mapping_dir=os.path.dirname(config.mapping_path),
        data_dir=config.image_root,
        train_transform=create_transforms(config, is_train=True, seed=config.seed),
        val_transform=create_transforms(config, is_train=False, seed=config.seed),
        return_synset=True)
    class_names = train_dataset.unique_labels
    label_to_idx = {n: i for i, n in enumerate(class_names)}
    print(f"Loaded contrastive dataset with {len(train_dataset)} train / "
          f"{len(val_dataset)} val / {len(test_dataset)} test pairs, "
          f"{len(class_names)} concepts")

    collator = ClipCollator(tokenizer, config.caption_template, config.context_length)
    active_rows = None
    if config.partition_text_embedding:
        # the caption corpus (one template x the class names) is enumerable:
        # every id the text tower can gather, padding included
        active_rows = active_rows_from_corpus([collator.caption_ids(n)[0] for n in class_names])
        print(f"Partitioned text embedding: {len(active_rows)} active rows of {len(tokenizer)}")
    model = init_model(config, len(tokenizer), device, active_rows)
    local_bs, pshard = process_local_loader_args(config.batch_size)
    train_loader = BatchLoader(train_dataset, batch_size=local_bs, shuffle=True,
                               drop_last=True, collate_fn=collator, seed=config.seed,
                               process_shard=pshard)
    out = run_training(model, train_loader, config)
    if out is None:  # graceful preemption: resume later with resume: true
        return {"preempted": True}
    state, history, path = out

    def eval_collate(batch):
        images = np.stack([b[0] for b in batch]).astype(np.float32)
        labels = np.asarray([label_to_idx[b[1]] for b in batch], dtype=np.int32)
        return {"images": images, "labels": labels}

    test_loader = BatchLoader(test_dataset, batch_size=local_bs, collate_fn=eval_collate,
                              process_shard=pshard)
    acc = zero_shot_eval(model, test_loader, class_names, collator, device)
    return {"zero_shot_acc": acc, "history": history, "checkpoint": path, "state": state}


if __name__ == "__main__":
    main()
