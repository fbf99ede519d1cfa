"""Multimodal MLLM training CLI (counterpart of
multimodal_concept_learning_tpu/train/multimodal_training.py).

    python -m multimodal_concept_learning_tpu_torch.train.multimodal_training \\
        --config_path experiments/multimodal/color/12_colors_3k.yaml --device cuda

The same YAML schema, log lines and results layout as the JAX trainer:
``models/{initial_model.pt, tokenizer/, best_model.pt, training_config.json,
epoch_{e}_model.pt}`` with float32 leaves, the shifted yes/no test accuracy,
the tokenizer extended with the ``<ood N>`` tokens whose embedding rows are
copied from rows 0..k-1.  Weights start from a seeded random init (the
JAX initialisers; no pretrained download); ``vision_path`` warm-starts the
vision tower from a ``.pt`` of either package's vision trainer (or of an
MLLM), every tower tensor looked up as the JAX trainer does.  Compute is
bf16 over float32 trained parameters; frozen linear weights are stored in
bf16 once.  ``trainable_params_setting: language_lora`` with ``lm_lora_rank``
(and ``lm_lora_alpha``) trains the projector and the LM's LoRA factors
(``ops/lora.py``); the checkpoints hold them under the JAX package's names.
``resume: true`` saves the training state at each epoch's end and restores
the newest on start; SIGTERM saves a mid-epoch checkpoint and ``main``
returns ``{"preempted": True}`` (``train/common.py``).  As in JAX, the
collator's question stream is not part of that state: a resumed run draws
the questions of a fresh process (ROADMAP.md, queue C).

``dataset_name: imagenet_multimodal`` reads the ImageNet mapping CSVs beside
``mapping_path`` over the JPEGs of ``image_root``
(``data/datasets.ImageNetDataset``).  ``lm_moe_experts`` (with
``lm_moe_top_k``, ``lm_moe_dispatch``, ``lm_moe_capacity_factor``) puts a
routed MoE in every LM block's MLP place (``ops/moe.py``), and the loss
gains the 0.01-weighted aux.

Data parallel: under ``torchrun --nproc_per_node N`` (or any launcher that
sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT) each rank joins the
process group (NCCL on ``cuda:LOCAL_RANK``, Gloo with ``--device cpu``),
loads its stripe of every global batch of ``batch_size`` and sums its
gradients with the other ranks', so each update is the global batch's;
logs and every file come from rank 0 (``parallel/multihost.py``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import random
import time

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.checkpoint import (
    host_state_dict,
    init_random_weights_,
    load_state_dict,
    mllm_state_dict_from_torch,
    save_state_dict,
)
from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
from multimodal_concept_learning_tpu_torch.data.datasets import (
    ColorDataset,
    ImageNetDataset,
    load_split_datasets,
)
from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
from multimodal_concept_learning_tpu_torch.device import cast_for_compute, resolve_device
from multimodal_concept_learning_tpu_torch.models.mllm import (
    MLLM,
    copy_init_ood_rows,
    print_trainable_summary,
    trainable_mask,
)
from multimodal_concept_learning_tpu_torch.parallel import multihost
from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
    build_optimizer,
    linear_warmup_schedule,
)
from multimodal_concept_learning_tpu_torch.parallel.train_step import (
    TrainState,
    make_mllm_eval_step,
    make_mllm_train_step,
)
from multimodal_concept_learning_tpu_torch.serve.loader import build_tokenizer, model_config
from multimodal_concept_learning_tpu_torch.train.common import (
    PreemptionGuard,
    ResumeManager,
    epoch_batches,
    epoch_metric_mean,
    process_local_loader_args,
)
from multimodal_concept_learning_tpu_torch.utils.logging import MetricsLogger


def load_vision_tower_(model: MLLM, path: str) -> None:
    """Warm-start ``model.vision_model`` from the ``.pt`` at ``path``: each
    tower tensor is looked up under ``vit.``, ``module.vit.`` (a
    DDP-wrapped save), ``vision_model.``, then bare, as the JAX trainer
    does; every one must be found (KeyError naming the missing ones)."""
    sd = load_state_dict(path)
    found, missing = {}, []
    for name in model.vision_model.state_dict():
        key = next((c for c in (f"vit.{name}", f"module.vit.{name}", f"vision_model.{name}", name)
                    if c in sd), None)
        if key is None:
            missing.append(name)
        else:
            found[name] = sd[key]
    if missing:
        raise KeyError(f"vision_path {path} lacks {len(missing)} vision tower tensors: "
                       f"{missing}")
    model.vision_model.load_state_dict(found, strict=True)
    print(f"Loaded vision tower weights from {path}")


def init_model_and_tokenizer(config: MultimodalTrainingConfig, generator: torch.Generator,
                             device, dtype: torch.dtype = torch.bfloat16):
    """(model, tokenizer, labels_mapping, number of OOD tokens): the
    tokenizer plus the mapping's ``<ood ...>`` tokens, the MLLM with float32
    parameters on ``device`` from a seeded random init, the OOD rows copied
    from rows 0..k-1, and the vision tower from ``vision_path`` when set."""
    dev = resolve_device(device)
    tokenizer, labels_mapping = build_tokenizer(config)
    num_ood = sum(1 for v in (labels_mapping or {}).values() if v.startswith("<ood"))
    with torch.device(dev):
        model = MLLM(model_config(config, len(tokenizer), dtype))
    init_random_weights_(model, generator)
    copy_init_ood_rows(model, num_ood)
    if config.vision_path:
        load_vision_tower_(model, config.vision_path)
    return model, tokenizer, labels_mapping, num_ood


def _decode_is_yes(tokenizer, ids) -> bool:
    text = tokenizer.decode([int(i) for i in ids if int(i) >= 0], skip_special_tokens=True)
    return "yes" in text.strip().lower()


def evaluate_model(eval_step, model, loader, tokenizer, device):
    """Yes/no string-match accuracy + mean loss, printed as the JAX trainer
    does (under a process group: over every rank's stripes)."""
    losses, correct, total = [], 0, 0
    for batch in prefetch_to_device(loader, device):
        out = eval_step(model, batch)
        losses.append(float(out["loss"]))
        pred_ids, target_ids, valid = (out[k].cpu().numpy()
                                       for k in ("pred_ids", "target_ids", "valid"))
        for i in range(pred_ids.shape[0]):
            if not valid[i].any():
                continue
            correct += int(_decode_is_yes(tokenizer, pred_ids[i][valid[i]])
                           == _decode_is_yes(tokenizer, target_ids[i][valid[i]]))
            total += 1
    both = multihost.all_reduce_sum(torch.tensor([correct, total], device=device))
    correct, total = (int(v) for v in both.tolist())
    test_loss = float(np.mean(losses)) if losses else 0.0
    test_acc = 100.0 * correct / total if total > 0 else 0.0
    print("Test Results:")
    print(f"Test Loss: {test_loss:.4f}")
    print(f"Test Accuracy: {test_acc:.2f}%")
    return {"test_loss": test_loss, "test_acc": test_acc}


def run_training(model: MLLM, tokenizer, train_loader, val_loader, test_loader,
                 config: MultimodalTrainingConfig):
    """Train ``model`` (on its device) as the JAX ``run_training`` does;
    returns (final TrainState, test metrics of the best checkpoint, the
    metrics logged for each epoch); after SIGTERM (None,
    {"preempted": True}, the metrics so far)."""
    assert config.effective_batch_size % config.batch_size == 0, (
        f"effective_batch_size ({config.effective_batch_size}) must be divisible "
        f"by batch_size ({config.batch_size})"
    )
    device = next(model.parameters()).device
    is_main = multihost.is_main_process()
    accumulation_steps = config.effective_batch_size // config.batch_size
    if config.lr_scheduler_type == "linear":
        total_updates = max(1, (len(train_loader) * config.epochs) // accumulation_steps)
        schedule = linear_warmup_schedule(config.learning_rate, config.warmup_steps,
                                          total_updates)
    else:
        schedule = config.learning_rate
    if config.optimizer_type != "adamw":
        raise ValueError(f"Optimizer {config.optimizer_type} not supported.")

    trainable_mask(model, config.trainable_params_setting)
    print_trainable_summary(model, config.trainable_params_setting)
    if config.bf16_params:  # bf16 storage of every parameter, float32 masters in AdamW
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    optimizer = build_optimizer(model, schedule, weight_decay=config.weight_decay,
                                max_grad_norm=config.max_grad_norm,
                                accumulation_steps=accumulation_steps,
                                fp32_master=config.bf16_params)
    frozen = host_state_dict(model)  # the initial values every checkpoint keeps
    cast_for_compute(model, model.cfg.dtype, only_frozen=True)
    state = TrainState(model=model, optimizer=optimizer)
    train_step = make_mllm_train_step(model)
    eval_step = make_mllm_eval_step(model)

    models_dir = os.path.join(config.results_dir, "models")
    if is_main:
        os.makedirs(models_dir, exist_ok=True)
        save_state_dict(frozen, os.path.join(models_dir, "initial_model.pt"))
        tokenizer.save_pretrained(os.path.join(models_dir, "tokenizer"))

    logger = MetricsLogger(enabled=is_main, use_wandb=config.use_wandb,
                           wandb_project=config.wandb_project,
                           wandb_run_name=config.wandb_run_name or config.run_name,
                           wandb_config=vars(config))
    resume = ResumeManager(config.results_dir, config.resume)
    state, start_epoch, meta = resume.restore(state)
    guard = PreemptionGuard(enabled=config.resume)
    skip_batches = int(meta.get("skip_batches", 0) or 0)
    best_loss = float(meta.get("best_loss", float("inf")))
    history = []
    for epoch in range(start_epoch, config.epochs):
        epoch_start = time.time()
        train_loader.set_epoch(epoch)
        losses = []  # 0-d device tensors: one host sync per epoch
        done_in_epoch = skip_batches if epoch == start_epoch else 0
        for batch in prefetch_to_device(epoch_batches(train_loader, done_in_epoch), device):
            state, m = train_step(state, batch)
            done_in_epoch += 1
            losses.append(m["loss"])
            if guard.agreed():
                resume.save_preempted(state, epoch, done_in_epoch, {"best_loss": best_loss})
                logger.finish()
                guard.close()
                return None, {"preempted": True}, history
        train_loss = epoch_metric_mean(losses)
        train_time = time.time() - epoch_start
        val_losses = [eval_step(model, b)["loss"] for b in prefetch_to_device(val_loader, device)]
        val_loss = epoch_metric_mean(val_losses)
        epoch_time = time.time() - epoch_start
        current_lr = optimizer.lr(state.step // accumulation_steps)

        is_best = val_loss < best_loss
        if is_best:
            best_loss = val_loss
        if (is_best or config.save_every_epoch) and is_main:
            sd = host_state_dict(model, frozen)
            if is_best:
                save_state_dict(sd, os.path.join(models_dir, "best_model.pt"))
                with open(os.path.join(models_dir, "training_config.json"), "w") as f:
                    json.dump(vars(config), f, indent=2)
            if config.save_every_epoch:
                save_state_dict(sd, os.path.join(models_dir, f"epoch_{epoch}_model.pt"))
        metrics = {"epoch": epoch + 1, "train_loss": train_loss, "val_loss": val_loss,
                   "best_val_loss": best_loss, "learning_rate": current_lr,
                   "epoch_time": epoch_time, "train_time": train_time,
                   "micro_steps": len(losses)}
        logger.print_multimodal_epoch(metrics, config.epochs)
        logger.log(metrics)
        history.append(metrics)
        resume.save(state, epoch, {"best_loss": best_loss})
    resume.finalize()
    guard.close()

    print(f"Best val loss: {best_loss:.4f}")
    print("\n" + "=" * 50)
    print("FINAL EVALUATION ON VALIDATION SET")
    print("=" * 50)
    best_path = os.path.join(models_dir, "best_model.pt")
    multihost.barrier()  # rank 0's best_model.pt is on disk
    eval_model = model
    if os.path.exists(best_path):
        eval_model = copy.deepcopy(model)  # the returned state keeps the final weights
        eval_model.load_state_dict(mllm_state_dict_from_torch(load_state_dict(best_path)),
                                   strict=True)
        print(f"Loaded best model from {best_path}")
    else:
        print("Best model not found, using final model")
    test_metrics = evaluate_model(eval_step, eval_model, test_loader, tokenizer, device)
    print("\nFinal Test Results:")
    print(f"Test Loss: {test_metrics['test_loss']:.4f}")
    print(f"Test Accuracy: {test_metrics['test_acc']:.4f}")
    logger.finish()
    return state, test_metrics, history


def main(argv=None):
    """The CLI; returns what ``run_training`` returns, or
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

    with open(args.config_path, "r") as f:
        config = MultimodalTrainingConfig.from_params(miniyaml.safe_load(f))
    random.seed(config.seed)
    np.random.seed(config.seed)
    generator = torch.Generator(device=device).manual_seed(config.seed)

    train_transform = create_transforms(config, is_train=True, seed=config.seed)
    val_transform = create_transforms(config, is_train=False, seed=config.seed)
    if config.dataset_name == "color_multimodal":
        dataset_cls = ColorDataset
    elif config.dataset_name == "imagenet_multimodal":
        dataset_cls = ImageNetDataset
    else:
        raise ValueError(f"Dataset {config.dataset_name} not supported.")
    train_dataset, val_dataset, test_dataset = load_split_datasets(
        dataset_cls, mapping_dir=os.path.dirname(config.mapping_path),
        data_dir=config.image_root, train_transform=train_transform,
        val_transform=val_transform, return_synset=True)
    print(f"Loaded multimodal dataset with {len(train_dataset)} train samples, "
          f"{len(val_dataset)} validation samples, and {len(test_dataset)} test samples.")
    if multihost.is_main_process():
        os.makedirs(os.path.join(config.results_dir, "models"), exist_ok=True)

    model, tokenizer, labels_mapping, _ = init_model_and_tokenizer(config, generator, device)
    collator = MultimodalCollator(tokenizer=tokenizer, num_vision_tokens=config.num_vision_tokens,
                                  prompt_template=config.prompt_template,
                                  all_class_names=train_dataset.unique_labels,
                                  labels_mapping=labels_mapping, seed=config.seed)
    local_bs, pshard = process_local_loader_args(config.batch_size)
    loader_kwargs = dict(collate_fn=collator, num_workers=config.num_workers,
                         prefetch_batches=config.prefetch_factor,
                         uint8_images=config.device_normalize, process_shard=pshard)
    train_loader = BatchLoader(train_dataset, batch_size=local_bs, shuffle=True,
                               drop_last=True, seed=config.seed, **loader_kwargs)
    val_loader = BatchLoader(val_dataset, batch_size=local_bs, **loader_kwargs)
    test_loader = BatchLoader(test_dataset, batch_size=local_bs, **loader_kwargs)
    out = run_training(model, tokenizer, train_loader, val_loader, test_loader, config)
    return out[1] if out[0] is None else out  # {"preempted": True} after SIGTERM


if __name__ == "__main__":
    main()
