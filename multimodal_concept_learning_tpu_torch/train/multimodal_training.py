"""Multimodal MLLM training CLI (counterpart of
multimodal_concept_learning_tpu/train/multimodal_training.py).

    python -m multimodal_concept_learning_tpu_torch.train.multimodal_training \\
        --config_path experiments/multimodal/color/12_colors_3k.yaml --device cuda

The same YAML schema, log lines and results layout as the JAX trainer:
``models/{initial_model.pt, tokenizer/, best_model.pt, training_config.json,
epoch_{e}_model.pt}`` with float32 leaves, the shifted yes/no test accuracy,
the tokenizer extended with the ``<ood N>`` tokens whose embedding rows are
copied from rows 0..k-1.  Weights start from a seeded random init (the
JAX initialisers; no pretrained download).  Compute is bf16 over float32
trained parameters; frozen linear weights are stored in bf16 once.

Not ported yet (raise ``NotImplementedError``; ROADMAP.md): ``resume`` with
its preemption guard, the ``vision_path`` warm start, MoE and LoRA, and
ImageNet (JPEG) data.
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

from multimodal_concept_learning_tpu.configs import MultimodalTrainingConfig
from multimodal_concept_learning_tpu.utils.logging import MetricsLogger
from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.checkpoint import (
    host_state_dict,
    init_random_weights_,
    load_state_dict,
    save_state_dict,
)
from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
from multimodal_concept_learning_tpu_torch.data.datasets import (
    ColorDataset,
    ImageNetDataset,
    load_split_datasets,
)
from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
from multimodal_concept_learning_tpu_torch.device import cast_for_compute, resolve_device
from multimodal_concept_learning_tpu_torch.models.mllm import (
    MLLM,
    copy_init_ood_rows,
    print_trainable_summary,
    trainable_mask,
)
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


def _refuse_unported(config: MultimodalTrainingConfig) -> None:
    for field, what in (("resume", "resume / preemption checkpoints"),
                        ("vision_path", "the vision_path warm start"),
                        ("lm_moe_experts", "MoE"), ("lm_lora_rank", "LoRA")):
        if getattr(config, field, None):
            raise NotImplementedError(f"{what} ({field}) is not ported yet (ROADMAP.md, queue A)")


def init_model_and_tokenizer(config: MultimodalTrainingConfig, generator: torch.Generator,
                             device, dtype: torch.dtype = torch.bfloat16):
    """(model, tokenizer, labels_mapping, number of OOD tokens): the
    tokenizer plus the mapping's ``<ood ...>`` tokens, the MLLM with float32
    parameters on ``device`` from a seeded random init, and the OOD rows
    copied from rows 0..k-1."""
    _refuse_unported(config)
    dev = resolve_device(device)
    tokenizer, labels_mapping = build_tokenizer(config)
    num_ood = sum(1 for v in (labels_mapping or {}).values() if v.startswith("<ood"))
    with torch.device(dev):
        model = MLLM(model_config(config, len(tokenizer), dtype))
    init_random_weights_(model, generator)
    copy_init_ood_rows(model, num_ood)
    return model, tokenizer, labels_mapping, num_ood


def _decode_is_yes(tokenizer, ids) -> bool:
    text = tokenizer.decode([int(i) for i in ids if int(i) >= 0], skip_special_tokens=True)
    return "yes" in text.strip().lower()


def evaluate_model(eval_step, model, loader, tokenizer, device):
    """Yes/no string-match accuracy + mean loss, printed as the JAX trainer does."""
    losses, correct, total = [], 0, 0
    for batch in loader:
        out = eval_step(model, to_device(batch, device))
        losses.append(float(out["loss"]))
        pred_ids, target_ids, valid = (out[k].cpu().numpy()
                                       for k in ("pred_ids", "target_ids", "valid"))
        for i in range(pred_ids.shape[0]):
            if not valid[i].any():
                continue
            correct += int(_decode_is_yes(tokenizer, pred_ids[i][valid[i]])
                           == _decode_is_yes(tokenizer, target_ids[i][valid[i]]))
            total += 1
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
    metrics logged for each epoch)."""
    assert config.effective_batch_size % config.batch_size == 0, (
        f"effective_batch_size ({config.effective_batch_size}) must be divisible "
        f"by batch_size ({config.batch_size})"
    )
    _refuse_unported(config)
    device = next(model.parameters()).device
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
    os.makedirs(models_dir, exist_ok=True)
    save_state_dict(frozen, os.path.join(models_dir, "initial_model.pt"))
    tokenizer.save_pretrained(os.path.join(models_dir, "tokenizer"))

    logger = MetricsLogger(enabled=True, use_wandb=config.use_wandb,
                           wandb_project=config.wandb_project,
                           wandb_run_name=config.wandb_run_name or config.run_name,
                           wandb_config=vars(config))
    best_loss = float("inf")
    history = []
    for epoch in range(config.epochs):
        epoch_start = time.time()
        train_loader.set_epoch(epoch)
        losses = []  # 0-d device tensors: one host sync per epoch
        for batch in train_loader:
            state, m = train_step(state, to_device(batch, device))
            losses.append(m["loss"])
        train_loss = float(torch.stack(losses).mean()) if losses else 0.0
        train_time = time.time() - epoch_start
        val_losses = [eval_step(model, to_device(b, device))["loss"] for b in val_loader]
        val_loss = float(torch.stack(val_losses).mean()) if val_losses else 0.0
        epoch_time = time.time() - epoch_start
        current_lr = optimizer.lr(state.step // accumulation_steps)

        is_best = val_loss < best_loss
        if is_best:
            best_loss = val_loss
        if is_best or config.save_every_epoch:
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

    print(f"Best val loss: {best_loss:.4f}")
    print("\n" + "=" * 50)
    print("FINAL EVALUATION ON VALIDATION SET")
    print("=" * 50)
    best_path = os.path.join(models_dir, "best_model.pt")
    eval_model = model
    if os.path.exists(best_path):
        eval_model = copy.deepcopy(model)  # the returned state keeps the final weights
        eval_model.load_state_dict(load_state_dict(best_path), strict=True)
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
    """The CLI; returns what ``run_training`` returns."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
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
    os.makedirs(os.path.join(config.results_dir, "models"), exist_ok=True)

    model, tokenizer, labels_mapping, _ = init_model_and_tokenizer(config, generator, device)
    collator = MultimodalCollator(tokenizer=tokenizer, num_vision_tokens=config.num_vision_tokens,
                                  prompt_template=config.prompt_template,
                                  all_class_names=train_dataset.unique_labels,
                                  labels_mapping=labels_mapping, seed=config.seed)
    loader_kwargs = dict(collate_fn=collator, num_workers=config.num_workers,
                         prefetch_batches=config.prefetch_factor,
                         uint8_images=config.device_normalize)
    train_loader = BatchLoader(train_dataset, batch_size=config.batch_size, shuffle=True,
                               drop_last=True, seed=config.seed, **loader_kwargs)
    val_loader = BatchLoader(val_dataset, batch_size=config.batch_size, **loader_kwargs)
    test_loader = BatchLoader(test_dataset, batch_size=config.batch_size, **loader_kwargs)
    return run_training(model, tokenizer, train_loader, val_loader, test_loader, config)


if __name__ == "__main__":
    main()
