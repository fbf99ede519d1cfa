"""Vision classifier training CLI (counterpart of
multimodal_concept_learning_tpu/train/vision_training.py).

    python -m multimodal_concept_learning_tpu_torch.train.vision_training \\
        --config_path experiments/vision/color/12_colors_3k.yaml --device cuda

The JAX trainer's YAML schema, log lines and results: color datasets with
``num_labels`` taken from the data, effective-batch gradient accumulation
(with the same assertion), AdamW with the per-epoch cosine schedule to 1%
of the learning rate, clipping at 1.0, label smoothing, the best-by-val-loss
``models/best_model.pt`` and ``models/final_model.pt`` (float32 tensors
named ``vit.*`` / ``classifier.*``, which the JAX package loads), and the
final test evaluation ("Test Results:").  Weights start from a seeded
random init (the JAX initialisers); dropout draws from one
``torch.Generator`` on the model's device, seeded from ``seed``.  Compute is
bf16 over float32 parameters (``bf16_params``: bf16 storage with float32
masters).  Metrics stay on the device until the end of each pass, one host
sync a pass.  On the card every deterministic forward (validation, test)
runs K1; a training forward with dropout runs the dense dropout branch
(``ops/attention.py``), and one without dropout K1 and its backward.
``resume: true`` saves the training state, dropout generator included, at
each epoch's end and restores the newest on start; SIGTERM saves a
mid-epoch checkpoint and ``main`` returns ``{"preempted": True}``
(``train/common.py``).  ``dataset_name: imagenet100`` reads the ImageNet
mapping CSVs of ``mapping_path`` over the JPEGs of ``data_dir``
(``data/datasets.ImageNetDataset``).  Under ``torchrun`` it trains data
parallel, as the MLLM trainer does (rank 0 logs and writes; each rank's
dropout draws from its own generator, seeded ``seed + 1 + rank * 2**32``,
so rank 0 draws the single process's masks).
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
from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
from multimodal_concept_learning_tpu_torch.data.datasets import (
    ColorDataset,
    ImageNetDataset,
    load_split_datasets,
)
from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
from multimodal_concept_learning_tpu_torch.device import resolve_device
from multimodal_concept_learning_tpu_torch.models.vit import ViTConfig, ViTForImageClassification
from multimodal_concept_learning_tpu_torch.parallel import multihost
from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
    build_optimizer,
    cosine_epoch_schedule,
)
from multimodal_concept_learning_tpu_torch.parallel.train_step import (
    TrainState,
    make_classifier_eval_step,
    make_classifier_train_step,
)
from multimodal_concept_learning_tpu_torch.train.common import (
    PreemptionGuard,
    ResumeManager,
    epoch_batches,
    process_local_loader_args,
)
from multimodal_concept_learning_tpu_torch.utils.logging import MetricsLogger


def init_model(config: VisionTrainingConfig, generator: torch.Generator,
               device) -> ViTForImageClassification:
    """The ViT classifier of the config's knobs on ``device``, float32
    parameters from a seeded random init."""
    if config.model_name != "vit":
        raise ValueError(f"Model {config.model_name} not supported.")
    with torch.device(resolve_device(device)):
        model = ViTForImageClassification(ViTConfig.from_training_config(config))
    return init_random_weights_(model, generator)


def _totals(metrics: list) -> tuple:
    """(mean loss, accuracy %) of a pass's per-batch metrics: one host sync."""
    if not metrics:
        return 0.0, 0.0
    loss = float(torch.stack([m["loss"] for m in metrics]).mean())
    correct = float(torch.stack([m["correct"] for m in metrics]).sum())
    count = float(sum(m["count"] for m in metrics))
    return loss, 100.0 * correct / max(count, 1.0)


def _evaluate(eval_step, model, loader, device) -> tuple:
    return _totals([eval_step(model, to_device(batch, device)) for batch in loader])


def run_training(model: ViTForImageClassification, train_loader, val_loader,
                 config: VisionTrainingConfig, generator: torch.Generator):
    """Train ``model`` (on its device) as the JAX ``run_training`` does;
    returns (final TrainState, the metrics of each epoch); the state is
    None when SIGTERM preempted the run."""
    assert config.effective_batch_size % config.batch_size == 0, (
        f"effective_batch_size ({config.effective_batch_size}) must be divisible "
        f"by batch_size ({config.batch_size})"
    )
    device = next(model.parameters()).device
    is_main = multihost.is_main_process()
    accumulation_steps = config.effective_batch_size // config.batch_size
    updates_per_epoch = max(1, len(train_loader) // accumulation_steps)
    schedule = cosine_epoch_schedule(config.learning_rate, config.epochs, updates_per_epoch)
    if config.bf16_params:  # bf16 storage of every parameter, float32 masters in AdamW
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    optimizer = build_optimizer(model, schedule, weight_decay=config.weight_decay,
                                max_grad_norm=1.0,  # fixed in the reference
                                accumulation_steps=accumulation_steps,
                                fp32_master=config.bf16_params)
    state = TrainState(model=model, optimizer=optimizer, generator=generator)
    resume = ResumeManager(config.results_dir, config.resume)
    state, start_epoch, meta = resume.restore(state)
    guard = PreemptionGuard(enabled=config.resume)
    skip_batches = int(meta.get("skip_batches", 0) or 0)
    train_step = make_classifier_train_step(model, generator, config.label_smoothing)
    eval_step = make_classifier_eval_step(model, config.label_smoothing)

    logger = MetricsLogger(enabled=is_main, use_wandb=not config.disable_wandb,
                           wandb_project=config.wandb_project,
                           wandb_run_name=config.wandb_run_name, wandb_config=vars(config))
    models_dir = os.path.join(config.results_dir, "models")
    if is_main:
        os.makedirs(models_dir, exist_ok=True)
    best_loss = float(meta.get("best_loss", float("inf")))
    history = []
    for epoch in range(start_epoch, config.epochs):
        epoch_start = time.time()
        train_loader.set_epoch(epoch)
        steps = []
        done_in_epoch = skip_batches if epoch == start_epoch else 0
        for batch in epoch_batches(train_loader, done_in_epoch):
            state, m = train_step(state, to_device(batch, device))
            done_in_epoch += 1
            steps.append(m)
            if guard.agreed():
                resume.save_preempted(state, epoch, done_in_epoch, {"best_loss": best_loss})
                logger.finish()
                guard.close()
                return None, history
        train_loss, train_acc = _totals(steps)
        train_time = time.time() - epoch_start
        val_loss, val_acc = _evaluate(eval_step, model, val_loader, device)
        epoch_time = time.time() - epoch_start
        current_lr = float(schedule(min(epoch, config.epochs) * updates_per_epoch))
        if val_loss < best_loss:
            best_loss = val_loss
            if is_main:
                save_state_dict(host_state_dict(model), os.path.join(models_dir, "best_model.pt"))
        metrics = {"epoch": epoch + 1, "train_loss": train_loss, "val_loss": val_loss,
                   "train_acc": train_acc, "val_acc": val_acc, "learning_rate": current_lr,
                   "epoch_time": epoch_time, "train_time": train_time,
                   "micro_steps": len(steps)}
        logger.print_vision_epoch(metrics, config.epochs)
        logger.log(metrics)
        history.append(metrics)
        resume.save(state, epoch, {"best_loss": best_loss})
    resume.finalize()
    guard.close()

    print(f"Best val loss: {best_loss:.4f}")
    if is_main:
        save_state_dict(host_state_dict(model), os.path.join(models_dir, "final_model.pt"))
    logger.finish()
    return state, history


def evaluate_model(model, test_loader, config: VisionTrainingConfig) -> dict:
    """Test-set evaluation, printed in the reference's format."""
    device = next(model.parameters()).device
    eval_step = make_classifier_eval_step(model, config.label_smoothing)
    test_loss, test_acc = _evaluate(eval_step, model, test_loader, device)
    print("Test Results:")
    print(f"Test Loss: {test_loss:.4f}")
    print(f"Test Accuracy: {test_acc:.2f}%")
    return {"test_loss": test_loss, "test_acc": test_acc}


def main(argv=None):
    """The CLI; returns the test metrics with the per-epoch ``history`` and
    the final ``state``, or ``{"preempted": True}`` after SIGTERM."""
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
        config = VisionTrainingConfig.from_params(miniyaml.safe_load(f))
    random.seed(config.seed)
    np.random.seed(config.seed)
    init_generator = torch.Generator(device=device).manual_seed(config.seed)
    # the dropout stream: a second generator (the JAX step key is fold_in(rng, 1)),
    # one a rank under a process group, seeded from (seed + 1, rank); rank 0
    # draws the single process's stream
    dropout_seed = config.seed + 1 + (multihost.rank() << 32)
    dropout_generator = torch.Generator(device=device).manual_seed(dropout_seed)

    train_transform = create_transforms(config, is_train=True, seed=config.seed)
    val_transform = create_transforms(config, is_train=False, seed=config.seed)
    if config.dataset_name == "color":
        dataset_cls = ColorDataset
    elif config.dataset_name == "imagenet100":
        dataset_cls = ImageNetDataset
    else:
        raise ValueError(f"Dataset {config.dataset_name} not supported.")
    train_dataset, val_dataset, test_dataset = load_split_datasets(
        dataset_cls, mapping_dir=config.mapping_path, data_dir=config.data_dir,
        train_transform=train_transform, val_transform=val_transform)
    config.num_labels = train_dataset.num_classes

    local_bs, pshard = process_local_loader_args(config.batch_size)
    loader_kwargs = dict(batch_size=local_bs, num_workers=config.num_workers,
                         prefetch_batches=config.prefetch_factor,
                         uint8_images=config.device_normalize, process_shard=pshard)
    train_loader = BatchLoader(train_dataset, shuffle=True, drop_last=True, seed=config.seed,
                               **loader_kwargs)
    val_loader = BatchLoader(val_dataset, **loader_kwargs)
    test_loader = BatchLoader(test_dataset, **loader_kwargs)
    print(f"Loaded {config.dataset_name} dataset with {len(train_dataset)} train samples, "
          f"{len(val_dataset)} validation samples, and {len(test_dataset)} test samples.")

    if multihost.is_main_process():
        os.makedirs(config.results_dir, exist_ok=True)
    model = init_model(config, init_generator, device)
    state, history = run_training(model, train_loader, val_loader, config, dropout_generator)
    if state is None:  # graceful preemption: resume later with resume: true
        return {"preempted": True}

    print("\n" + "=" * 50)
    print("FINAL EVALUATION ON TEST SET")
    print("=" * 50)
    test_metrics = evaluate_model(model, test_loader, config)
    return dict(test_metrics, history=history, state=state)


if __name__ == "__main__":
    main()
