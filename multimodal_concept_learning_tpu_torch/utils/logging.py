"""Metric logging in the reference's stdout format (a copy of
multimodal_concept_learning_tpu/utils/logging.py).

Prints the vision and MLLM trainers' per-epoch metric blocks and mirrors
them to wandb when it is installed and asked for; without wandb the flags
are accepted and the metrics are only printed.
"""

from __future__ import annotations

from typing import Optional

try:  # pragma: no cover - wandb is not installed where the port runs
    import wandb as _wandb
except Exception:  # noqa: BLE001
    _wandb = None


class MetricsLogger:
    """Prints reference-format epoch metrics and forwards to wandb when available."""

    def __init__(self, enabled: bool, use_wandb: bool, wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None, wandb_config: Optional[dict] = None):
        self.enabled = enabled
        self.use_wandb = bool(use_wandb) and _wandb is not None and enabled
        if use_wandb and _wandb is None and enabled:
            print("wandb requested but not installed; metrics will only be printed")
        if self.use_wandb:
            _wandb.init(project=wandb_project, name=wandb_run_name, config=wandb_config)

    def log(self, metrics: dict):
        if self.use_wandb:
            _wandb.log(metrics)

    def print_vision_epoch(self, metrics: dict, total_epochs: int):
        if not self.enabled:
            return
        print(f"Epoch {metrics['epoch']}/{total_epochs} completed in {metrics['epoch_time']:.2f}s")
        print(f"Train Loss: {metrics['train_loss']:.4f}, Train Acc: {metrics['train_acc']:.2f}%")
        print(f"Val Loss: {metrics['val_loss']:.4f}, Val Acc: {metrics['val_acc']:.2f}%")
        print(f"Learning Rate: {metrics['learning_rate']:.6f}")
        print("-" * 50)

    def print_multimodal_epoch(self, metrics: dict, total_epochs: int):
        if not self.enabled:
            return
        print(f"Epoch {metrics['epoch']}/{total_epochs} completed in {metrics['epoch_time']:.2f}s")
        print(f"Train Loss: {metrics['train_loss']:.4f}")
        print(f"Val Loss: {metrics['val_loss']:.4f}")
        print(f"Best Val Loss: {metrics['best_val_loss']:.4f}")
        print(f"Learning Rate: {metrics['learning_rate']:.6f}")
        print("-" * 50)

    def finish(self):
        if self.use_wandb:
            _wandb.finish()


__all__ = ["MetricsLogger"]
