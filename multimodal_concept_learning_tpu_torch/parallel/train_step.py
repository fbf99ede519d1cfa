"""MLLM train and eval steps (counterpart of
multimodal_concept_learning_tpu/parallel/train_step.py:128-210).

Plain functions over a small state: the micro-step counter, the model and
its optimizer.  A train step is one micro-step: forward with the sparse
answer loss, backward, and ``Optimizer.step`` (which updates the parameters
every k-th micro-step).  The eval step returns the JAX step's
{loss, pred_ids, target_ids, valid} for the host's yes/no accuracy.  Batches
are dicts of tensors already on the model's device.  The MLLM has no
dropout, so the steps take no random generator.  A batch's ``kv_lens``
(set by ``data.pipeline.to_device`` for a right-padded mask) goes to the
model as the mask's descriptor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
from multimodal_concept_learning_tpu_torch.ops.losses import IGNORE_INDEX, shift_labels
from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch
from multimodal_concept_learning_tpu_torch.parallel.optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    model: MLLM
    optimizer: Optimizer
    step: int = 0  # micro-steps taken


def make_mllm_train_step(model: MLLM) -> Callable:
    """(state, batch) -> (state, {"loss"}) for ``state.model is model``; the
    loss is a 0-d tensor left on the device (the epoch loop syncs once per
    epoch)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        out = model(images_from_batch(batch), batch["input_ids"], batch["attention_mask"],
                    batch["labels"], kv_lens=batch.get("kv_lens"))
        out["loss"].backward()
        state.optimizer.step()
        state.step += 1
        return state, {"loss": out["loss"].detach()}

    return step


def make_mllm_eval_step(model: MLLM) -> Callable:
    """(model, batch) -> {loss, pred_ids [B, A], target_ids [B, A] (-100
    where not valid), valid [B, A]}, under ``torch.no_grad()``."""

    @torch.no_grad()
    def step(model: MLLM, batch: Dict[str, torch.Tensor]):
        model.eval()
        out = model(images_from_batch(batch), batch["input_ids"], batch["attention_mask"],
                    batch["labels"], row_valid=batch["valid"], kv_lens=batch.get("kv_lens"))
        target = torch.gather(shift_labels(batch["labels"]), 1, out["positions"])
        return {"loss": out["loss"],
                "pred_ids": torch.argmax(out["logits"], dim=-1),
                "target_ids": torch.where(out["valid"], target, IGNORE_INDEX),
                "valid": out["valid"]}

    return step


__all__ = ["TrainState", "make_mllm_eval_step", "make_mllm_train_step"]
