"""Vision classifier, MLLM and CLIP train and eval steps (counterparts of
multimodal_concept_learning_tpu/parallel/train_step.py:63-210 and of
``make_clip_train_step`` / ``make_zero_shot_step`` in
multimodal_concept_learning_tpu/train/contrastive_training.py:54-79).

Plain functions over a small state: the micro-step counter, the model and
its optimizer.  A train step is one micro-step: forward with the loss,
backward, and ``Optimizer.step`` (which updates the parameters every k-th
micro-step).  The classifier's train step is its one forward with dropout:
it draws the masks from the ``torch.Generator`` it was made with (the JAX
step folds the step count into a key; the streams differ, the
distributions do not).  The MLLM and CLIP have no dropout, so their steps
take no generator.  The MLLM eval step returns the JAX step's
{loss, pred_ids, target_ids, valid} for the host's yes/no accuracy.
Batches are dicts of tensors already on the model's device.  Metrics stay
on the device (0-d tensors) until the caller syncs once an epoch.  A
batch's ``kv_lens`` (set by ``data.pipeline.to_device`` for a right-padded
mask) goes to the model as the mask's descriptor.
Each step is a root ``step`` span (``utils/profiling.py``; its id the
micro-step count, or in evaluation the step function's call count) holding
``forward`` (the model and the loss; in evaluation also the argmax),
``backward`` and the optimizer's spans.

Under MoE the MLLM step adds ``MOE_AUX_COEF`` x the mean of the layers'
Switch aux to the loss (JAX ``parallel/train_step.py:126-175``).  Every
step takes this rank's stripe of the global batch and returns the global
batch's metrics (``parallel/multihost.py``; in a single process the
stripe is the batch and each collective the identity): every per-rank
loss is built so that the ranks' gradients, summed by
``Optimizer.step``, are the gradient of JAX's loss over the global batch
(the MLLM's answer CE is its stripe's sum over the global count of answer
positions, the MoE aux the product of the global batch's routing means,
the classifier's mean a 1/world share, and CLIP's InfoNCE runs over the
gathered [B, B] logits).  On a model sharded by
``parallel/sharding_rules.shard_params`` the steps run unchanged: the
ranks of one data stripe (the model axis) compute the same loss, and
these collectives run over the model's data axes
(``multihost.data_group``) in place of the world.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.models.clip import CLIPModel, contrastive_loss
from multimodal_concept_learning_tpu_torch.models.mllm import MLLM
from multimodal_concept_learning_tpu_torch.models.vit import ViTForImageClassification
from multimodal_concept_learning_tpu_torch.ops.losses import (
    IGNORE_INDEX,
    answer_count,
    cross_entropy_loss,
    shift_labels,
)
from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux
from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch
from multimodal_concept_learning_tpu_torch.parallel.multihost import (
    all_reduce_sum,
    data_group,
    gather_rows,
    global_routing_sums,
    group_size,
)
from multimodal_concept_learning_tpu_torch.parallel.optimizer import Optimizer
from multimodal_concept_learning_tpu_torch.utils.profiling import span

MOE_AUX_COEF = 0.01  # Switch-convention load-balance coefficient


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0  # micro-steps taken
    # the classifier's dropout stream, when it has one: a resumed run draws on from it
    generator: Optional[torch.Generator] = None


def make_classifier_train_step(model: ViTForImageClassification,
                               generator: Optional[torch.Generator] = None,
                               label_smoothing: float = 0.0) -> Callable:
    """(state, batch) -> (state, {"loss", "correct", "count"}): the
    classifier's forward with dropout from ``generator``, the label-smoothed
    cross entropy, backward and ``Optimizer.step``.  ``count`` is the batch
    size; all three are the global batch's (equal stripes, no padding: the
    mean is the mean of the ranks' means)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("step", state.step):
            model.train()
            labels = batch["labels"]
            with span("forward"):
                logits = model(images_from_batch(batch), deterministic=False,
                               generator=generator)
                loss = cross_entropy_loss(logits, labels, label_smoothing)
            correct = (torch.argmax(logits.detach(), dim=-1) == labels).sum()
            dp = data_group(model)
            loss = loss / group_size(dp)
            with span("backward"):
                loss.backward()
            state.optimizer.step()
            state.step += 1
            return state, {"loss": all_reduce_sum(loss.detach(), dp),
                           "correct": all_reduce_sum(correct, dp),
                           "count": labels.shape[0] * group_size(dp)}

    return step


def make_classifier_eval_step(model: ViTForImageClassification,
                              label_smoothing: float = 0.0) -> Callable:
    """(model, batch) -> {"loss", "correct", "count"} over the global
    batch's ``valid`` rows (a padded final batch counts its real samples
    only), deterministic, under ``torch.no_grad()``."""

    calls = itertools.count()

    @torch.no_grad()
    def step(model: ViTForImageClassification, batch: Dict[str, torch.Tensor]):
        with span("step", next(calls)):
            model.eval()
            labels, valid = batch["labels"], batch["valid"]
            dp = data_group(model)
            with span("forward"):
                logits = model(images_from_batch(batch))
                correct = ((torch.argmax(logits, dim=-1) == labels) & valid).sum()
                count = all_reduce_sum(valid.sum(), dp)
                loss = cross_entropy_loss(logits, labels, label_smoothing, valid=valid,
                                          count=count.float())
            return {"loss": all_reduce_sum(loss, dp), "correct": all_reduce_sum(correct, dp),
                    "count": count}

    return step


def make_mllm_train_step(model: MLLM) -> Callable:
    """(state, batch) -> (state, {"loss"}) for ``state.model is model``; the
    loss is the global batch's (see the module docstring), a 0-d tensor
    left on the device (the epoch loop syncs once per epoch).  Under MoE it
    includes ``MOE_AUX_COEF`` x the mean layer aux."""
    moe_on = model.cfg.lm.moe_experts > 0

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("step", state.step):
            model.train()
            dp = data_group(model)
            # the global batch's answer positions; a rank may hold none
            count = all_reduce_sum(answer_count(batch["labels"], model.cfg.max_answer_tokens),
                                   dp)
            record = (MoEAux(reduce=lambda f, p, n: global_routing_sums(f, p, n, dp))
                      if moe_on else None)
            with span("forward"):
                out = model(images_from_batch(batch), batch["input_ids"],
                            batch["attention_mask"], batch["labels"],
                            kv_lens=batch.get("kv_lens"), moe_aux=record, loss_count=count)
                loss = out["loss"]
                reported = all_reduce_sum(loss.detach(), dp)
                if moe_on and record.aux:
                    # the same global value on every rank (see multihost.sum_over_ranks)
                    aux_term = MOE_AUX_COEF * sum(record.aux) / len(record.aux)
                    loss = loss + aux_term
                    reported = reported + aux_term.detach()
            with span("backward"):
                loss.backward()
            state.optimizer.step()
            state.step += 1
            return state, {"loss": reported}

    return step


def make_mllm_eval_step(model: MLLM) -> Callable:
    """(model, batch) -> {loss, pred_ids [B, A], target_ids [B, A] (-100
    where not valid), valid [B, A]}, under ``torch.no_grad()``: the loss is
    the global batch's, the rest this rank's."""

    calls = itertools.count()

    @torch.no_grad()
    def step(model: MLLM, batch: Dict[str, torch.Tensor]):
        with span("step", next(calls)):
            model.eval()
            dp = data_group(model)
            count = all_reduce_sum(answer_count(batch["labels"], model.cfg.max_answer_tokens,
                                                batch["valid"]), dp)
            with span("forward"):
                out = model(images_from_batch(batch), batch["input_ids"],
                            batch["attention_mask"], batch["labels"], row_valid=batch["valid"],
                            kv_lens=batch.get("kv_lens"), loss_count=count)
                pred_ids = torch.argmax(out["logits"], dim=-1)
            target = torch.gather(shift_labels(batch["labels"]), 1, out["positions"])
            return {"loss": all_reduce_sum(out["loss"], dp), "pred_ids": pred_ids,
                    "target_ids": torch.where(out["valid"], target, IGNORE_INDEX),
                    "valid": out["valid"]}

    return step


def make_clip_train_step(model: CLIPModel) -> Callable:
    """(state, batch) -> (state, {"loss"}): the symmetric InfoNCE of the
    global batch of (images, input_ids, attention_mask), over the ranks'
    features gathered with their gradient, backward and
    ``Optimizer.step``; the loss stays on the device."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("step", state.step):
            model.train()
            dp = data_group(model)
            with span("forward"):
                img, txt, scale = model(images_from_batch(batch), batch["input_ids"],
                                        batch["attention_mask"])
                loss = contrastive_loss(gather_rows(img, dp), gather_rows(txt, dp), scale)
            with span("backward"):
                (loss / group_size(dp)).backward()
            state.optimizer.step()
            state.step += 1
            return state, {"loss": loss.detach()}

    return step


def make_zero_shot_step(model: CLIPModel) -> Callable:
    """(model, batch, class_features [C, E]) -> (correct, valid count) over
    the global batch as 0-d tensors: each valid image takes the class whose
    caption feature is nearest, under ``torch.no_grad()``."""

    calls = itertools.count()

    @torch.no_grad()
    def step(model: CLIPModel, batch: Dict[str, torch.Tensor], class_features: torch.Tensor):
        with span("step", next(calls)):
            model.eval()
            with span("forward"):
                img = model.encode_image(images_from_batch(batch))
                preds = torch.argmax(img @ class_features.T, dim=-1)
            valid, dp = batch["valid"], data_group(model)
            return (all_reduce_sum(((preds == batch["labels"]) & valid).sum(), dp),
                    all_reduce_sum(valid.sum(), dp))

    return step


__all__ = ["MOE_AUX_COEF", "TrainState", "make_classifier_eval_step", "make_classifier_train_step",
           "make_clip_train_step", "make_mllm_eval_step", "make_mllm_train_step",
           "make_zero_shot_step"]
