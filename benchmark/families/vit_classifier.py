"""The ViT image classifier of the vision CLI: the program's side (the
CLI's ``init_model``, ``build_optimizer`` over its per-epoch cosine
schedule, ``make_classifier_train_step`` / ``make_classifier_eval_step``)
and the plain reference's side, on the same seeded weights and batches.

Batches: {"images" float32 NCHW, "labels" int32, "valid" bool (eval)},
as the CLI's loader and ``to_device`` hand them to the step.  Dropout
draws from a ``torch.Generator`` on the device seeded from the run's seed;
the reference draws the same masks from its own generator of that seed.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.inputs import image_pool, make_weights
from benchmark.reference import layout, models
from benchmark.reference.adamw import AdamW, cosine_per_epoch
from benchmark.reference.numerics import Numerics


def sizes(cfg: dict) -> dict:
    return dict(cfg, num_labels=len(cfg["data"]["colors"]))


def spec(cfg: dict):
    return layout.vit_classifier(sizes(cfg))


def accumulation(cfg: dict) -> int:
    return cfg["effective_batch_size"] // cfg["batch_size"]


def updates_per_epoch(cfg: dict) -> int:
    return max(1, (cfg["train_images"] // cfg["batch_size"]) // accumulation(cfg))


def make_batches(cfg: dict, n: int, seed: int, device,
                 mode: str) -> List[Dict[str, torch.Tensor]]:
    out = []
    for images, classes in image_pool(cfg["data"], n, cfg["batch_size"], seed, device):
        b = {"images": images, "labels": torch.as_tensor(classes.astype(np.int32), device=device)}
        if mode != "train":
            b["valid"] = torch.ones(len(classes), dtype=torch.bool, device=device)
        out.append(b)
    return out


def work_shapes(cfg: dict, batch_list) -> dict:
    """What the FLOP and byte counts need of the batches beyond the sizes."""
    return {}


class Program:
    """The program at one seed.  ``call(i)`` runs step ``i`` on batch
    ``i % len(batches)`` and returns the step's loss (a device scalar);
    an eval step's logits (taken by a forward hook on the model) and
    metrics are kept, the latest of each batch, in ``outputs``."""

    def __init__(self, cfg: dict, seeds: dict, device, mode: str, pool: int):
        from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
        from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
            build_optimizer,
            cosine_epoch_schedule,
        )
        from multimodal_concept_learning_tpu_torch.parallel.train_step import (
            TrainState,
            make_classifier_eval_step,
            make_classifier_train_step,
        )
        from multimodal_concept_learning_tpu_torch.train.vision_training import init_model

        keys = ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                "patch_size", "image_size", "hidden_dropout_prob", "attention_dropout_prob",
                "batch_size", "effective_batch_size", "learning_rate", "weight_decay", "epochs",
                "label_smoothing")
        config = VisionTrainingConfig.from_params(
            dict({k: cfg[k] for k in keys}, model_name="vit", num_labels=sizes(cfg)["num_labels"]))
        self.mode = mode
        self.model = model = init_model(config, torch.Generator(device=device).manual_seed(0),
                                        device)
        model.load_state_dict(make_weights(spec(cfg), layout.init, seeds["weights"], device),
                              strict=True)
        self.batches = make_batches(cfg, pool, seeds["images"], device, mode)
        self.images_per_step = cfg["batch_size"]
        if mode == "train":
            schedule = cosine_epoch_schedule(cfg["learning_rate"], cfg["epochs"],
                                             updates_per_epoch(cfg))
            opt = build_optimizer(model, schedule, weight_decay=cfg["weight_decay"],
                                  max_grad_norm=cfg["max_grad_norm"],
                                  accumulation_steps=accumulation(cfg))
            gen = torch.Generator(device=device).manual_seed(seeds["dropout"])
            self.state = TrainState(model=model, optimizer=opt, generator=gen)
            self.step = make_classifier_train_step(model, gen, cfg["label_smoothing"])
        else:
            self.step = make_classifier_eval_step(model, cfg["label_smoothing"])
            model.register_forward_hook(self._hook)
        self.outputs = {}
        self._logits = None

    def _hook(self, module, args, out):
        self._logits = out

    def call(self, i: int):
        slot = i % len(self.batches)
        if self.mode == "train":
            self.state, m = self.step(self.state, self.batches[slot])
            return m["loss"]
        m = self.step(self.model, self.batches[slot])
        self.outputs[slot] = {"logits": self._logits, "loss": m["loss"]}
        return m["loss"]

    def results(self) -> dict:
        """What the eval steps produced, for ``eval_numbers``."""
        return {"outputs": self.outputs}


def reference_train(cfg: dict, seeds: dict, batch_list, micro_steps: int, device,
                    numerics: Numerics, fault=None) -> dict:
    """The reference's first ``micro_steps`` micro-steps from the seeded
    weights: {"losses", "first_grads" (the first update's clipped
    gradients), "after" (the parameters then), "before"}.  ``fault``
    (calibration only) plants "half_batch" or "row_altered"."""
    m = sizes(cfg)
    before = make_weights(spec(cfg), layout.init, seeds["weights"], device)
    params = {n: w.clone().requires_grad_(True) for n, w in before.items()}
    opt = AdamW(params, cosine_per_epoch(cfg["learning_rate"], cfg["epochs"],
                                         updates_per_epoch(cfg)),
                cfg["weight_decay"], cfg["max_grad_norm"], accumulation(cfg))
    drop = models.Dropout(m["hidden_dropout_prob"], m["attention_dropout_prob"],
                          torch.Generator(device=device).manual_seed(seeds["dropout"]))
    losses = []
    for i in range(micro_steps):
        b = batch_list[i % len(batch_list)]
        images, labels = b["images"], b["labels"]
        if fault == "half_batch":
            images, labels = images[: len(labels) // 2], labels[: len(labels) // 2]
        logits = models.classifier_logits(numerics, params, images, m, drop)
        if fault == "row_altered":
            logits = torch.cat([logits[1:2], logits[1:]])
        loss = models.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        opt.step(dict(zip(params, grads)))
    return {"losses": losses, "first_grads": opt.first_grads, "first_norm": opt.first_norm,
            "after": {n: p.detach() for n, p in params.items()}, "before": before}


def reference_eval(cfg: dict, seeds: dict, batch_list, device, numerics: Numerics) -> list:
    """For each batch {"logits", "loss"} of the reference."""
    weights = make_weights(spec(cfg), layout.init, seeds["weights"], device)
    out = []
    with torch.no_grad():
        for b in batch_list:
            z = models.classifier_logits(numerics, weights, b["images"], sizes(cfg))
            out.append({"logits": z, "loss": models.cross_entropy(z, b["labels"])})
    return out


def eval_numbers(results: dict, reference: list) -> dict:
    """{"logits": the worst row's relative gap over every batch of the
    pool, "loss": the worst batch's relative gap of the step's loss}, of
    the program's ``Program.results()`` against ``reference_eval``'s."""
    from benchmark.check import relative_gap, row_gap

    got = [results["outputs"].get(s) for s in range(len(reference))]
    if any(g is None for g in got):
        return {"logits": (float("inf"), "a batch never ran"), "loss": (float("inf"), "")}
    logits = max(row_gap(g["logits"], r["logits"], relative=True) for g, r in zip(got, reference))
    loss = relative_gap([float(g["loss"]) for g in got], [float(r["loss"]) for r in reference])
    return {"logits": (logits, ""), "loss": (loss, "")}


def results_of_reference(reference: list) -> dict:
    """A reference run's outputs in ``Program.results()``'s form (the
    control put in the program's place)."""
    return {"outputs": dict(enumerate(reference))}
