"""The CLIP dual encoder of the contrastive CLI: the program's side (the
CLI's ``init_model``, ``build_optimizer`` over its linear warm-up schedule,
``make_clip_train_step``; for zero-shot ``make_zero_shot_step`` against the
class features the CLI makes once with ``encode_text``) and the plain
reference's side, on the same seeded weights and batches.

Train batches: {"images" float32 NCHW, "input_ids" int32, "attention_mask"
int32}, each row's caption the frozen ids of its class's caption; zero-shot
batches: {"images", "labels" int32, "valid" bool}.  A zero-shot step's
image features are taken from ``encode_image`` (the step's own call,
wrapped on the instance) and kept, the latest of each batch, in
``outputs``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.inputs import caption_batch, image_pool, make_weights
from benchmark.reference import layout, models
from benchmark.reference.adamw import AdamW, linear_warmup
from benchmark.reference.numerics import Numerics


def spec(cfg: dict):
    return layout.clip(cfg)


def accumulation(cfg: dict) -> int:
    return max(1, cfg["effective_batch_size"] // cfg["batch_size"])


def total_updates(cfg: dict) -> int:
    """The CLI's ``len(loader) * epochs // accumulation``."""
    return max(1, (cfg["train_images"] // cfg["batch_size"]) * cfg["epochs"] // accumulation(cfg))


def class_captions(cfg: dict, device):
    ids, mask = caption_batch(cfg["data"], np.arange(len(cfg["data"]["class_names"])),
                              cfg["context_length"])
    return torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)


def make_batches(cfg: dict, n: int, seed: int, device,
                 mode: str) -> List[Dict[str, torch.Tensor]]:
    out = []
    for images, classes in image_pool(cfg["data"], n, cfg["batch_size"], seed, device):
        if mode == "train":
            ids, mask = caption_batch(cfg["data"], classes, cfg["context_length"])
            out.append({"images": images, "input_ids": torch.as_tensor(ids, device=device),
                        "attention_mask": torch.as_tensor(mask, device=device)})
        else:
            out.append({"images": images,
                        "labels": torch.as_tensor(classes.astype(np.int32), device=device),
                        "valid": torch.ones(len(classes), dtype=torch.bool, device=device)})
    return out


def work_shapes(cfg: dict, batch_list) -> dict:
    """The caption lengths of every train batch (the text tower's valid
    query-key pairs)."""
    return {"caption_lengths": [b["attention_mask"].sum(dim=1).tolist()
                                for b in batch_list if "attention_mask" in b]}


class Program:
    """The program at one seed.  ``call(i)`` runs step ``i`` on batch
    ``i % len(batches)`` and returns a device scalar of its result."""

    def __init__(self, cfg: dict, seeds: dict, device, mode: str, pool: int):
        from multimodal_concept_learning_tpu_torch.configs import ContrastiveTrainingConfig
        from multimodal_concept_learning_tpu_torch.parallel.optimizer import (
            build_optimizer,
            linear_warmup_schedule,
        )
        from multimodal_concept_learning_tpu_torch.parallel.train_step import (
            TrainState,
            make_clip_train_step,
            make_zero_shot_step,
        )
        from multimodal_concept_learning_tpu_torch.train.contrastive_training import init_model

        keys = ("vision_model_name", "image_size", "text_width", "text_layers", "text_heads",
                "context_length", "embed_dim", "batch_size", "effective_batch_size",
                "learning_rate", "weight_decay", "max_grad_norm", "warmup_steps", "epochs")
        config = ContrastiveTrainingConfig.from_params(dict({k: cfg[k] for k in keys}, seed=0))
        self.mode = mode
        self.model = model = init_model(config, cfg["vocab_size"], device)
        vis = model.cfg.vision
        for key in ("hidden_size", "intermediate_size", "num_hidden_layers",
                    "num_attention_heads", "patch_size", "image_size"):
            if getattr(vis, key) != cfg[key]:
                raise ValueError(f"the program's image tower has {key} {getattr(vis, key)}, "
                                 f"the configuration {cfg[key]}")
        model.load_state_dict(make_weights(spec(cfg), layout.init, seeds["weights"], device),
                              strict=True)
        self.batches = make_batches(cfg, pool, seeds["images"], device, mode)
        self.images_per_step = cfg["batch_size"]
        self.outputs = {}
        if mode == "train":
            schedule = linear_warmup_schedule(cfg["learning_rate"], cfg["warmup_steps"],
                                              total_updates(cfg))
            opt = build_optimizer(model, schedule, weight_decay=cfg["weight_decay"],
                                  max_grad_norm=cfg["max_grad_norm"],
                                  accumulation_steps=accumulation(cfg))
            self.state = TrainState(model=model, optimizer=opt)
            self.step = make_clip_train_step(model)
            self._tap_first_features(model)
        else:
            ids, mask = class_captions(cfg, device)
            with torch.no_grad():  # as the CLI's zero_shot_eval, once
                model.eval()
                self.class_features = model.encode_text(ids, mask)
            self.step = make_zero_shot_step(model)
            encode = model.encode_image
            self._features = None

            def tapped(images):
                self._features = encode(images)
                return self._features

            model.encode_image = tapped

    def _tap_first_features(self, model) -> None:
        """Keep the features of the first train step's own forward (the
        towers' outputs it computes the loss from); the taps go after it."""
        self.first_outputs = {}
        for name, key in (("encode_image", "image_features"), ("encode_text", "text_features")):
            def tapped(*args, _f=getattr(model, name), _k=key, **kwargs):
                out = _f(*args, **kwargs)
                self.first_outputs.setdefault(_k, out.detach())
                return out
            setattr(model, name, tapped)

    def call(self, i: int):
        slot = i % len(self.batches)
        if self.mode == "train":
            self.state, m = self.step(self.state, self.batches[slot])
            if "encode_image" in vars(self.model):  # the class's methods from now on
                del self.model.encode_image, self.model.encode_text
            return m["loss"]
        correct, count = self.step(self.model, self.batches[slot], self.class_features)
        self.outputs[slot] = {"image_features": self._features}
        return correct

    def results(self) -> dict:
        """What the zero-shot steps and set-up produced, for ``eval_numbers``."""
        return {"outputs": self.outputs, "class_features": self.class_features}


def reference_train(cfg: dict, seeds: dict, batch_list, micro_steps: int, device,
                    numerics: Numerics, fault=None) -> dict:
    """The reference's first ``micro_steps`` steps from the seeded weights:
    {"losses", "first_grads" (the first update's clipped gradients),
    "first_outputs" (the first step's features), "after", "before"}.  ``fault`` (calibration only) plants "half_batch"
    or "row_altered"."""
    before = make_weights(spec(cfg), layout.init, seeds["weights"], device)
    params = {n: w.clone().requires_grad_(True) for n, w in before.items()}
    opt = AdamW(params, linear_warmup(cfg["learning_rate"], cfg["warmup_steps"],
                                      total_updates(cfg)),
                cfg["weight_decay"], cfg["max_grad_norm"], accumulation(cfg))
    losses, first = [], {}
    for i in range(micro_steps):
        b = batch_list[i % len(batch_list)]
        images, ids, mask = b["images"], b["input_ids"], b["attention_mask"]
        if fault == "half_batch":
            half = len(ids) // 2
            images, ids, mask = images[:half], ids[:half], mask[:half]
        img = models.clip_image_features(numerics, params, images, cfg)
        if fault == "row_altered":
            img = torch.cat([img[1:2], img[1:]])
        txt = models.clip_text_features(numerics, params, ids, mask, cfg)
        if i == 0:
            first = {"image_features": img.detach(), "text_features": txt.detach()}
        loss = models.contrastive_loss(img, txt, models.clip_scale(params))
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        opt.step(dict(zip(params, grads)))
    return {"losses": losses, "first_grads": opt.first_grads, "first_norm": opt.first_norm,
            "first_outputs": first,
            "after": {n: p.detach() for n, p in params.items()}, "before": before}


def reference_eval(cfg: dict, seeds: dict, batch_list, device, numerics: Numerics) -> dict:
    """{"class_features", "image_features": [one per batch]} of the reference."""
    weights = make_weights(spec(cfg), layout.init, seeds["weights"], device)
    with torch.no_grad():
        ids, mask = class_captions(cfg, device)
        return {"class_features": models.clip_text_features(numerics, weights, ids, mask, cfg),
                "image_features": [models.clip_image_features(numerics, weights, b["images"], cfg)
                                   for b in batch_list]}


def eval_numbers(results: dict, reference: dict) -> dict:
    """{"image_features": the worst row's ||program - reference|| over every
    batch of the pool, "class_features": the same of the 12 class
    features made in set-up} (unit vectors)."""
    from benchmark.check import row_gap

    got = [results["outputs"].get(s) for s in range(len(reference["image_features"]))]
    if any(g is None for g in got):
        image = float("inf")
    else:
        image = max(row_gap(g["image_features"], r, relative=False)
                    for g, r in zip(got, reference["image_features"]))
    return {"image_features": (image, ""),
            "class_features": (row_gap(results["class_features"], reference["class_features"],
                                       relative=False), "")}


def results_of_reference(reference: dict) -> dict:
    """A reference run's outputs in ``Program.results()``'s form (the
    control put in the program's place)."""
    return {"outputs": {i: {"image_features": f}
                        for i, f in enumerate(reference["image_features"])},
            "class_features": reference["class_features"]}
