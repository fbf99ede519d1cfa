"""AdamW with clipping, masking and accumulation (counterpart of
multimodal_concept_learning_tpu/parallel/optimizer.py), in optax's order:

1. gradient accumulation as ``optax.MultiSteps``: the running mean of k
   micro-gradients (``acc += (g - acc) / (n + 1)``), one inner update every
   k micro-steps; Adam's bias correction and the schedule count inner
   updates only;
2. clip by global norm over the trained parameters only, optax's formula
   (``g / norm * max_norm`` when ``norm >= max_norm``; no epsilon);
3. AdamW: b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
   trained parameter, then ``-lr`` (a float, or a schedule of the inner
   update count).

Frozen parameters (``requires_grad=False``) are simply not handed to the
optimizer (the JAX ``set_to_zero`` partition).  With ``fp32_master`` (the
``bf16_params`` setting) the parameters are stored in bf16: gradients are
accumulated in their dtype, each operation of the running mean rounded to
it (as ``MultiSteps`` does on bf16 gradients), then upcast to float32, and
AdamW runs on float32 master copies, whose bf16 rounding is written back
after each update.
Under a process group each micro-step's gradients are summed over the
ranks (``multihost.reduce_gradients``; a sharded model's over its data
axes) before they enter the accumulator, and the clipping norm is the
global one (``multihost.global_sq_norm``: the shards' squared norms
summed over their axes, the replicated parameters counted once; the
plain sum when nothing is sharded).  Build the optimizer after ``shard_params``: it holds the
shards.
Every update is plain tensor arithmetic on the parameters' device.
``step`` is an ``optimizer`` span (``utils/profiling.py``) holding
``optimizer.reduce`` (under a process group), ``optimizer.accumulate``,
``optimizer.clip`` and ``optimizer.update``; the float32 cast of the
gradients is the optimizer's own time.
``state_dict`` / ``load_state_dict`` carry everything a resumed run needs
(the moments, masters, accumulator and both counters), so a run resumed
between the micro-steps of one accumulation continues bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import torch

from multimodal_concept_learning_tpu_torch.parallel import multihost
from multimodal_concept_learning_tpu_torch.utils.profiling import span

Schedule = Union[float, Callable[[int], float]]


def cosine_epoch_schedule(base_lr: float, epochs: int, updates_per_epoch: int) -> Callable:
    """torch CosineAnnealingLR(T_max=epochs, eta_min=0.01 lr) stepped per epoch."""
    eta_min = base_lr * 0.01

    def schedule(update_count: int) -> float:
        epoch = min(update_count // max(1, updates_per_epoch), epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / epochs))

    return schedule


def linear_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int) -> Callable:
    """HF get_linear_schedule_with_warmup semantics."""

    def schedule(update_count: int) -> float:
        if update_count < warmup_steps:
            warm = max(warmup_steps, 1)
            return base_lr * min(update_count, warm) / warm
        span = max(total_steps - warmup_steps, 1)
        return base_lr * min(max((total_steps - update_count) / span, 0.0), 1.0)

    return schedule


class Optimizer:
    """The optax chain MultiSteps(clip -> AdamW) over named parameters.

    Call ``step()`` once per micro-step, after ``backward()``: it folds the
    parameters' ``.grad`` into the accumulator, clears them, and on every
    k-th call updates the parameters in place.  Returns True when it did.
    """

    def __init__(self, params: Dict[str, torch.nn.Parameter], learning_rate: Schedule,
                 weight_decay: float, max_grad_norm: Optional[float] = None,
                 accumulation_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, fp32_master: bool = False):
        self.params = dict(params)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.k = accumulation_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mini_step = 0
        self.count = 0  # inner updates (Adam's bias-correction and schedule count)
        with torch.no_grad():
            self.master = ({n: p.detach().float().clone() for n, p in self.params.items()}
                           if fp32_master else None)
            self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
            self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()}
            self.acc = ({n: torch.zeros_like(p) for n, p in self.params.items()}
                        if self.k > 1 else None)

    def lr(self, count: int) -> float:
        """The learning rate of inner update ``count`` (0-based)."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def _take_grads(self) -> Dict[str, torch.Tensor]:
        grads = {}
        for n, p in self.params.items():
            grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        return grads

    def state_dict(self) -> dict:
        """The optimizer's state: {count, mini_step, mu, nu, master, acc}
        (tensors by parameter name; ``master`` / ``acc`` None when unused)."""
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu, "nu": self.nu,
                "master": self.master, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (as ``state_dict`` returns it, on any device) into
        this optimizer's tensors; the names and dtypes must be its own."""
        for key in ("mu", "nu", "master", "acc"):
            mine, theirs = getattr(self, key), state[key]
            if (mine is None) != (theirs is None) or (mine is not None and set(mine) != set(theirs)):
                raise ValueError(f"optimizer state {key!r} does not match this optimizer's")
            for name, t in (mine or {}).items():
                if theirs[name].dtype != t.dtype:
                    raise ValueError(f"optimizer state {key}[{name!r}] is {theirs[name].dtype}, "
                                     f"not {t.dtype}")
                t.copy_(theirs[name])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

    @torch.no_grad()
    def step(self) -> bool:
        with span("optimizer"):
            return self._step()

    def _step(self) -> bool:
        grads = self._take_grads()
        if multihost.is_distributed():
            with span("optimizer.reduce"):
                multihost.reduce_gradients(list(grads.values()),
                                           [self.params[n] for n in grads])
        if self.k > 1:
            with span("optimizer.accumulate"):
                n_acc = self.mini_step
                for n, g in grads.items():
                    acc = self.acc[n]
                    acc.copy_(acc + (g - acc) / (n_acc + 1))
                self.mini_step += 1
                if self.mini_step < self.k:
                    return False
                self.mini_step = 0
                grads = {n: a.clone() for n, a in self.acc.items()}
                for a in self.acc.values():
                    a.zero_()
        grads = {n: g.float() for n, g in grads.items()}
        if self.max_grad_norm:
            with span("optimizer.clip"):
                norm = torch.sqrt(multihost.global_sq_norm(
                    list(grads.values()), [self.params[n] for n in grads]))
                keep = norm < self.max_grad_norm
                grads = {n: torch.where(keep, g, (g / norm) * self.max_grad_norm)
                         for n, g in grads.items()}
        with span("optimizer.update"):
            self.count += 1
            bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** self.count)
            bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** self.count)
            step_size = -self.lr(self.count - 1)
            for n, g in grads.items():
                mu, nu = self.mu[n], self.nu[n]
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                target = self.master[n] if self.master is not None else self.params[n]
                upd = (upd + self.weight_decay * target.float()) * step_size
                target.add_(upd)
                if self.master is not None:
                    self.params[n].copy_(target.to(self.params[n].dtype))
        return True


def build_optimizer(model: torch.nn.Module, learning_rate: Schedule, weight_decay: float,
                    max_grad_norm: Optional[float] = None, accumulation_steps: int = 1,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    fp32_master: bool = False) -> Optimizer:
    """AdamW over ``model``'s parameters that require grad (see the module
    docstring for the semantics)."""
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return Optimizer(params, learning_rate, weight_decay, max_grad_norm, accumulation_steps,
                     b1, b2, eps, fp32_master)


__all__ = ["Optimizer", "build_optimizer", "cosine_epoch_schedule", "linear_warmup_schedule"]
