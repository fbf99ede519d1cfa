"""The trainers' update rule, written from optax's definitions:
``MultiSteps(k)`` over ``chain(clip_by_global_norm(c), adamw(schedule,
b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd))`` on float32 parameters.

- ``MultiSteps``: the running mean of k micro-gradients, one inner update
  on every k-th; the schedule and the bias correction count inner updates.
- ``clip_by_global_norm``: ``g * c / norm`` when ``norm >= c``.
- ``adamw``: moments, bias correction, ``m / (sqrt(v) + eps)``, plus the
  decoupled ``wd * p``, times ``-schedule(count)``.

And the two schedules the CLIs build: the linear warm-up and decay of the
contrastive CLI (HF ``get_linear_schedule_with_warmup``), and the
per-epoch cosine of the vision CLI (``CosineAnnealingLR`` to 1% of the
rate).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch


def linear_warmup(base: float, warmup: int, total: int) -> Callable[[int], float]:
    def lr(n: int) -> float:
        if n < warmup:
            return base * n / max(warmup, 1)
        return base * min(max((total - n) / max(total - warmup, 1), 0.0), 1.0)
    return lr


def cosine_per_epoch(base: float, epochs: int, updates_per_epoch: int) -> Callable[[int], float]:
    low = 0.01 * base

    def lr(n: int) -> float:
        epoch = min(n // max(updates_per_epoch, 1), epochs)
        return low + 0.5 * (base - low) * (1.0 + math.cos(math.pi * epoch / epochs))
    return lr


class AdamW:
    """``step(grads)`` takes one micro-step's gradients and returns True
    when it updated ``params`` (in place)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: Callable[[int], float],
                 weight_decay: float, max_grad_norm: float, accumulation: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd, self.clip = params, lr, weight_decay, max_grad_norm
        self.k, self.b1, self.b2, self.eps = accumulation, b1, b2, eps
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.micro = 0
        self.count = 0
        self.first_grads = None  # the first update's (clipped) gradients
        self.first_norm = None  # and their global norm before clipping

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> bool:
        for n, g in grads.items():
            self.acc[n] += (g - self.acc[n]) / (self.micro + 1)
        self.micro += 1
        if self.micro < self.k:
            return False
        self.micro = 0
        g = {n: a.clone() for n, a in self.acc.items()}
        for a in self.acc.values():
            a.zero_()
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
        if self.first_grads is None:
            self.first_norm = float(norm)  # before clipping
        if self.clip and float(norm) >= self.clip:
            g = {n: x * (self.clip / norm) for n, x in g.items()}
        if self.first_grads is None:
            self.first_grads = {n: x.clone() for n, x in g.items()}
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        rate = self.lr(self.count - 1)
        for n, p in self.params.items():
            self.mu[n].mul_(self.b1).add_(g[n], alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).add_(g[n] * g[n], alpha=1.0 - self.b2)
            update = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps)
            p -= rate * (update + self.wd * p)
        return True
