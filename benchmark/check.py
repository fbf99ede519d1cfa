"""The numbers that decide ``correct``: each compares what the timed path
produced with what the plain reference computes from the same inputs, and
is held to its own limit (``limits/<workload>.json``).

Training (the first steps, through the window's own call, on rows that
all differ; the reference follows them):

- ``loss``: the widest relative gap between a step's loss and the
  reference's, over the checked steps;
- ``grad``: the first update's gradient, as the optimizer holds it (its
  first moment over ``1 - b1``), by the worst leaf: the gap between the
  program's norm of the leaf and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change``: the parameters' change over the checked steps, by the worst
  leaf as for ``grad``, leaving out the leaves whose reference gradient is
  nought to rounding (under a thousandth of the median leaf's: a key's
  bias under softmax, which AdamW moves by round-off alone);
- what a family taps from the first step's own forward (CLIP's image and
  text features): the worst row's distance from the reference's.

Evaluation: each family compares the logits or features of every batch
of the pool (each batch's latest step in the window) row by row.

A number that cannot be formed (a missing or misshapen output, NaN)
reads ``inf`` and fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, values))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names=None) -> Dict[str, float]:
    """{leaf: |prog - ref| / max(ref, median ref)}; None where a leaf is
    missing."""
    names = list(names if names is not None else ref)
    if not names or set(names) - set(prog):
        return None
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    return {n: (g if math.isfinite(g) else math.inf) for n, g in gaps.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names=None) -> tuple:
    """(worst gap, its leaf) of ``leaf_gaps``."""
    gaps = leaf_gaps(prog, ref, names)
    if gaps is None:
        return math.inf, "missing leaves"
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def relative_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref) or not ref:
        return math.inf
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def train_numbers(program: dict, reference: dict) -> Dict[str, tuple]:
    """{name: (value, detail)} of the program's readings
    {"losses", "grad_norms", "change_norms"} against the reference's
    outputs {"losses", "first_grads", "after", "before"}."""
    ref_grad = norms(reference["first_grads"])
    ref_change = norms({n: reference["after"][n] - reference["before"][n]
                        for n in reference["after"]})
    med = statistics.median(ref_grad.values())
    moved = [n for n in ref_grad if ref_grad[n] >= EXCLUDE_BELOW * med]
    out = {"loss": (relative_gap(program["losses"], reference["losses"]), ""),
           "grad": worst_leaf(program["grad_norms"], ref_grad),
           "change": worst_leaf(program["change_norms"], ref_change, moved)}
    for key, ref in reference.get("first_outputs", {}).items():
        out[key] = (row_gap(program["first_outputs"].get(key), ref, relative=False), "")
    return out


def row_gap(prog: torch.Tensor, ref: torch.Tensor, relative: bool) -> float:
    """The worst row's ||prog - ref|| (over ||ref|| when ``relative``)."""
    if prog is None or tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    diff = torch.linalg.vector_norm(prog.float() - ref.float(), dim=-1)
    if relative:
        diff = diff / torch.linalg.vector_norm(ref.float(), dim=-1).clamp(min=1e-30)
    value = float(diff.max())
    return value if math.isfinite(value) else math.inf


def judge(numbers: Dict[str, tuple], limits: Dict[str, float]) -> tuple:
    """(correct, [(name, value, limit, detail)]) of the numbers the cell's
    limits name (a number the run could not form reads inf): correct when
    each is at or under its limit."""
    rows, ok = [], bool(limits)
    for name, limit in limits.items():
        value, detail = numbers.get(name, (math.inf, "not formed"))
        if not value <= limit:
            ok = False
        rows.append((name, value, limit, detail))
    return ok, rows
