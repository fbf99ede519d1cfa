"""Numeric-sanity utilities (counterpart of
multimodal_concept_learning_tpu/utils/debugging.py).

- ``enable_nan_checks()``: autograd anomaly detection
  (``torch.autograd.set_detect_anomaly``), the counterpart of JAX's
  ``jax_debug_nans``: a backward that makes a NaN raises, naming the
  forward op.  Slow; for debugging only.
- ``checked(fn)``: ``fn`` wrapped to return ``(err, out)``, as JAX's
  ``checkify`` wrapper does; ``err.throw()`` raises ``FloatingPointError``
  when an output tensor holds a NaN or an infinity (``err.get()`` gives the
  message, None when all is finite).  It checks outputs, not every
  intermediate as checkify's float checks do.
- ``assert_finite_tree(tree, name)``: a host-side validator for state
  dicts and nested dicts / lists of tensors or arrays, with JAX's message
  (``{name}{keystr} has {n} non-finite values``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def enable_nan_checks(enabled: bool = True):
    torch.autograd.set_detect_anomaly(enabled)


class CheckError:
    """The result of a ``checked`` call."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


def _leaves(tree, path=""):
    """(keystr, leaf) pairs of a nested dict / list / tuple, JAX's keystr."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _non_finite(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return 0
        return int((~torch.isfinite(leaf.detach())).sum())
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fc":
        return 0
    return int(np.size(arr) - np.isfinite(arr).sum())


def checked(fn):
    """``fn`` returning ``(CheckError, out)``; see the module docstring."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, leaf in _leaves(out):
            bad = _non_finite(leaf)
            if bad:
                return CheckError(f"non-finite output{path}: {bad} values"), out
        return CheckError(), out

    return wrapper


def assert_finite_tree(tree, name: str = "tree"):
    for path, leaf in _leaves(tree):
        bad = _non_finite(leaf)
        if bad:
            raise FloatingPointError(f"{name}{path} has {bad} non-finite values")


__all__ = ["CheckError", "assert_finite_tree", "checked", "enable_nan_checks"]
