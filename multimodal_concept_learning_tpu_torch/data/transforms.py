"""Image transforms of the port (counterpart of
multimodal_concept_learning_tpu/data/transforms.py, without Pillow).

Only ``ToTensor`` (uint8 [H, W, 3] -> float32 CHW in [0, 1], the same
arithmetic as the JAX transform) and ``Normalize`` (mean/std resolved from
the config as the JAX registry does) are ported; the color configs use
``ToTensor`` alone.  Any other transform name raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

_NORM_STATS_BY_DATASET = {
    name: ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    for name in ("imagenet", "imagenet100", "imagenet_multimodal")
}
_NORM_STATS_FALLBACK = ([0.5, 0.5, 0.5], [0.5, 0.5, 0.5])


class ToTensor:
    """uint8 [H, W, C] -> float32 [C, H, W] in [0, 1]."""

    def __call__(self, img, rng):
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.ascontiguousarray(arr.transpose(2, 0, 1))


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, dtype=np.float32).reshape(-1, 1, 1)

    def __call__(self, x, rng):
        return (x - self.mean) / self.std


class Compose:
    """Sequential pipeline owning its random generator."""

    def __init__(self, transforms_list, seed: int = 0):
        self.transforms = transforms_list
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __call__(self, img, rng=None):
        rng = rng if rng is not None else self.rng
        for t in self.transforms:
            img = t(img, rng)
        return img

    def uint8_spec(self):
        """(mean, std) float32 [3] when the pipeline is ToTensor [+ Normalize],
        so the device can normalise uint8 images itself; else None."""
        seq = self.transforms
        if not seq or not isinstance(seq[0], ToTensor) or len(seq) > 2:
            return None
        if len(seq) == 1:
            return np.zeros(3, np.float32), np.ones(3, np.float32)
        if not isinstance(seq[1], Normalize):
            return None
        return seq[1].mean.reshape(-1), seq[1].std.reshape(-1)


def _parse_spec(entry):
    if isinstance(entry, str):
        return entry, {}
    if isinstance(entry, dict):
        if not entry.get("name"):
            raise ValueError("Transform dict entries must include a 'name' key.")
        return entry["name"], {k: v for k, v in entry.items() if k != "name"}
    raise TypeError("Transform entries must be either strings or dictionaries with a 'name' key.")


def _instantiate(name: str, config, params: Dict[str, Any]):
    if name == "ToTensor":
        return ToTensor()
    if name == "Normalize":
        mean = params.get("mean", getattr(config, "normalize_mean", None))
        std = params.get("std", getattr(config, "normalize_std", None))
        if mean is None or std is None:
            mean, std = _NORM_STATS_BY_DATASET.get(getattr(config, "dataset_name", None),
                                                   _NORM_STATS_FALLBACK)
        return Normalize(mean, std)
    raise NotImplementedError(
        f"transform {name!r} is not ported yet (ToTensor and Normalize are; ROADMAP.md)")


def create_transforms(config, is_train: bool = True, seed: int = 0) -> Compose:
    """The config's ``train_transforms`` / ``val_transforms`` pipeline."""
    entries = getattr(config, "train_transforms" if is_train else "val_transforms", None)
    if not entries:
        raise ValueError("Transform list is empty or undefined in config.")
    shared = getattr(config, "transform_params", {}) or {}
    built = []
    for entry in entries:
        name, inline = _parse_spec(entry)
        built.append(_instantiate(name, config, {**shared.get(name, {}), **inline}))
    return Compose(built, seed=seed)


__all__ = ["Compose", "Normalize", "ToTensor", "create_transforms"]
