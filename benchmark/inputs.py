"""Inputs of a run, made from its seed: the seeded weights and the pool of
color-circle batches.

Seeds.  ``--seed`` may be any whole number up to a little over 2**31 (or
larger); ``streams(seed)`` spreads it into independent 63-bit seeds for the
weights, the images and the dropout masks through numpy's SeedSequence.

Weights.  ``make_weights`` fills a state dict of the published layout's
names and shapes (``reference/layout.py``) from one ``torch.randn`` call on
the device (a ``torch.Generator`` on the card), split into views: each
tensor is ``mean + std * z`` with the (mean, std) ``layout.init`` gives it.
The same dict goes to the program (``load_state_dict``, strict) and to the
reference.

Images.  A frozen copy of the color generator's sampling
(``data/color_generator.py`` of the port: for each image an intensity
factor, a radius, then the center's x and y, drawn in that order), with
the class of each row drawn first from the seed, rendered on the device:
a solid circle on white, as uint8 and then divided by 255 (``ToTensor``),
float32 NCHW in [0, 1].
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def streams(seed: int) -> Dict[str, int]:
    """Independent seeds for the weights, the images and the dropout masks."""
    ss = np.random.SeedSequence(int(seed) % (2 ** 128))
    words = ss.generate_state(6, dtype=np.uint32).astype(np.uint64)
    pairs = [int(words[2 * i] << np.uint64(31) ^ words[2 * i + 1]) for i in range(3)]
    return {"weights": pairs[0], "images": pairs[1], "dropout": pairs[2]}


def load_dataset(name: str) -> dict:
    with open(os.path.join(HERE, "datasets", f"{name}.json")) as f:
        data = json.load(f)
    data["class_names"] = sorted(f"r{r}g{g}b{b}" for r, g, b in data["colors"])
    return data


def make_weights(spec: Dict[str, Tuple[int, ...]], init: Callable[[str], Tuple[float, float]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor of ``spec``'s shape}, each ``mean + std * z``
    with ``(mean, std) = init(name)`` and z standard normal, from one draw
    of a generator seeded ``seed`` on ``device``, split in ``spec``'s order."""
    sizes = [math.prod(shape) for shape in spec.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for (name, shape), size in zip(spec.items(), sizes):
        mean, std = init(name)
        out[name] = z[offset:offset + size].view(shape).mul(std).add_(mean)
        offset += size
    return out


def _scale_color(rgb, factor: float) -> Tuple[int, int, int]:
    """The generator's intensity scaling (never pure black or white)."""
    out = []
    for c in rgb:
        s = int(round(c * factor))
        out.append(max(1 if c > 0 else 0, min(254 if c == 255 else 255, s)))
    return tuple(out)


def draw_circles(data: dict, n: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(classes [n] int, circles [n, 6] int: r, g, b, radius, cx, cy), each
    class uniform over the dataset's sorted class names."""
    names = data["class_names"]
    by_name = {f"r{r}g{g}b{b}": (r, g, b) for r, g, b in data["colors"]}
    classes = rng.integers(0, len(names), size=n)
    lo, hi = data["radius_range"]
    size = data["image_size"]
    rows = []
    for c in classes:
        factor = rng.uniform(data["min_intensity"], data["max_intensity"])
        rgb = _scale_color(by_name[names[c]], factor)
        radius = int(rng.integers(lo, hi + 1))
        cx = int(rng.integers(radius, size - radius + 1))
        cy = int(rng.integers(radius, size - radius + 1))
        rows.append((*rgb, radius, cx, cy))
    return classes.astype(np.int64), np.asarray(rows, dtype=np.int64)


def render(circles: np.ndarray, size: int, device) -> torch.Tensor:
    """[n, 3, size, size] float32 in [0, 1]: each row's circle on white."""
    c = torch.as_tensor(circles, device=device)
    ax = torch.arange(size, device=device)
    dx = (ax[None, :] - c[:, 4:5]) ** 2  # [n, W]
    dy = (ax[None, :] - c[:, 5:6]) ** 2  # [n, H]
    inside = (dy[:, :, None] + dx[:, None, :]) <= (c[:, 3] ** 2)[:, None, None]  # [n, H, W]
    rgb = c[:, :3].to(torch.uint8)[:, :, None, None]
    img = torch.where(inside[:, None], rgb, torch.full_like(rgb, 255))
    return img.float() / 255.0


def image_pool(data: dict, batches: int, batch_size: int, seed: int,
               device) -> List[Tuple[torch.Tensor, np.ndarray]]:
    """``batches`` batches of (images on ``device``, classes on the host)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    out = []
    for _ in range(batches):
        classes, circles = draw_circles(data, batch_size, rng)
        out.append((render(circles, data["image_size"], device), classes))
    return out


def caption_batch(data: dict, classes: np.ndarray, context_length: int) -> Tuple[np.ndarray,
                                                                                  np.ndarray]:
    """(ids [n, context_length] int32, mask int32) of each class's frozen
    caption, right-padded with the pad id."""
    names = data["class_names"]
    ids = np.full((len(classes), context_length), data["pad_token_id"], dtype=np.int32)
    mask = np.zeros((len(classes), context_length), dtype=np.int32)
    for i, c in enumerate(classes):
        cap = data["caption_ids"][names[c]][:context_length]
        ids[i, :len(cap)] = cap
        mask[i, :len(cap)] = 1
    return ids, mask
