"""Synthetic color-circle dataset generator (counterpart of
multimodal_concept_learning_tpu/data/color_generator.py, without Pillow).

The same random stream, pixels, file names, splits and CSVs as the JAX
generator for the same config (this module's ``ColorDatasetConfig``, or the
JAX package's, whose fields and defaults it copies): one solid circle on white
per image, random radius and center (and intensity factor) drawn from one
``PCG64(seed)`` generator in the same order, per-color shuffles and
largest-remainder split counts.  Images are written by ``data/png.py``.

    python -m multimodal_concept_learning_tpu_torch.data.color_generator \
        --config_path experiments/datasets/color/12_colors_3k.yaml

reads a dataset YAML with ``miniyaml`` (no PyYAML) and prints the JAX CLI's
lines; a relative ``data_dir`` resolves against the working directory.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.data.png import write_png


@dataclasses.dataclass(frozen=True)
class ColorDatasetConfig:
    """A color dataset's settings (the fields and defaults of
    ``experiments/datasets/color/*.yaml``)."""

    dataset_name: str = "color_dataset"
    image_size: int = 224
    colors: Tuple[Tuple[int, int, int], ...] = ((255, 0, 0), (0, 255, 0), (0, 0, 255))
    radius_range: Tuple[int, int] = (10, 50)
    n_images_per_color: int = 100
    min_intensity: float = 0.3
    max_intensity: float = 0.95
    train_val_test_split: Tuple[float, float, float] = (0.7, 0.15, 0.15)
    data_dir: str = "/tmp/data/multimodal_concept_learning/"
    seed: int = 42

    @classmethod
    def from_params(cls, params: dict) -> "ColorDatasetConfig":
        """The config of a parsed YAML mapping; unknown keys are ignored."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in params:
                continue
            v = params[f.name]
            if f.name == "colors":
                v = tuple(tuple(int(c) for c in rgb) for rgb in v)
            elif f.name in ("radius_range", "train_val_test_split"):
                v = tuple(v)
            else:
                v = type(f.default)(v)
            kwargs[f.name] = v
        return cls(**kwargs)


def compute_split_counts(num_items: int, ratios: List[float]) -> List[int]:
    """Largest-remainder apportionment of ``num_items`` across split ratios
    (earlier splits win ties)."""
    quotas = np.asarray(ratios, dtype=np.float64) * num_items
    counts = np.floor(quotas).astype(np.int64)
    shortfall = num_items - int(counts.sum())
    if shortfall > 0:
        by_fraction = np.argsort(counts - quotas, kind="stable")
        counts[by_fraction[:shortfall]] += 1
    return counts.tolist()


def _scale_color(rgb: Tuple[int, int, int], factor: float) -> Tuple[int, int, int]:
    """Intensity scaling, clamped so a color never becomes pure black/white."""
    out = []
    for c in rgb:
        s = int(round(c * factor))
        out.append(max(1 if c > 0 else 0, min(254 if c == 255 else 255, s)))
    return tuple(out)


def _render_circle(size: int, cx: int, cy: int, radius: int,
                   rgb: Tuple[int, int, int]) -> np.ndarray:
    yy, xx = np.ogrid[:size, :size]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius ** 2
    img = np.full((size, size, 3), 255, dtype=np.uint8)
    img[mask] = np.asarray(rgb, dtype=np.uint8)
    return img


def generate_color_dataset(config, verbose: bool = True) -> str:
    """Generate the dataset of a ``ColorDatasetConfig`` (this module's or
    the JAX package's) and write the split mapping CSVs; returns the
    dataset dir."""
    rng = np.random.Generator(np.random.PCG64(config.seed))
    dataset_dir = os.path.join(config.data_dir, config.dataset_name)
    os.makedirs(dataset_dir, exist_ok=True)
    min_radius, max_radius = config.radius_range
    color_image_map: Dict[str, List[str]] = {}

    for rgb in config.colors:
        rgb = tuple(int(c) for c in rgb)
        color_name = f"r{rgb[0]}g{rgb[1]}b{rgb[2]}"
        color_dir = os.path.join(dataset_dir, color_name)
        os.makedirs(color_dir, exist_ok=True)
        color_image_map[color_name] = []
        for idx in range(config.n_images_per_color):
            factor = rng.uniform(config.min_intensity, config.max_intensity)
            scaled = _scale_color(rgb, factor)
            radius = int(rng.integers(min_radius, max_radius + 1))
            cx = int(rng.integers(radius, config.image_size - radius + 1))
            cy = int(rng.integers(radius, config.image_size - radius + 1))
            img_path = os.path.join(color_dir, f"circle_{color_name}_{idx:05d}.png")
            write_png(img_path, _render_circle(config.image_size, cx, cy, radius, scaled))
            color_image_map[color_name].append(os.path.relpath(img_path, dataset_dir))
    if verbose:
        print(f"Generated {config.n_images_per_color} images for each of "
              f"{len(config.colors)} colors.")

    split_names = ["train", "val", "test"]
    if len(config.train_val_test_split) != len(split_names):
        raise ValueError("train_val_test_split must contain three values for train/val/test ratios")
    total_ratio = sum(config.train_val_test_split)
    if total_ratio <= 0:
        raise ValueError("train_val_test_split must sum to a positive value")
    ratios = [r / total_ratio for r in config.train_val_test_split]
    records: Dict[str, List[Tuple[str, str]]] = {name: [] for name in split_names}
    for color_name, image_paths in color_image_map.items():
        shuffled = list(image_paths)
        rng.shuffle(shuffled)
        n_train, n_val, _ = compute_split_counts(len(shuffled), ratios)
        records["train"].extend((p, color_name) for p in shuffled[:n_train])
        records["val"].extend((p, color_name) for p in shuffled[n_train:n_train + n_val])
        records["test"].extend((p, color_name) for p in shuffled[n_train + n_val:])
    for split_name in split_names:
        mapping_path = os.path.join(dataset_dir, f"{split_name}_mapping.csv")
        with open(mapping_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["image_path", "class_name"])
            writer.writerows(records[split_name])
        if verbose:
            print(f"Created {split_name} mapping with {len(records[split_name])} images: "
                  f"{mapping_path}")
    if verbose:
        print(f"Dataset saved to: {os.path.abspath(dataset_dir)}")
    return dataset_dir


def main(argv=None) -> str:
    """The CLI (``--config_path``); returns the dataset dir."""
    parser = argparse.ArgumentParser(description="Generate color dataset from config file")
    parser.add_argument("--config_path", type=str, required=True, help="Path to YAML config file")
    args = parser.parse_args(argv)
    with open(args.config_path, "r") as f:
        config = ColorDatasetConfig.from_params(miniyaml.safe_load(f))
    output_path = generate_color_dataset(config)
    print(f"Dataset generation completed. Output: {output_path}")
    return output_path


__all__ = ["ColorDatasetConfig", "compute_split_counts", "generate_color_dataset", "main"]


if __name__ == "__main__":
    main()
