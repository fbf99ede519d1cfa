"""Write the JPEG fixtures of ``tests/data/jpeg/`` and their ``digests.json``.

    python tests/make_jpeg_fixtures.py

The images are synthetic scenes (gradients, discs, stripes and a little
seeded noise) encoded by Pillow over libjpeg-turbo in every variant the
port's decoder takes: 4:2:0 at quality 75 and 95 in both orientations,
4:2:2, 4:4:4, grayscale, progressive, restart intervals, optimized Huffman
tables, Adobe CMYK, sizes that are not a multiple of the MCU, images one or
two chroma samples wide, and a PNG named ``.JPEG``.  ``digests.json`` holds
each file's Pillow ``convert("RGB")`` shape and sha256, and the sha256 of
the JAX package's transform pipelines (the train and val pipelines of the
four ImageNet experiment configs, at fixed seeds) over the decoded files,
which the port's pipelines are held to without Pillow.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jpeg")
PIPELINE_SEEDS = (0, 1)

# name -> (width, height, mode, save keywords)
FIXTURES = {
    "q75_420_500x375.jpg": (500, 375, "RGB", dict(quality=75, subsampling=2)),
    "q95_420_500x375.jpg": (500, 375, "RGB", dict(quality=95, subsampling=2)),
    "q75_420_375x500.jpg": (375, 500, "RGB", dict(quality=75, subsampling=2)),
    "q95_420_375x500.jpg": (375, 500, "RGB", dict(quality=95, subsampling=2)),
    "q90_422_333x500.jpg": (333, 500, "RGB", dict(quality=90, subsampling=1)),
    "q90_444_97x131.jpg": (97, 131, "RGB", dict(quality=90, subsampling=0)),
    "q85_422_97x131.jpg": (97, 131, "RGB", dict(quality=85, subsampling=1)),
    "q80_420_97x131.jpg": (97, 131, "RGB", dict(quality=80, subsampling=2)),
    "gray_q85_131x97.jpg": (131, 97, "L", dict(quality=85)),
    "progressive_420_333x500.jpg": (333, 500, "RGB", dict(quality=85, subsampling=2,
                                                           progressive=True)),
    "progressive_gray_restart_121x77.jpg": (121, 77, "L", dict(quality=90, progressive=True,
                                                               restart_marker_blocks=3)),
    "progressive_420_restart_200x150.jpg": (200, 150, "RGB", dict(quality=80, subsampling=2,
                                                                  progressive=True,
                                                                  restart_marker_rows=2)),
    "progressive_422_97x131.jpg": (97, 131, "RGB", dict(quality=92, subsampling=1,
                                                        progressive=True)),
    "restart_420_200x150.jpg": (200, 150, "RGB", dict(quality=85, subsampling=2,
                                                      restart_marker_blocks=5)),
    "restart_rows_444_150x200.jpg": (150, 200, "RGB", dict(quality=85, subsampling=0,
                                                           restart_marker_rows=1)),
    "optimized_420_256x192.jpg": (256, 192, "RGB", dict(quality=88, subsampling=2,
                                                        optimize=True)),
    "cmyk_97x131.jpg": (97, 131, "CMYK", dict(quality=90)),
    "tiny_420_3x5.jpg": (3, 5, "RGB", dict(quality=90, subsampling=2)),
    "tiny_420_4x2.jpg": (4, 2, "RGB", dict(quality=90, subsampling=2)),
    "tiny_422_5x3.jpg": (5, 3, "RGB", dict(quality=90, subsampling=1)),
    "tiny_420_7x9.jpg": (7, 9, "RGB", dict(quality=90, subsampling=2)),
}
PNG_NAMED_JPEG = "png_named.JPEG"


def scene(width: int, height: int, seed: int) -> np.ndarray:
    """A smooth synthetic [H, W, 3] uint8 scene with edges and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.stack([255 * x / max(width - 1, 1), 255 * y / max(height - 1, 1),
                    127 + 100 * np.sin(x / 9.0 + y / 13.0)], axis=-1)
    for _ in range(6):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        r = rng.uniform(0.08, 0.3) * min(width, height) + 1
        color = rng.uniform(0, 255, 3)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = color
    img[(x.astype(int) // 7) % 5 == 0] *= 0.6  # stripes
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def pillow_rgb(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_fixtures() -> dict:
    os.makedirs(OUT, exist_ok=True)
    decode = {}
    for i, (name, (w, h, mode, kwargs)) in enumerate(sorted(FIXTURES.items())):
        rgb = Image.fromarray(scene(w, h, seed=i))
        im = rgb.convert(mode) if mode != "RGB" else rgb
        path = os.path.join(OUT, name)
        im.save(path, "JPEG", **kwargs)
        arr = pillow_rgb(path)
        decode[name] = {"shape": list(arr.shape), "sha256": sha256(arr)}
    png = io.BytesIO()
    Image.fromarray(scene(64, 48, seed=99)).save(png, "PNG")
    path = os.path.join(OUT, PNG_NAMED_JPEG)
    with open(path, "wb") as f:
        f.write(png.getvalue())
    arr = pillow_rgb(path)
    decode[PNG_NAMED_JPEG] = {"shape": list(arr.shape), "sha256": sha256(arr)}
    return decode


def load_config(kind: str, rel_path: str, package: str):
    """The training config object of ``rel_path`` from ``package``'s configs."""
    import importlib

    configs = importlib.import_module(f"{package}.configs")
    cls = (configs.VisionTrainingConfig if kind == "vision"
           else configs.MultimodalTrainingConfig)
    if package == "multimodal_concept_learning_tpu":
        import yaml

        load = yaml.safe_load
    else:
        from multimodal_concept_learning_tpu_torch import miniyaml

        load = miniyaml.safe_load
    with open(os.path.join(ROOT, rel_path)) as f:
        return cls.from_params(load(f))


def pipeline_digests(read_rgb, create_transforms, package: str) -> dict:
    """{config: {train|val: {seed: [sha256 per fixture]}}} of the pipelines
    run over the decoded fixtures in sorted order (one Compose per seed)."""
    from chip_smoke import IMAGENET_CONFIGS

    names = sorted([*FIXTURES, PNG_NAMED_JPEG])
    images = [read_rgb(os.path.join(OUT, n)) for n in names]
    out = {}
    for kind, rel in IMAGENET_CONFIGS:
        config = load_config(kind, rel, package)
        per = {}
        for split in ("train", "val"):
            per[split] = {}
            for seed in PIPELINE_SEEDS:
                t = create_transforms(config, is_train=split == "train", seed=seed)
                per[split][str(seed)] = [sha256(np.asarray(t(img), np.float32))
                                         for img in images]
        out[rel] = per
    return out


def main() -> None:
    sys.path.insert(0, ROOT)  # the JAX package and chip_smoke's config list
    decode = write_fixtures()
    from multimodal_concept_learning_tpu.data.transforms import create_transforms

    pipelines = pipeline_digests(lambda p: Image.fromarray(pillow_rgb(p)), create_transforms,
                                 "multimodal_concept_learning_tpu")
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump({"decode": decode, "pipelines": pipelines, "seeds": list(PIPELINE_SEEDS)},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(decode)} fixtures and digests.json to {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
