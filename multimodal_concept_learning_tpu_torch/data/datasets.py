"""CSV-backed datasets (counterpart of
multimodal_concept_learning_tpu/data/datasets.py, without Pillow).

``ColorDataset`` reads ``image_path,class_name`` CSVs and decodes PNGs with
``data/png.py``; it returns (image, class_name) with ``return_synset`` and
(image, label index) otherwise, and exposes ``unique_labels`` /
``label_to_idx`` / ``num_classes``.  ImageNet (JPEG) datasets are not
ported yet.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, List, Optional, Tuple

from multimodal_concept_learning_tpu_torch.data.png import read_png


class ColorDataset:
    def __init__(self, mapping_csv_path: str, data_dir: str,
                 transform: Optional[Callable] = None, return_synset: bool = False,
                 verbose: bool = True):
        self.data_dir = data_dir
        self.transform = transform
        self.return_synset = return_synset
        self.dataset: List[Tuple[str, str]] = []
        with open(mapping_csv_path, newline="") as f:
            for row in csv.DictReader(f):
                self.dataset.append((os.path.join(data_dir, row["image_path"]),
                                     row["class_name"]))
        self.unique_labels = sorted({item[1] for item in self.dataset})
        self.label_to_idx = {label: idx for idx, label in enumerate(self.unique_labels)}
        self.num_classes = len(self.unique_labels)
        if verbose:
            print(f"Loaded {len(self.dataset)} images with {self.num_classes} classes")

    def __len__(self):
        return len(self.dataset)

    def _label(self, label_data: str):
        return label_data if self.return_synset else self.label_to_idx[label_data]

    def load_uint8(self, idx: int):
        """(uint8 [H, W, 3] image, label) with no transform applied."""
        image_path, label_data = self.dataset[idx]
        return read_png(image_path), self._label(label_data)

    def __getitem__(self, idx):
        image, label = self.load_uint8(idx)
        if self.transform:
            image = self.transform(image)
        return image, label


class ImageNetDataset:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ImageNet (JPEG) datasets are not ported yet (ROADMAP.md, queue A)")


def load_split_datasets(dataset_cls, mapping_dir: str, data_dir: str, train_transform,
                        val_transform, return_synset: bool = False):
    """train/val/test datasets from ``{split}_mapping.csv`` in ``mapping_dir``."""
    paths = {split: os.path.join(mapping_dir, f"{split}_mapping.csv")
             for split in ("train", "val", "test")}
    for split, path in paths.items():
        if not os.path.exists(path):
            raise FileNotFoundError(f"Missing {split} mapping CSV at {path}")
    return (dataset_cls(paths["train"], data_dir, transform=train_transform,
                        return_synset=return_synset),
            dataset_cls(paths["val"], data_dir, transform=val_transform,
                        return_synset=return_synset),
            dataset_cls(paths["test"], data_dir, transform=val_transform,
                        return_synset=return_synset))


__all__ = ["ColorDataset", "ImageNetDataset", "load_split_datasets"]
