"""CSV-backed datasets (counterpart of
multimodal_concept_learning_tpu/data/datasets.py, without Pillow).

``ColorDataset`` reads ``image_path,class_name`` CSVs and decodes PNGs with
``data/png.py``; ``ImageNetDataset`` reads ``image_path,target_synset,
class_name`` CSVs and decodes JPEGs with ``data/jpeg.py`` (bitwise Pillow's
``convert("RGB")``, so items equal the JAX ``__getitem__``'s).  Both return
(image, class name) with ``return_synset`` and (image, label index)
otherwise, expose ``unique_labels`` / ``label_to_idx`` / ``num_classes``, and
``load_uint8`` for the device-normalize pipeline.  The JAX ``get_batch``
(its native decode and non-antialiased resize) has no counterpart: the port
follows Pillow (ROADMAP.md, queue C).
"""

from __future__ import annotations

import csv
import os
from typing import Callable, List, Optional, Tuple

from multimodal_concept_learning_tpu_torch.data.jpeg import read_image
from multimodal_concept_learning_tpu_torch.data.png import read_png


class _CsvImageDataset:
    """A mapping CSV's (image path, label) rows; images decoded by
    ``decode``, labels as class names (``return_synset``) or indices."""

    decode = staticmethod(read_png)

    def __init__(self, mapping_csv_path: str, data_dir: str,
                 transform: Optional[Callable] = None, return_synset: bool = False,
                 verbose: bool = True):
        self.data_dir = data_dir
        self.transform = transform
        self.return_synset = return_synset
        self.dataset: List[Tuple[str, str]] = []
        with open(mapping_csv_path, newline="") as f:
            for row in csv.DictReader(f):
                self.dataset.append(self._parse_row(row))
        self.unique_labels = sorted({item[1] for item in self.dataset})
        self.label_to_idx = {label: idx for idx, label in enumerate(self.unique_labels)}
        self.num_classes = len(self.unique_labels)
        if verbose:
            print(f"Loaded {len(self.dataset)} images with {self.num_classes} classes")

    def _parse_row(self, row) -> Tuple[str, str]:
        raise NotImplementedError

    def __len__(self):
        return len(self.dataset)

    def _label(self, label_data: str):
        return label_data if self.return_synset else self.label_to_idx[label_data]

    def load_uint8(self, idx: int):
        """(uint8 [H, W, 3] image, label) with no transform applied."""
        image_path, label_data = self.dataset[idx]
        return self.decode(image_path), self._label(label_data)

    def __getitem__(self, idx):
        image, label = self.load_uint8(idx)
        if self.transform:
            image = self.transform(image)
        return image, label


class ColorDataset(_CsvImageDataset):
    """Color-circle PNGs over ``image_path,class_name`` CSVs."""

    def _parse_row(self, row):
        return os.path.join(self.data_dir, row["image_path"]), row["class_name"]


class ImageNetDataset(_CsvImageDataset):
    """ImageNet JPEGs over ``image_path,target_synset,class_name`` CSVs: the
    class name with ``return_synset``, else the target synset's index."""

    decode = staticmethod(read_image)

    def _parse_row(self, row):
        image_path = os.path.join(self.data_dir, row["image_path"])
        return image_path, row["class_name" if self.return_synset else "target_synset"]


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
