"""Worker-process batch loader (counterpart of
multimodal_concept_learning_tpu/data/grain_pipeline.py).

The JAX ``GrainLoader`` puts the framework's map-style datasets and
collators on ``grain.python.DataLoader`` (multi-process workers, a seeded
shuffle).  The port keeps its contract (the constructor, ``set_epoch``,
``__len__``, a final partial batch padded by repetition and flagged by
``valid``, ``drop_last``) on ``torch.utils.data.DataLoader``: worker
processes load the samples in the sampler's order and the batches are
collated here.  With ``shuffle`` the order of epoch e is a permutation
drawn from a ``torch.Generator`` seeded with ``seed + e`` (the seed the
JAX loader gives Grain's sampler); Grain's own shuffle is not reproduced,
so only unshuffled batches equal the JAX loader's (ROADMAP.md, queue C).
``data.pipeline.BatchLoader`` stays the trainers' loader.

Usage:
    loader = GrainLoader(dataset, batch_size=64, shuffle=True, seed=0,
                         collate_fn=collator, num_workers=4)
    for batch in loader:  # dict with images/input_ids/.../valid
        ...
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.data.pipeline import default_classification_collate


class _SampleSource(torch.utils.data.Dataset):
    """Map-style view of a framework dataset (integer indices)."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, idx):
        return self._dataset[int(idx)]


def _as_is(sample):
    """The DataLoader's collate of one sample: none (batches are collated here)."""
    return sample


class GrainLoader:
    """Epoch-based batch iterator over ``torch.utils.data.DataLoader``
    worker processes (``num_workers`` 0 loads in this process)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False,
                 num_workers: int = 0, seed: int = 0,
                 multiprocessing_context: Optional[str] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or default_classification_collate
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.multiprocessing_context = multiprocessing_context
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def order(self) -> np.ndarray:
        """The sample indices of the current epoch, in loading order."""
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        gen = torch.Generator().manual_seed(self.seed + self._epoch)
        return torch.randperm(n, generator=gen).numpy()

    def __iter__(self):
        loader = torch.utils.data.DataLoader(
            _SampleSource(self.dataset), batch_size=None, sampler=self.order().tolist(),
            collate_fn=_as_is, num_workers=self.num_workers,
            multiprocessing_context=self.multiprocessing_context if self.num_workers else None)
        buf = []
        for sample in loader:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._finalize(buf, full=True)
                buf = []
        if buf and not self.drop_last:
            yield self._finalize(buf, full=False)

    def _finalize(self, samples, full: bool):
        n = len(samples)
        if not full:  # pad by repetition to keep fixed shapes; mask via `valid`
            samples = samples + [samples[i % n] for i in range(self.batch_size - n)]
        batch = self.collate_fn(samples)
        valid = np.zeros(self.batch_size, bool)
        valid[:n] = True
        batch["valid"] = valid
        return batch


__all__ = ["GrainLoader"]
