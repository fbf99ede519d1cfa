"""Host input pipeline (counterpart of multimodal_concept_learning_tpu/data/pipeline.py).

``BatchLoader`` yields the JAX loader's batches: the same per-epoch shuffle
(``PCG64([seed, epoch])``), fixed batch size, ``drop_last`` for training,
and for evaluation a final partial batch padded by wrapping and flagged by
``valid``.  Samples are decoded by a thread pool and collated on a
background thread ``prefetch_batches`` ahead.  With ``uint8_images`` and a
ToTensor[+Normalize] transform, images stay uint8 [H, W, 3] and the batch
carries ``norm_mean`` / ``norm_std`` for the device to normalise
(``ops/preprocess.py``).  ``to_device`` moves a numpy batch to torch
tensors on a device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0, prefetch_batches: int = 2,
                 uint8_images: bool = False):
        if collate_fn is None:
            raise ValueError("BatchLoader needs a collate_fn (the multimodal collator)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self.uint8_images = uint8_images
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _index_batches(self):
        """[(indices, valid)] of the current epoch."""
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.Generator(np.random.PCG64([self.seed, self._epoch]))
            rng.shuffle(indices)
        batches = []
        for start in range(0, n, self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    break
                pad = np.resize(indices, self.batch_size - len(chunk))
                valid = np.concatenate([np.ones(len(chunk), bool), np.zeros(len(pad), bool)])
                chunk = np.concatenate([chunk, pad])
            else:
                valid = np.ones(self.batch_size, bool)
            batches.append((chunk, valid))
        return batches

    def _uint8_spec(self):
        if not self.uint8_images:
            return None
        spec = getattr(self.dataset.transform, "uint8_spec", None)
        return spec() if spec is not None else None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        spec = self._uint8_spec()
        load = self.dataset.load_uint8 if spec is not None else self.dataset.__getitem__
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        done = object()
        errors = []
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for chunk, valid in batches:
                        if stop.is_set():
                            return
                        batch = self.collate_fn(list(pool.map(load, (int(i) for i in chunk))))
                        batch["valid"] = valid
                        if spec is not None:
                            batch["norm_mean"], batch["norm_std"] = spec
                        out_q.put(batch)
            except Exception as e:  # noqa: BLE001 - re-raised in the consumer
                errors.append(e)
            finally:
                out_q.put(done)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = out_q.get()
                if item is done:
                    break
                yield item
        finally:
            stop.set()
            while worker.is_alive():  # unblock a producer waiting on a full queue
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            worker.join()
        if errors:
            raise errors[0]


def right_padded_lengths(mask: np.ndarray) -> Optional[np.ndarray]:
    """The row lengths [B] int32 of a [B, T] 1/0 mask that is ones then
    zeros in every row; None for any other mask."""
    lens = mask.sum(axis=1).astype(np.int32)
    expect = np.arange(mask.shape[1])[None, :] < lens[:, None]
    return lens if np.array_equal(mask.astype(bool), expect) else None


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device`` (int32/bool/uint8/float
    dtypes kept).  A right-padded ``attention_mask`` also gets its
    ``kv_lens``, decided here on the host, so the model never reads the
    mask back from the device."""
    batch = dict(batch)
    if "attention_mask" in batch and "kv_lens" not in batch:
        lens = right_padded_lengths(np.asarray(batch["attention_mask"]))
        if lens is not None:
            batch["kv_lens"] = lens
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


__all__ = ["BatchLoader", "right_padded_lengths", "to_device"]
