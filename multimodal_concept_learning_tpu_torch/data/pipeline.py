"""Host input pipeline (counterpart of multimodal_concept_learning_tpu/data/pipeline.py).

``BatchLoader`` yields the JAX loader's batches (by default
``default_classification_collate``'s {images | images_u8, labels}): the
same per-epoch shuffle (``PCG64([seed, epoch])``), fixed batch size,
``drop_last`` for training, and for evaluation a final partial batch padded
by wrapping and flagged by ``valid``.  Samples are decoded and transformed
by a thread pool and collated on a background thread ``prefetch_batches``
ahead; a random transform's draws are made in sample order on that thread
(``Compose.draw``), so a seed gives the JAX loader's batches whatever the
number of workers.  With ``uint8_images`` and a
ToTensor[+Normalize] transform, images stay uint8 [H, W, 3] and the batch
carries ``norm_mean`` / ``norm_std`` for the device to normalise
(``ops/preprocess.py``).  ``process_shard=(rank, n)`` is the JAX
loader's multi-process striping: every rank applies the same shuffle, forms
global batches of ``batch_size * n`` rows (the final one padded or dropped
as above) and yields only its own ``batch_size`` rows and their ``valid``.
``to_device`` moves a numpy batch to torch tensors on a device;
``prefetch_to_device`` (the JAX function of that name) does so for every
batch of an iterator, ``size`` batches ahead: on a CUDA device through
page-locked buffers filled on a helper thread and non-blocking copies on a
side stream, so the copy overlaps the step.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


def default_classification_collate(batch) -> Dict[str, np.ndarray]:
    """(image, label index) pairs -> {"images" float32 NCHW | "images_u8"
    uint8 NHWC (the device-normalize pipeline), "labels" int32}."""
    labels = np.asarray([b[1] for b in batch], dtype=np.int32)
    first = batch[0][0]
    if isinstance(first, np.ndarray) and first.dtype == np.uint8:
        return {"images_u8": np.stack([b[0] for b in batch]), "labels": labels}
    return {"images": np.stack([b[0] for b in batch]).astype(np.float32), "labels": labels}


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 collate_fn: Optional[Callable] = None, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0, prefetch_batches: int = 2,
                 uint8_images: bool = False, process_shard=None):
        if process_shard is not None:
            rank, nproc = process_shard
            if not 0 <= rank < nproc:
                raise ValueError(f"process_shard rank {rank} not in [0, {nproc})")
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or default_classification_collate
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self.uint8_images = uint8_images
        self._epoch = 0

    def _global_batch_size(self) -> int:
        return self.batch_size * (self.process_shard[1] if self.process_shard else 1)

    def __len__(self):
        n, gbs = len(self.dataset), self._global_batch_size()
        return n // gbs if self.drop_last else -(-n // gbs)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _index_batches(self):
        """[(indices, valid)] of the current epoch (this rank's stripes)."""
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:  # the same shuffle on every rank
            rng = np.random.Generator(np.random.PCG64([self.seed, self._epoch]))
            rng.shuffle(indices)
        gbs = self._global_batch_size()
        batches = []
        for start in range(0, n, gbs):
            chunk = indices[start:start + gbs]
            if len(chunk) < gbs:
                if self.drop_last:
                    break
                pad = np.resize(indices, gbs - len(chunk))
                valid = np.concatenate([np.ones(len(chunk), bool), np.zeros(len(pad), bool)])
                chunk = np.concatenate([chunk, pad])
            else:
                valid = np.ones(gbs, bool)
            if self.process_shard is not None:
                stripe = slice(self.process_shard[0] * self.batch_size,
                               (self.process_shard[0] + 1) * self.batch_size)
                chunk, valid = chunk[stripe], valid[stripe]
            batches.append((chunk, valid))
        return batches

    def _uint8_spec(self):
        if not self.uint8_images:
            return None
        spec = getattr(self.dataset.transform, "uint8_spec", None)
        return spec() if spec is not None else None

    def _samples(self, pool, load, chunk, spec) -> list:
        """The (image, label) samples of ``chunk``, decoded and transformed
        by the pool.  A random transform draws on this thread, sample by
        sample in order, from the decoded images' shapes (the JAX loader's
        sequential ``__getitem__`` order); the pool then applies the draws."""
        transform = getattr(self.dataset, "transform", None)
        if (spec is not None or not hasattr(transform, "draw")
                or not hasattr(self.dataset, "load_uint8")):
            return list(pool.map(load, (int(i) for i in chunk)))
        raw = list(pool.map(self.dataset.load_uint8, (int(i) for i in chunk)))
        plans = [transform.draw(image.shape) for image, _ in raw]
        return list(pool.map(lambda item, plan: (transform.apply(item[0], plan), item[1]),
                             raw, plans))

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
                        batch = self.collate_fn(self._samples(pool, load, chunk, spec))
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


def _host_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch's leaves as contiguous numpy arrays; a right-padded
    ``attention_mask`` also gets its ``kv_lens``, decided here on the host,
    so the model never reads the mask back from the device."""
    batch = dict(batch)
    if "attention_mask" in batch and "kv_lens" not in batch:
        lens = right_padded_lengths(np.asarray(batch["attention_mask"]))
        if lens is not None:
            batch["kv_lens"] = lens
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device`` (int32/bool/uint8/float
    dtypes kept, ``kv_lens`` added as ``_host_batch`` decides), copied
    synchronously."""
    return {k: torch.from_numpy(v).to(device) for k, v in _host_batch(batch).items()}


class _PinnedStager:
    """The CUDA side of ``prefetch_to_device``.  ``submit`` hands a host
    batch to one helper thread, which copies each leaf into a page-locked
    buffer and issues its copy to the card with ``non_blocking=True`` on a
    side stream, then records an event there; ``take`` makes the caller's
    current stream wait on that event and marks each device tensor as used
    on it (``record_stream``), so the caching allocator keeps its block
    until the step that reads it is done.  A buffer is reused only once the
    event of the copy that last read it has completed; buffers are kept by
    (shape, dtype), so a last, partial batch gets its own."""

    def __init__(self, device: torch.device, keep: int):
        self.device = device
        self.keep = keep  # buffers a (shape, dtype) before waiting for the oldest
        self.stream = torch.cuda.Stream(device)
        self.buffers: Dict[tuple, collections.deque] = {}  # helper thread only
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch_to_device")

    def _buffer(self, shape, dtype) -> torch.Tensor:
        ring = self.buffers.setdefault((tuple(shape), dtype), collections.deque())
        if ring and (len(ring) >= self.keep or ring[0][1].query()):
            buf, done = ring.popleft()
            done.synchronize()  # its last copy has read it
            return buf
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _stage(self, batch) -> tuple:
        out, used = {}, []
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for k, v in _host_batch(batch).items():
                src = torch.from_numpy(v)
                buf = self._buffer(src.shape, src.dtype)
                buf.copy_(src)
                out[k] = buf.to(self.device, non_blocking=True)
                used.append(buf)
            done = torch.cuda.Event()
            done.record(self.stream)
        for buf in used:
            self.buffers[(tuple(buf.shape), buf.dtype)].append((buf, done))
        return out, done

    def submit(self, batch) -> Future:
        return self.pool.submit(self._stage, batch)

    def take(self, staged: Future) -> Dict[str, torch.Tensor]:
        out, done = staged.result()
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in out.values():
            t.record_stream(stream)
        return out

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield each numpy batch of ``iterator`` as ``to_device`` would, its
    copy issued ``size`` batches ahead of the consumer (JAX
    ``data/pipeline.prefetch_to_device``, which ``device_put``s ahead).

    The pull order is JAX's: ``size`` batches are pulled first, then one
    more before each yield.  On a CUDA device the copies go through
    ``_PinnedStager`` (pinned buffers filled on a helper thread, a side
    stream, the consumer's stream made to wait); a failed pin or copy
    raises where its batch is yielded.  Elsewhere each batch is
    ``to_device``'s.  Closing the generator (a ``break``, a preemption's
    ``return``) closes ``iterator`` too, which stops a ``BatchLoader``'s
    thread."""
    device = torch.device(device)
    stager = _PinnedStager(device, keep=size + 2) if device.type == "cuda" else None
    put = stager.submit if stager else (lambda batch: to_device(batch, device))
    take = stager.take if stager else (lambda batch: batch)
    it = iter(iterator)
    buf = collections.deque()
    try:
        try:
            for _ in range(size):
                buf.append(put(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            try:
                buf.append(put(next(it)))
            except StopIteration:
                pass
            yield take(out)
    finally:
        if stager is not None:
            stager.close()
        close = getattr(it, "close", None)
        if close is not None:
            close()


__all__ = ["BatchLoader", "default_classification_collate", "prefetch_to_device",
           "right_padded_lengths", "to_device"]
