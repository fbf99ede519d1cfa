"""Shared trainer utilities: resume and graceful preemption (counterpart of
multimodal_concept_learning_tpu/train/common.py).

``ResumeManager`` (the ``resume: true`` YAML key) saves the whole training
state at each epoch's end under ``results_dir/resume/step_{epoch}.pt``
(``checkpoint_io``), beside ``loop_meta.json`` with the JAX keys
(``best_loss``; after a preemption ``preempt_epoch`` and
``step_in_epoch``), and restores the newest on start.  The state is the
JAX ``TrainState``'s counterpart: the model's state dict (frozen tensors
included, in their storage dtypes), the ``Optimizer``'s ``state_dict``
(moments, float32 masters, the accumulator and both counters, so a
preemption between the micro-steps of one accumulation resumes exactly),
the micro-step count and, for the vision classifier, the dropout
generator's state.  The JAX classifier's dropout key is
``fold_in(rng, step)``, stateless; the port draws from one stateful
``torch.Generator``, which the checkpoint therefore carries, so a resumed
run draws the masks of the uninterrupted one.

``PreemptionGuard`` turns SIGTERM into a flag that the epoch loops poll
after each step; a preempted loop saves a mid-epoch checkpoint (waiting
for it) and the CLI's ``main`` returns ``{"preempted": True}``.  A rerun
with ``resume: true`` restarts that epoch and skips the batches already
applied (the loader replays an epoch deterministically through
``set_epoch``).  As in JAX, nothing re-seeds the MLLM collator's question
stream (``data/collator.py``): a resumed MLLM run draws the yes/no
questions a fresh process draws (ROADMAP.md, queue C).

Under a process group (``parallel/multihost.py``) rank 0 alone writes the
checkpoints and the loop meta; on restore it picks the step and broadcasts
it, and every rank loads that step (the JAX ``orbax_io`` restore agrees on
the step the same way).  ``PreemptionGuard.agreed()`` makes a SIGTERM to
any one rank stop every rank at the same step (an all-reduce MAX each
step), where the JAX trainers poll their own process's flag.
``process_local_loader_args`` and ``mesh_for_batch`` are the JAX helpers
of the same names for one process per card: the world size must divide
the batch (the JAX mesh shrinks to a divisor instead).
"""

from __future__ import annotations

import json
import os
import signal
import threading

import torch

from multimodal_concept_learning_tpu_torch.checkpoint_io import (
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from multimodal_concept_learning_tpu_torch.parallel import multihost

_PREEMPTION_KEYS = ("preempt_epoch", "step_in_epoch", "skip_batches")


def process_local_loader_args(global_batch_size: int):
    """(local batch size, ``process_shard``) for this rank's loaders: the
    global batch divided over the ranks, each loading its stripe; (the
    global size, None) in a single process.  ValueError when the world
    size does not divide the batch."""
    if not multihost.is_distributed():
        return global_batch_size, None
    nproc = multihost.world_size()
    if global_batch_size % nproc:
        raise ValueError(f"batch_size {global_batch_size} must divide across {nproc} processes")
    return global_batch_size // nproc, (multihost.rank(), nproc)


def mesh_for_batch(batch_size: int):
    """The 1-D data mesh over every rank (None in a single process); the
    world size must divide ``batch_size`` (ValueError)."""
    if not multihost.is_distributed():
        return None
    process_local_loader_args(batch_size)
    from multimodal_concept_learning_tpu_torch.parallel.mesh import make_mesh

    return make_mesh()


def epoch_metric_mean(values) -> float:
    """Mean of per-batch 0-d device tensors with one host sync (0.0 for none)."""
    if not values:
        return 0.0
    return float(torch.stack(list(values)).mean())


def epoch_batches(loader, skip: int):
    """An iterator over ``loader``'s current epoch past its first ``skip``
    batches (a mid-epoch resume: the restored state holds their updates).
    The skipped batches are loaded and collated, as JAX replays them, so the
    loader's and the collator's streams advance as in the preempted run."""
    batches = iter(loader)
    for _ in range(skip):
        next(batches, None)
    return batches


class PreemptionGuard:
    """SIGTERM -> ``self.preempted = True`` (and the previous handler, when
    it is a function).  Installed only from the main thread and when
    ``enabled``; ``close()`` puts the previous handler back."""

    def __init__(self, enabled: bool = True):
        self.preempted = False
        self._enabled = enabled and threading.current_thread() is threading.main_thread()
        if not self._enabled:
            return
        self._prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.preempted = True
            if callable(self._prev):
                self._prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)

    def agreed(self) -> bool:
        """``preempted`` on any rank (every rank must call it at the same
        step: an all-reduce under a process group); this process's flag
        otherwise, or when the guard is off."""
        if not self._enabled or not multihost.is_distributed():
            return self.preempted
        return multihost.any_rank(self.preempted)

    def close(self) -> None:
        if self._enabled:
            signal.signal(signal.SIGTERM, self._prev)
            self._enabled = False


def train_state_dict(state) -> dict:
    """A ``TrainState`` as the tensors and values a resume needs."""
    gen = state.generator
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": state.step, "generator": None if gen is None else gen.get_state()}


def load_train_state_(state, saved: dict):
    """Copy ``saved`` (``train_state_dict``'s output, on the CPU) into
    ``state`` in place, on its model's device; returns ``state``."""
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    if (saved["generator"] is None) != (state.generator is None):
        raise ValueError("the checkpoint's dropout generator does not match this run's")
    if state.generator is not None:
        state.generator.set_state(saved["generator"])
    return state


class ResumeManager:
    """Epoch-granular resume under ``results_dir/resume`` (enabled by the
    ``resume`` YAML key; a no-op otherwise)."""

    def __init__(self, results_dir: str, enabled: bool):
        self.enabled = enabled
        self.ckpt_dir = os.path.join(results_dir, "resume")
        self.meta_path = os.path.join(self.ckpt_dir, "loop_meta.json")

    def restore(self, state):
        """(state, start epoch, meta): the newest checkpoint copied into
        ``state`` (in place); meta holds e.g. ``best_loss``, and
        ``skip_batches`` after a mid-epoch preemption."""
        if not self.enabled:
            return state, 0, {}
        saved, epoch = (restore_checkpoint(self.ckpt_dir) if multihost.is_main_process()
                        else (None, None))
        if multihost.is_distributed():  # rank 0 picks the step, every rank loads it
            epoch = multihost.broadcast(epoch)
            if epoch is not None and saved is None:
                saved, _ = restore_checkpoint(self.ckpt_dir, epoch)
        if saved is None:
            return state, 0, {}
        meta = {}
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
        if meta.get("preempt_epoch") == epoch:
            # mid-epoch preemption checkpoint: restart THIS epoch, skipping
            # the batches whose updates are already in the restored state
            start_epoch = epoch
            meta["skip_batches"] = int(meta.get("step_in_epoch", 0))
            print(f"Resuming from epoch {epoch} checkpoint in {self.ckpt_dir} "
                  f"(mid-epoch: skipping {meta['skip_batches']} batches)")
        else:
            start_epoch = epoch + 1
            meta.pop("skip_batches", None)
            print(f"Resuming from epoch {epoch} checkpoint in {self.ckpt_dir}")
        return load_train_state_(state, saved), start_epoch, meta

    def save(self, state, epoch: int, meta: dict) -> None:
        """Checkpoint ``state`` as epoch ``epoch`` (written in the
        background) and write the loop meta without preemption keys.  A
        kill mid-save leaves only a temporary file, so a resume takes the
        previous epoch; the meta may then be one epoch ahead, which only
        affects the remembered best_loss.  Rank 0 alone writes."""
        if not self.enabled or not multihost.is_main_process():
            return
        save_checkpoint(self.ckpt_dir, train_state_dict(state), epoch)
        meta = {k: v for k, v in meta.items() if k not in _PREEMPTION_KEYS}
        with open(self.meta_path, "w") as f:
            json.dump(meta, f)

    def save_preempted(self, state, epoch: int, step_in_epoch: int, meta: dict) -> bool:
        """Durable mid-epoch checkpoint for a graceful preemption exit, and
        JAX's "Preempted (SIGTERM)" line.  The meta goes first: a save torn
        by the hard kill that follows leaves a ``preempt_epoch`` that matches
        no finished step, which ``restore`` ignores.  Waits until the
        checkpoint is on disk (on every rank: rank 0 writes it)."""
        if not self.enabled:
            return False
        if multihost.is_main_process():
            os.makedirs(self.ckpt_dir, exist_ok=True)
            with open(self.meta_path, "w") as f:
                json.dump({**meta, "preempt_epoch": epoch, "step_in_epoch": int(step_in_epoch)},
                          f)
            save_checkpoint(self.ckpt_dir, train_state_dict(state), epoch, wait=True)
        multihost.barrier()
        print(f"Preempted (SIGTERM): saved mid-epoch checkpoint "
              f"(epoch {epoch + 1}, batch {step_in_epoch}); exiting")
        return True

    def finalize(self) -> None:
        """Wait for the save in flight (once, after the epoch loop)."""
        if self.enabled:
            wait_for_checkpoints()


__all__ = ["PreemptionGuard", "ResumeManager", "epoch_batches", "epoch_metric_mean",
           "load_train_state_", "mesh_for_batch", "process_local_loader_args",
           "train_state_dict"]
