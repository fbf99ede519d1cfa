"""Resume checkpoints with ``torch.save`` (counterpart of
multimodal_concept_learning_tpu/checkpoint/orbax_io.py).

``save_checkpoint(directory, state, step)`` writes ``directory/step_{step}.pt``:
the state (nested dicts of tensors and plain values) is copied to host
memory at once, so the caller may go on changing its tensors, and written
on a background thread, as orbax commits on one.  At most one save is in
flight: a new save, ``restore_checkpoint`` and ``wait_for_checkpoints``
first wait for the previous one, and re-raise its error if it failed.  A
save writes a temporary name (``step_{step}.pt.tmp-<pid>``) and then
``os.replace``s it, so a save torn by a kill is never listed, restored or
kept (the next save deletes such leftovers); ``keep`` finished steps stay.
The in-flight save is the process's, as orbax's checkpointer is
process-wide, and a call touches no process group: under one, the
trainers choose the step to restore on rank 0 and broadcast it
(``train/common.py``), as the JAX package broadcasts it.  A sharded model
saves ``parallel.multihost.host_fetchable(model)`` from rank 0 and loads
the restored state with ``parallel.sharding_rules.load_full_state_dict``.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

_STEP = re.compile(r"^step_(\d+)\.pt$")
_PENDING: Optional[threading.Thread] = None
_ERRORS: list = []


def _to_host(node):
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    if isinstance(node, dict):
        return {k: _to_host(v) for k, v in node.items()}
    return node


def save_checkpoint(directory: str, state: Any, step: int, keep: int = 3, wait: bool = False):
    """Write ``directory/step_{step}.pt`` in the background (``wait=True``:
    return once it is on disk).  Steps beyond the newest ``keep`` are
    deleted, only ever finished ones."""
    global _PENDING
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    wait_for_checkpoints()  # at most one save in flight
    _gc_old(directory, keep - 1)  # make room; this save is not listed yet
    host = _to_host(state)
    path = os.path.join(directory, f"step_{step}.pt")
    tmp = f"{path}.tmp-{os.getpid()}"

    def write():
        try:
            torch.save(host, tmp)
            os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 - re-raised by wait_for_checkpoints
            _ERRORS.append(e)

    _PENDING = threading.Thread(target=write, name=f"checkpoint-step-{step}", daemon=True)
    _PENDING.start()
    if wait:
        wait_for_checkpoints()


def wait_for_checkpoints() -> None:
    """Wait for the save in flight, if any; raise its error if it failed."""
    global _PENDING
    if _PENDING is not None:
        _PENDING.join()
        _PENDING = None
    if _ERRORS:
        err = _ERRORS.pop()
        _ERRORS.clear()
        raise RuntimeError("a background checkpoint save failed") from err


def restore_checkpoint(directory: str, step: Optional[int] = None):
    """(state on the CPU, step) of the newest step (or ``step``) in
    ``directory``; (None, None) when there is none."""
    directory = os.path.abspath(directory)
    wait_for_checkpoints()
    steps = _list_steps(directory)
    if not steps:
        return None, None
    target = step if step is not None else max(steps)
    path = os.path.join(directory, f"step_{target}.pt")
    return torch.load(path, map_location="cpu", weights_only=True), target


def _list_steps(directory: str):
    """The finished steps in ``directory`` (temporary names are not)."""
    if not os.path.isdir(directory):
        return []
    return [int(m.group(1)) for m in map(_STEP.match, os.listdir(directory)) if m]


def _gc_old(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` finished steps, and any temporary
    file a torn save left (no save of this process is in flight)."""
    steps = sorted(_list_steps(directory))
    drop = steps[:-keep] if keep > 0 else steps
    names = [f"step_{s}.pt" for s in drop]
    names += [n for n in os.listdir(directory) if n.startswith("step_") and ".pt.tmp-" in n]
    for name in names:
        try:
            os.remove(os.path.join(directory, name))
        except FileNotFoundError:
            pass


__all__ = ["restore_checkpoint", "save_checkpoint", "wait_for_checkpoints"]
