"""Deterministic seeding (counterpart of
multimodal_concept_learning_tpu/utils/seeding.py).

``set_seed`` seeds Python's ``random``, numpy's global state and torch's,
and returns a ``torch.Generator`` seeded the same (the JAX function
returns a root PRNG key).  ``host_rng(seed, *streams)`` is JAX's named
numpy stream: ``SeedSequence([seed] + one entry a stream name)``.  JAX
takes ``abs(hash(name)) % 2**31`` of each name, which for a string depends
on the process's hash salt (``PYTHONHASHSEED``), so its string-named
streams differ from process to process; the port hashes strings and bytes
with ``zlib.crc32`` instead, and keeps ``abs(name) % 2**31`` for integers,
where JAX's value is already stable (ROADMAP.md, queue C).
"""

from __future__ import annotations

import random
import zlib

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch's, and return a generator seeded ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def stream_entry(name) -> int:
    """A stream name's entry of the seed sequence, the same in every process."""
    if isinstance(name, int):
        return abs(name) % (2**31)
    data = name if isinstance(name, bytes) else str(name).encode()
    return zlib.crc32(data) % (2**31)


def host_rng(seed: int, *streams) -> np.random.Generator:
    """A named, collision-free numpy Generator for a host-side random stream."""
    ss = np.random.SeedSequence([seed] + [stream_entry(s) for s in streams])
    return np.random.Generator(np.random.PCG64(ss))


__all__ = ["host_rng", "set_seed", "stream_entry"]
