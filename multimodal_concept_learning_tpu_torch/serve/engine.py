"""Host-side request plumbing shared by the serving engines (counterpart of
multimodal_concept_learning_tpu/serve/engine.py: ``LatencyTracker``,
``EngineHostAPI``, ``_Pending``, ``truncate_at_stops``).

The whole-batch ``ServingEngine``/``Batcher`` front is not ported yet
(ROADMAP.md); the port serves through the paged continuous front.
"""

from __future__ import annotations

import collections
import threading
from typing import List

import numpy as np


class LatencyTracker:
    """Sliding-window request-latency summary for the /metrics endpoint
    (count and p50/p95/p99 over the last ``window`` requests).  Thread-safe."""

    def __init__(self, window: int = 512):
        self._lat = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0

    def record(self, seconds: float):
        with self._lock:
            self._lat.append(seconds)
            self._count += 1

    def summary(self) -> dict:
        with self._lock:
            lat = list(self._lat)
            count = self._count
        out = {"completed": count, "window": len(lat)}
        if lat:
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            out.update(
                latency_p50_ms=round(float(p50) * 1e3, 1),
                latency_p95_ms=round(float(p95) * 1e3, 1),
                latency_p99_ms=round(float(p99) * 1e3, 1),
                latency_mean_ms=round(float(np.mean(lat)) * 1e3, 1),
            )
        return out


class EngineHostAPI:
    """Host-side plumbing of the slot-level engines.  Expects ``self.loaded``,
    ``eos_id``, ``pad_id``, ``max_prompt_len``, ``num_slots``, ``nvt`` and
    ``prompt_t``."""

    def preprocess_image(self, pil_image) -> np.ndarray:
        """PIL image -> [3, H, W] float array via the training's eval
        transform (built on first use: it needs Pillow, which only the HTTP
        image path does)."""
        transform = getattr(self, "_transform", None)
        if transform is None:
            from multimodal_concept_learning_tpu.data.transforms import create_transforms

            cfg = self.loaded.config
            transform = self._transform = create_transforms(cfg, is_train=False, seed=cfg.seed)
        return np.asarray(transform(pil_image.convert("RGB")), dtype=np.float32)

    def encode_prompt(self, prompt: str):
        """Tokenize + truncate a prompt (memoized — the paged front sizes
        pages from the same encoding it later admits with)."""
        cache = getattr(self, "_encode_cache", None)
        if cache is None:
            cache = self._encode_cache = {}
        ids = cache.get(prompt)
        if ids is None:
            ids = tuple(self.loaded.tokenizer.encode(prompt)[: self.max_prompt_len])
            if len(cache) > 1024:  # bound the memo on adversarial traffic
                cache.clear()
            cache[prompt] = ids
        return ids

    def _staging_arrays(self, requests):
        """Admission arrays at a power-of-two width ``a``: zeroed image
        batch, pad-filled ids, attention mask, and each request's true
        prompt length.  ``requests`` rows are (slot, image, prompt[, ...])."""
        cfg = self.loaded.config
        a = 1
        while a < len(requests):
            a *= 2
        a = min(a, self.num_slots)
        img = np.zeros((a, 3, cfg.image_size, cfg.image_size), np.float32)
        ids = np.full((a, self.prompt_t), self.pad_id, np.int32)
        mask = np.zeros((a, self.prompt_t), np.int32)
        plens = []
        for i, (_, image, prompt, *_rest) in enumerate(requests):
            img[i] = image
            enc = self.encode_prompt(prompt)
            ids[i, self.nvt:self.nvt + len(enc)] = enc
            mask[i, : self.nvt + len(enc)] = 1
            plens.append(self.nvt + len(enc))
        return a, img, ids, mask, plens

    def decode_text(self, token_ids: List[int]) -> str:
        row = list(token_ids)
        if self.eos_id is not None and self.eos_id in row:
            row = row[: row.index(self.eos_id)]
        return self.loaded.tokenizer.decode(
            [int(x) for x in row if int(x) >= 0], skip_special_tokens=True
        ).strip()


class _Pending:
    __slots__ = ("image", "prompt", "event", "result", "error", "on_token",
                 "adapter", "max_tokens", "stop")

    def __init__(self, image, prompt, on_token=None, adapter=0,
                 max_tokens=None, stop=None):
        self.image = image
        self.prompt = prompt
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.on_token = on_token  # streaming hook: each raw token id as produced
        self.adapter = adapter  # multi-LoRA adapter id (0 = base; banks not ported)
        self.max_tokens = max_tokens  # per-request token budget (<= the engine's)
        self.stop = stop  # stop strings: earliest occurrence truncates


def truncate_at_stops(text: str, stop) -> str:
    """Cut ``text`` at the earliest occurrence of any stop string."""
    if not stop:
        return text
    cut = len(text)
    for marker in stop:
        idx = text.find(marker)
        if idx >= 0:
            cut = min(cut, idx)
    return text[:cut].strip()


__all__ = ["EngineHostAPI", "LatencyTracker", "truncate_at_stops"]
