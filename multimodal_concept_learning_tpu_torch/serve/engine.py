"""Whole-batch serving engine and dynamic micro-batching (counterpart of
multimodal_concept_learning_tpu/serve/engine.py), plus the host-side
request plumbing every serving engine shares (``LatencyTracker``,
``EngineHostAPI``, ``_Pending``, ``truncate_at_stops``).

``ServingEngine`` keeps the JAX engine's fixed shape: every batch is
padded to ``batch_size`` rows and every prompt to ``max_prompt_len`` text
tokens (right-padded, the vision placeholders always attended), then one
generate call runs the whole batch on the loaded model's device: greedy or
sampled decoding over dense KV caches (``models/mllm.generate``; K1 in
every prefill and decode attention on the card, K5 in every decode
projection under ``--int4``), beam search (``models/beam.py``) or
self-speculative decoding (``models/speculative.py``).  On a multi-LoRA
bank (``serve/loader.load_adapter_bank``) each request names its adapter
and the batch generates through ``ops/multi_lora.multi_lora_generate``
(the same K1 path; the per-row adapter products run beside the base's).
Token budgets, EOS and stop strings are cut on the host.

``Batcher`` is the JAX dynamic-batching loop: the worker takes the first
queued request, waits up to ``max_wait_ms`` for more (up to
``batch_size``), runs the engine once and hands each row its text.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


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
    """Host-side plumbing of the serving engines.  Expects ``self.loaded``,
    ``eos_id``, ``pad_id`` and ``max_prompt_len``; ``_staging_arrays`` (the
    slot-level engines') also ``num_slots``, ``nvt`` and ``prompt_t``."""

    def preprocess_image(self, pil_image) -> np.ndarray:
        """PIL image (decoded by the HTTP image path, the only one that
        needs Pillow) -> [3, H, W] float array via the training's eval
        transform, on the image's uint8 RGB pixels."""
        transform = getattr(self, "_transform", None)
        if transform is None:
            from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

            cfg = self.loaded.config
            transform = self._transform = create_transforms(cfg, is_train=False, seed=cfg.seed)
        return np.asarray(transform(np.asarray(pil_image.convert("RGB"))), dtype=np.float32)

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
        self.adapter = adapter  # multi-LoRA adapter id (bank engines; 0 = raw base)
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


class ServingEngine(EngineHostAPI):
    """Batched text generation over a loaded MLLM (serve/loader.py), one
    generate call a batch on the model's device."""

    def __init__(self, loaded, batch_size: int = 8, max_new_tokens: int = 8,
                 max_prompt_len: int = 64, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None, seed: int = 0,
                 num_beams: int = 1, length_penalty: float = 0.0, draft_layers: int = 0,
                 draft_len: int = 4):
        from multimodal_concept_learning_tpu_torch.models.beam import beam_generate
        from multimodal_concept_learning_tpu_torch.models.mllm import generate
        from multimodal_concept_learning_tpu_torch.models.speculative import (
            speculative_generate,
        )
        from multimodal_concept_learning_tpu_torch.ops.multi_lora import multi_lora_generate

        self.loaded = loaded
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.max_prompt_len = max_prompt_len
        tok = loaded.tokenizer
        self.eos_id = getattr(tok, "eos_token_id", None)
        self.pad_id = getattr(tok, "pad_token_id", 0) or 0
        self.device = loaded.device
        self._generator = torch.Generator(device=loaded.device).manual_seed(seed)
        self._lock = threading.Lock()
        # multi-LoRA bank: requests pick adapters per row
        self.num_adapters = getattr(loaded, "num_adapters", 0)
        self.num_beams = num_beams
        self.draft_layers = draft_layers
        model = loaded.model
        common = dict(eos_id=self.eos_id, pad_id=self.pad_id)
        if draft_layers > 0:
            # greedy-only (the verify compares argmaxes), whole-model weights
            if num_beams > 1:
                raise ValueError("draft_layers excludes num_beams > 1 (the "
                                 "speculative verify is greedy argmax; beam "
                                 "search scores full candidate sets)")
            if temperature > 0.0 or top_k is not None or top_p is not None:
                raise ValueError("draft_layers implies greedy decoding — it "
                                 "excludes temperature/top_k/top_p sampling")
            if self.num_adapters:
                raise ValueError("draft_layers excludes multi-LoRA banks "
                                 "(the draft/verify chunk programs take a "
                                 "single param tree; serve a merged "
                                 "checkpoint instead)")
            n_layers = model.cfg.lm.num_layers
            if not 1 <= draft_layers <= n_layers:
                raise ValueError(f"draft_layers must be in [1, {n_layers}] "
                                 f"(the LM's layer count), got {draft_layers}")
            if draft_len < 2:
                raise ValueError(f"draft_len must be >= 2 (g-1 proposals per "
                                 f"verify dispatch), got {draft_len}")
            self._gen_fn = lambda img, ids, mask, aidx: speculative_generate(
                model, img, ids, mask, max_new_tokens, draft_layers=draft_layers,
                draft_len=draft_len, **common)
        elif num_beams > 1:
            # deterministic width-K search on B*K rows
            if temperature > 0.0 or top_k is not None or top_p is not None:
                raise ValueError("num_beams > 1 is deterministic — it "
                                 "excludes temperature/top_k/top_p sampling")
            if self.num_adapters:
                raise ValueError("num_beams > 1 excludes multi-LoRA banks "
                                 "(beam tiles the KV cache to B*K rows; the "
                                 "bank vmap does not compose — serve a "
                                 "merged checkpoint instead)")
            self._gen_fn = lambda img, ids, mask, aidx: beam_generate(
                model, img, ids, mask, max_new_tokens, num_beams,
                length_penalty=length_penalty, **common)
        else:
            sampler = dict(generator=self._generator, temperature=temperature, top_k=top_k,
                           top_p=top_p, **common)
            if self.num_adapters:
                self._gen_fn = lambda img, ids, mask, aidx: multi_lora_generate(
                    model, loaded.bank, aidx, img, ids, mask, max_new_tokens=max_new_tokens,
                    **sampler)
            else:
                self._gen_fn = lambda img, ids, mask, aidx: generate(
                    model, img, ids, mask, max_new_tokens, **sampler)

    def _encode_prompts(self, prompts: Sequence[str]):
        nvt = self.loaded.config.num_vision_tokens
        t = nvt + self.max_prompt_len
        ids = np.full((self.batch_size, t), self.pad_id, np.int32)
        mask = np.zeros((self.batch_size, t), np.int32)
        mask[:, :nvt] = 1  # vision placeholder tokens always attended
        for i, p in enumerate(prompts):
            enc = self.encode_prompt(p)
            ids[i, nvt:nvt + len(enc)] = enc
            mask[i, :nvt + len(enc)] = 1
        return ids, mask

    def _adapter_ids(self, adapters: Optional[Sequence[int]]) -> np.ndarray:
        """Each row's adapter id [batch_size] (padding rows 0), with the JAX
        engine's checks."""
        aidx = np.zeros((self.batch_size,), np.int32)
        if self.num_adapters:
            for i, a in enumerate(adapters if adapters is not None else []):
                if not 0 <= a < self.num_adapters:
                    raise ValueError(f"adapter {a} out of range")
                aidx[i] = a
        elif adapters is not None and any(adapters):
            raise ValueError("engine has no adapter bank (load_adapter_bank)")
        return aidx

    def generate_tokens(self, images: Sequence[np.ndarray], prompts: Sequence[str],
                        adapters: Optional[Sequence[int]] = None) -> np.ndarray:
        """The raw tokens [n, max_new_tokens] of one padded batch (``pad_id``
        after a row's EOS); ``len(prompts) <= batch_size``; ``adapters``:
        each request's adapter id (bank engines).  Thread-safe."""
        n = len(prompts)
        if not (n == len(images) and 0 < n <= self.batch_size):
            raise ValueError(f"generate takes 1..{self.batch_size} (image, prompt) pairs, "
                             f"got {len(images)} images and {n} prompts")
        aidx = self._adapter_ids(adapters)
        size = self.loaded.config.image_size
        img = np.zeros((self.batch_size, 3, size, size), np.float32)
        for i, a in enumerate(images):
            img[i] = a
        ids, mask = self._encode_prompts(prompts)
        with self._lock:
            out = self._gen_fn(*(torch.from_numpy(x).to(self.device)
                                 for x in (img, ids, mask, aidx)))
            return out[:n].cpu().numpy()

    def generate(self, images: Sequence[np.ndarray], prompts: Sequence[str],
                 adapters: Optional[Sequence[int]] = None,
                 max_tokens: Optional[Sequence[Optional[int]]] = None,
                 stop: Optional[Sequence] = None) -> List[str]:
        """One answer per (image, prompt).  ``images``: preprocessed [3, H, W]
        arrays; ``max_tokens``: per-request budgets (the batch still decodes
        the engine's whole budget; the cut is on the host); ``stop``:
        per-request stop-string lists; ``adapters``: per-request adapter ids
        (bank engines; default 0, the raw base; a bankless engine refuses any
        other).  Thread-safe."""
        texts = []
        for i, row in enumerate(self.generate_tokens(images, prompts, adapters)):
            if max_tokens is not None and max_tokens[i] is not None:
                row = row[: max(int(max_tokens[i]), 1)]
            text = self.decode_text(row)
            if stop is not None:
                text = truncate_at_stops(text, stop[i])
            texts.append(text)
        return texts


class Batcher:
    """Dynamic micro-batching front of a ServingEngine."""

    def __init__(self, engine: ServingEngine, max_wait_ms: float = 20.0):
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0}
        self.latency = LatencyTracker()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, prompt: str, timeout: float = 300.0,
               on_token=None, adapter: int = 0, max_tokens=None, stop=None) -> str:
        """Blocking: enqueue and wait for the generated text.  ``on_token``
        is accepted as the continuous front takes it but never fires
        mid-generation (the batch decodes in one engine call)."""
        p = _Pending(image, prompt, on_token, adapter, max_tokens, stop)
        t0 = time.monotonic()
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("generation timed out")
        if p.error is not None:
            raise p.error
        self.latency.record(time.monotonic() - t0)
        return p.result

    def metrics(self) -> dict:
        return {**self.stats, "queued": self._q.qsize(), **self.latency.summary()}

    def shutdown(self):
        self._stop = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=10)

    def _worker(self):
        while not self._stop:
            first = self._q.get()
            if first is None:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.engine.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            try:
                texts = self.engine.generate(
                    [p.image for p in batch], [p.prompt for p in batch],
                    adapters=[p.adapter for p in batch],
                    max_tokens=[p.max_tokens for p in batch],
                    stop=[p.stop for p in batch])
                for p, t in zip(batch, texts):
                    p.result = t
            except Exception as e:  # noqa: BLE001 — surface to every waiter
                for p in batch:
                    p.error = e
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            for p in batch:
                p.event.set()


__all__ = ["Batcher", "EngineHostAPI", "LatencyTracker", "ServingEngine",
           "truncate_at_stops"]
