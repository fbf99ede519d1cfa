"""Slot-level continuous batching (counterpart of
multimodal_concept_learning_tpu/serve/continuous.py).

``ContinuousEngine`` keeps ONE persistent decode state of ``num_slots``
rows on the loaded model's device: per-layer dense KV caches
(``models/lm.init_kv_cache``, ``cache_len = prompt_t + max_new_tokens +
steps_per_call`` slots a row), ``seq_lens``, ``cache_mask`` and
``last_tok``, updated in place.

- **admission** (``admit_many``) prefills the admitted requests in one
  batched call at the power-of-two width of ``_staging_arrays`` (K1 in the
  ViT's and the LM's layers on the card) and copies their cache rows into
  the free slots;
- **step** (``step(active)``) advances every active row ``steps_per_call``
  tokens through ``CausalLM.decode_step`` under its ``cache_mask`` (K1 in
  every layer); inactive rows stay inert, and no row's mask reaches past
  ``cache_len - 1`` (the ``can_write`` guard: the last slot is the
  sacrificial write target of parked and finished rows);
- **completion** frees a slot at once for the next queued request.

On a multi-LoRA bank (``serve/loader.load_adapter_bank``) each slot keeps
its request's adapter id: admission prefills each row under its own
adapter and projector, and each step gathers the live slots' factors once
for its ``steps_per_call`` tokens (``ops/multi_lora.bank_rows``).

Across a device mesh (``mesh=``, JAX ``serve/continuous.py:55-140``) every
rank builds the engine over the same loaded model: the parameters take
the tensor-parallel layout (``parallel/sharding_rules.py``) on
``model_axis`` and the slots split over ``data_axis`` (each rank keeps
the persistent state of its ``num_slots / dp`` slots; the data-axis size
must divide ``num_slots``).  Each ``admit_many`` / ``step`` is collective:
rank 0 (where the ``ContinuousBatcher`` runs) broadcasts the call's
inputs, every rank runs its slots (a stripe with no admitted request
skips the prefill), and the first and step tokens are gathered over the
data axis; the other ranks serve in ``follow()`` until rank 0's
``close()``.  Each data stripe samples from its own generator (seeded
``seed + stripe``).  Multi-LoRA banks are refused under a mesh, as in JAX.

``ContinuousBatcher`` is the request front over any slot-level engine:
this one, the chunked-prefill engine (serve/chunked.py: admission returns
``None`` first tokens, ``advance_prefill`` completes them, prefilling
slots sit out the step) and the paged engine (serve/paged.py: page
backpressure through ``admissible_prefix``, ``release`` frees pages).
Requests retire on EOS, their token budget or a stop string.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.models.lm import init_kv_cache
from multimodal_concept_learning_tpu_torch.ops.lora import adapter_rows
from multimodal_concept_learning_tpu_torch.ops.multi_lora import bank_rows
from multimodal_concept_learning_tpu_torch.ops.sampling import sample_logits
from multimodal_concept_learning_tpu_torch.parallel import collectives, multihost
from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import shard_params
from multimodal_concept_learning_tpu_torch.serve.engine import (
    EngineHostAPI,
    LatencyTracker,
    _Pending,
    truncate_at_stops,
)


class ContinuousEngine(EngineHostAPI):
    """Persistent-state decode engine over a loaded MLLM (serve/loader.py)."""

    def __init__(self, loaded, num_slots: int = 8, max_new_tokens: int = 8,
                 max_prompt_len: int = 64, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None, seed: int = 0,
                 steps_per_call: int = 1, mesh=None, data_axis: str = "data",
                 model_axis: str = "model", fsdp_axis: Optional[str] = None):
        self.mesh = mesh
        self._dp = None  # the data axis's group under a mesh
        self.slot0, self.local_slots = 0, num_slots
        if mesh is not None:
            if getattr(loaded, "num_adapters", 0):
                raise ValueError("mesh serving excludes multi-LoRA banks")
            dp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(data_axis, 1)
            assert num_slots % dp == 0, (
                f"the data-axis size {dp} must divide num_slots {num_slots}")
            shard_params(loaded.model, mesh, model_axis=model_axis, fsdp_axis=fsdp_axis)
            if data_axis in mesh.mesh_dim_names:
                self._dp = collectives.mesh_group(mesh, data_axis)
                self.local_slots = num_slots // dp
                self.slot0 = self._dp.index * self.local_slots
                seed = seed + self._dp.index
        self.loaded = loaded
        self.num_slots = num_slots
        self.max_new_tokens = max_new_tokens
        self.max_prompt_len = max_prompt_len
        tok = loaded.tokenizer
        self.eos_id = getattr(tok, "eos_token_id", None)
        self.pad_id = getattr(tok, "pad_token_id", 0) or 0
        self.nvt = loaded.config.num_vision_tokens
        self.prompt_t = self.nvt + max_prompt_len
        # rows may overshoot EOS inside a call; the cache is padded so the
        # overshoot never overflows it
        self.steps_per_call = steps_per_call
        self.cache_len = self.prompt_t + max_new_tokens + steps_per_call
        self._sampler = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        dev = self.device = loaded.device
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        local = self.local_slots
        self.caches = init_kv_cache(loaded.model.cfg.lm, local, self.cache_len, dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.seq_lens = torch.zeros((local,), **i32)
        self.cache_mask = torch.zeros((local, self.cache_len), **i32)
        self.last_tok = torch.zeros((local,), **i32)
        self.decode_steps = 0  # decode_step calls (one per pass of the layer stack)
        # multi-LoRA bank: each slot's adapter id (host side)
        self.num_adapters = getattr(loaded, "num_adapters", 0)
        self.adapter_ids = np.zeros((num_slots,), np.int32)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self._generator, **self._sampler)

    def _check_requests(self, requests) -> list:
        if not 0 < len(requests) <= self.num_slots:
            raise ValueError(f"admit 1..{self.num_slots} requests, got {len(requests)}")
        requests = [r if len(r) == 4 else (*r, 0) for r in requests]
        if any(a for *_, a in requests) and not self.num_adapters:
            raise ValueError("engine has no adapter bank (load_adapter_bank)")
        for *_, a in requests:
            if not 0 <= a < max(self.num_adapters, 1):
                raise ValueError(f"adapter {a} out of range")
        return requests

    def _rows(self, adapter_ids, projector: bool = True) -> dict:
        """``adapter_rows``' argument for rows under ``adapter_ids`` (empty
        without a bank: every module keeps its own weights)."""
        if not self.num_adapters:
            return {}
        idx = torch.as_tensor(np.asarray(adapter_ids, np.int64)).to(self.device)
        return bank_rows(self.loaded.model, self.loaded.bank, idx, projector=projector)

    def _collective(self, call: str, *args):
        """Under a mesh, rank 0 sends the call to the followers first."""
        if self.mesh is not None:
            multihost.broadcast((call, args))
        return getattr(self, "_" + call + "_here")(*args)

    def follow(self) -> None:
        """A follower rank's loop under a mesh: run each call rank 0
        broadcasts until its ``close()``."""
        while True:
            call, args = multihost.broadcast(None)
            if call == "close":
                return
            getattr(self, "_" + call + "_here")(*args)

    def close(self) -> None:
        """Rank 0 under a mesh: release the followers (a no-op otherwise)."""
        if self.mesh is not None:
            multihost.broadcast(("close", ()))

    def _gather_slots(self, local: torch.Tensor) -> torch.Tensor:
        """[local_slots, ...] of every data stripe -> [num_slots, ...]."""
        if self._dp is None:
            return local
        return collectives.all_gather(local, self._dp, 0)

    def admit_many(self, requests) -> List[int]:
        """Install up to ``num_slots`` requests with one batched prefill.
        requests: (slot, image, prompt[, adapter]) with distinct free slots
        (adapter: an id of the engine's bank, 0 without one).  Returns each
        request's first token."""
        requests = self._check_requests(requests)
        if self.mesh is not None:
            return self._collective("admit_mesh", requests)
        a, img, ids, mask, _ = self._staging_arrays(requests)
        aidx = np.zeros((a,), np.int32)
        for i, (slot, *_, adapter) in enumerate(requests):
            aidx[i] = self.adapter_ids[slot] = adapter
        return self._admit([slot for slot, *_ in requests], img, ids, mask, aidx)

    def _admit_mesh_here(self, requests) -> List[int]:
        """This rank's slots of an admission, then every slot's first
        token gathered over the data axis (-1 where none was admitted)."""
        lo, hi = self.slot0, self.slot0 + self.local_slots
        mine = [(slot - lo, *rest) for slot, *rest in requests if lo <= slot < hi]
        firsts = torch.full((self.local_slots,), -1, dtype=torch.int32, device=self.device)
        if mine:
            _, img, ids, mask, _ = self._staging_arrays(mine)
            got = self._admit([slot for slot, *_ in mine], img, ids, mask,
                              np.zeros((len(ids),), np.int32))
            firsts[[slot for slot, *_ in mine]] = torch.tensor(got, dtype=torch.int32,
                                                               device=self.device)
        every = self._gather_slots(firsts).cpu()
        return [int(every[slot]) for slot, *_ in requests]

    @torch.inference_mode()
    def _admit(self, slots, img, ids, mask, aidx) -> List[int]:
        dev, model = self.device, self.loaded.model
        img, ids, mask = (torch.from_numpy(x).to(dev) for x in (img, ids, mask))
        a, t = ids.shape
        small = init_kv_cache(model.cfg.lm, a, t, dev)
        plens = mask.sum(dim=1).to(torch.int32)
        with adapter_rows(self._rows(aidx)):
            hidden = model.prefill(img, ids, mask, small, kv_lens=plens)
        last = hidden[torch.arange(a, device=dev), (plens.long() - 1).clamp(min=0)]
        firsts = self._sample(model.language_model.lm_head(last))
        n = len(slots)
        sl = torch.tensor(slots, dtype=torch.long, device=dev)
        for big, sm in zip(self.caches, small):
            for part in ("k", "v"):
                big[part][sl, :t] = sm[part][:n]
        row_masks = torch.zeros((n, self.cache_len), dtype=torch.int32, device=dev)
        row_masks[:, :t] = mask[:n]
        self.cache_mask[sl] = row_masks
        self.seq_lens[sl] = plens[:n]
        self.last_tok[sl] = firsts[:n]
        return [int(x) for x in firsts[:n].cpu()]

    def step(self, active: np.ndarray) -> np.ndarray:
        """One decode call for all slots; returns [num_slots, steps_per_call]
        new tokens (tokens past a row's EOS are overshoot: callers cut)."""
        return self._collective("step", np.asarray(active, bool))

    @torch.inference_mode()
    def _step_here(self, active: np.ndarray) -> np.ndarray:
        lm = self.loaded.model.language_model
        active = active[self.slot0:self.slot0 + self.local_slots]
        active = torch.as_tensor(np.asarray(active, bool)).to(self.device)
        rows = torch.arange(self.local_slots, device=self.device)
        toks = []
        lora_rows = self._rows(self.adapter_ids, projector=False)  # once for the whole call
        for _ in range(self.steps_per_call):
            can_write = active & (self.seq_lens < self.cache_len - 1)
            pos = self.seq_lens.long()
            self.cache_mask[rows, pos] = torch.maximum(self.cache_mask[rows, pos],
                                                       can_write.to(torch.int32))
            with adapter_rows(lora_rows):
                hidden = lm.decode_step(lm.embed(self.last_tok[:, None]), self.caches,
                                        self.seq_lens, self.cache_mask)
            self.decode_steps += 1
            nxt = self._sample(lm.lm_head(hidden[:, 0]))
            self.seq_lens += can_write.to(torch.int32)
            self.last_tok = torch.where(can_write, nxt, self.last_tok)
            toks.append(nxt)
        return self._gather_slots(torch.stack(toks, dim=1)).cpu().numpy()


class _Slot:
    __slots__ = ("pending", "tokens")

    def __init__(self, pending):
        self.pending = pending
        self.tokens: List[int] = []


class ContinuousBatcher:
    """Continuous-batching request front over a slot-level engine."""

    def __init__(self, engine):
        self.engine = engine
        self._q: "queue.Queue" = queue.Queue()
        self._slots: List[Optional[_Slot]] = [None] * engine.num_slots
        self.stats = {"requests": 0, "steps": 0, "admissions": 0}
        self.latency = LatencyTracker()
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, prompt: str, timeout: float = 300.0,
               on_token=None, adapter: int = 0, max_tokens=None, stop=None) -> str:
        """Blocking; ``on_token(token_id)`` streams each generated token as
        the decode loop produces it (called from the worker thread).
        ``max_tokens`` caps this request below the engine's budget and
        ``stop`` strings retire the slot early at detection."""
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
        out = {**self.stats, "queued": self._q.qsize(),
               "in_flight": sum(s is not None for s in self._slots),
               **self.latency.summary()}
        prefilling = getattr(self.engine, "prefilling_slots", None)
        if prefilling is not None:
            out["prefilling"] = len(prefilling)
        return out

    def shutdown(self):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=10)

    @staticmethod
    def _emit(s, tok: int):
        if s.pending.on_token is not None:
            try:
                s.pending.on_token(tok)
            except Exception:  # noqa: BLE001 — a bad stream sink can't kill decode
                s.pending.on_token = None

    def _finish(self, i: int):
        slot = self._slots[i]
        slot.pending.result = truncate_at_stops(
            self.engine.decode_text(slot.tokens), slot.pending.stop)
        slot.pending.event.set()
        self._slots[i] = None
        self.stats["requests"] += 1
        self._release(i)

    def _release(self, i: int):
        """Hand a retired slot back to an engine with reclaimable resources
        (the paged engine frees the slot's pages)."""
        rel = getattr(self.engine, "release", None)
        if rel is not None:
            rel(i)

    def _install_first(self, slot_i: int, first: int):
        """Record a request's first token (at admission, or when a chunked
        admission completes) and retire it if it is already done."""
        s = self._slots[slot_i]
        s.tokens.append(first)
        self._emit(s, first)
        if self._done(s, first):
            self._finish(slot_i)

    def _done(self, s, last_tok: int) -> bool:
        """EOS, the engine/request token budget, or a stop string in the
        decoded tail."""
        eng = self.engine
        if eng.eos_id is not None and last_tok == eng.eos_id:
            return True
        budget = eng.max_new_tokens
        if s.pending.max_tokens is not None:
            budget = min(budget, max(int(s.pending.max_tokens), 1))
        if len(s.tokens) >= budget:
            return True
        if s.pending.stop:
            text = eng.decode_text(s.tokens[-32:])
            return any(marker in text for marker in s.pending.stop)
        return False

    def _fail_all(self, e: Exception):
        """A device failure mid-step leaves the engine's in-place state
        undefined: fail every in-flight request and stop the worker."""
        for i, s in enumerate(self._slots):
            if s is not None:
                s.pending.error = e
                s.pending.event.set()
                self._slots[i] = None
                try:
                    self._release(i)
                except Exception:  # noqa: BLE001 — engine is already dead
                    pass
        self._stop = True

    def _worker(self):
        eng = self.engine
        held = []  # requests seen while no slot/pages were free (keeps FIFO)
        while not self._stop:
            # block when completely idle; otherwise drain without waiting
            idle = not held and all(s is None for s in self._slots)
            if held:
                nxt = held.pop(0)
            else:
                try:
                    nxt = self._q.get(block=idle)
                except queue.Empty:
                    nxt = None
            incoming = []
            n_free = self._slots.count(None)
            while nxt is not None:
                if len(incoming) >= n_free:
                    held.insert(0, nxt)  # no slot free: admit next iteration
                    break
                incoming.append(nxt)
                if held:
                    nxt = held.pop(0)
                else:
                    try:
                        nxt = self._q.get(block=False)
                    except queue.Empty:
                        nxt = None
            # page backpressure: admit only the FIFO prefix whose pages fit
            cap_fn = getattr(eng, "admissible_prefix", None)
            if incoming and cap_fn is not None:
                k = cap_fn([r.prompt for r in incoming])
                if k < len(incoming):
                    held[:0] = incoming[k:]
                    incoming = incoming[:k]
            if incoming:
                free_slots = [i for i, s in enumerate(self._slots) if s is None]
                batch = [(free_slots[i], r.image, r.prompt, r.adapter)
                         for i, r in enumerate(incoming)]
                try:
                    firsts = eng.admit_many(batch)
                except Exception as e:  # noqa: BLE001 — surface to the waiters
                    for r in incoming:
                        r.error = e
                        r.event.set()
                    incoming, firsts = [], []
                for (slot_i, *_), r, first in zip(batch, incoming, firsts):
                    self._slots[slot_i] = _Slot(r)
                    self.stats["admissions"] += 1
                    if first is not None:  # None: a chunked admission still prefilling
                        self._install_first(slot_i, first)
            if self._stop:
                break
            # chunked prefill: one admission chunk per loop, between decode
            # steps, so in-flight requests stall at most one chunk
            advance = getattr(eng, "advance_prefill", None)
            if advance is not None:
                try:
                    completions = advance()
                except Exception as e:  # noqa: BLE001 — same contract as step
                    self._fail_all(e)
                    break
                for slot_i, first in completions:
                    self._install_first(slot_i, first)
            prefilling = getattr(eng, "prefilling_slots", frozenset())
            active = np.asarray([s is not None and i not in prefilling
                                 for i, s in enumerate(self._slots)], bool)
            if not active.any():
                continue
            try:
                toks = eng.step(active)  # [slots, steps_per_call]
            except Exception as e:  # noqa: BLE001
                self._fail_all(e)
                break
            self.stats["steps"] += 1
            for i, s in enumerate(self._slots):
                if s is None or i in prefilling:  # a prefilling slot's row is not live yet
                    continue
                for t in toks[i]:
                    s.tokens.append(int(t))
                    self._emit(s, int(t))
                    if self._done(s, int(t)):
                        self._finish(i)
                        break


__all__ = ["ContinuousBatcher", "ContinuousEngine"]
