"""Continuous-batching request front (counterpart of
multimodal_concept_learning_tpu/serve/continuous.py:``ContinuousBatcher``).

Host code: requests admit into free slots as they arrive (one batched
prefill per group), one engine ``step`` advances every in-flight request,
and each request retires on EOS, its token budget or a stop string.  With
the paged engine, admission takes only the FIFO prefix whose KV pages fit
(``admissible_prefix``) and finished requests release their pages.  The
dense and chunked-prefill engines are not ported yet (ROADMAP.md), so the
chunked-admission hooks of the JAX front are absent.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from multimodal_concept_learning_tpu_torch.serve.engine import (
    LatencyTracker,
    _Pending,
    truncate_at_stops,
)


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
        return {**self.stats, "queued": self._q.qsize(),
                "in_flight": sum(s is not None for s in self._slots),
                **self.latency.summary()}

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
        self.engine.release(i)

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
                    self.engine.release(i)
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
            if incoming:
                k = eng.admissible_prefix([r.prompt for r in incoming])
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
                    s = _Slot(r)
                    self._slots[slot_i] = s
                    self.stats["admissions"] += 1
                    s.tokens.append(first)
                    self._emit(s, first)
                    if self._done(s, first):
                        self._finish(slot_i)
            if self._stop:
                break
            active = np.asarray([s is not None for s in self._slots], bool)
            if not active.any():
                continue
            try:
                toks = eng.step(active)  # [slots, steps_per_call]
            except Exception as e:  # noqa: BLE001
                self._fail_all(e)
                break
            self.stats["steps"] += 1
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                for t in toks[i]:
                    s.tokens.append(int(t))
                    self._emit(s, int(t))
                    if self._done(s, int(t)):
                        self._finish(i)
                        break


__all__ = ["ContinuousBatcher"]
