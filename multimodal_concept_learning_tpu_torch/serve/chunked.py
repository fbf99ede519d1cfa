"""Chunked prefill: admission that never stalls in-flight decodes for more
than one chunk (counterpart of multimodal_concept_learning_tpu/serve/chunked.py).

The dense continuous engine prefills a whole prompt in one call, and every
in-flight request's next token waits for it.  This engine splits admission
into bounded pieces that the batcher interleaves with decode steps:

1. **staging** (``admit_many``): the vision tower and the prompt
   embeddings of the admitted group in one batched call
   (``MLLM.prompt_embeds``), kept on the device; each slot is parked
   (``seq_lens`` at the sacrificial last slot, mask cleared) so the decode
   steps' unconditional writes cannot touch the rows the chunks fill;
2. **chunks** (``advance_prefill``): each call sends ONE ``chunk_size``
   slice of the oldest staged prompt through ``CausalLM.decode_chunk`` on
   that slot's cache row (a view, written in place): batch-1 work, K1 in
   every layer on the card;
3. **finish**: after the last chunk, the first token is sampled from the
   last real position's hidden state and the slot goes live (``seq_lens``,
   ``cache_mask``, ``last_tok``) for the ordinary decode loop.

Dense caches and one device, as the ContinuousEngine; a multi-LoRA bank is
refused, as JAX refuses it.
"""

from __future__ import annotations

import collections
import threading
from typing import List, Optional

import torch

from multimodal_concept_learning_tpu_torch.serve.continuous import ContinuousEngine


class ChunkedContinuousEngine(ContinuousEngine):
    """ContinuousEngine with chunked admission: ``admit_many`` returns None
    for each still-prefilling request and ``advance_prefill()`` yields
    (slot, first_token) completions."""

    def __init__(self, loaded, chunk_size: int = 64, **kwargs):
        if getattr(loaded, "num_adapters", 0):
            raise ValueError(
                "chunked prefill does not support multi-LoRA banks — use "
                "ContinuousEngine for bank serving")
        if kwargs.get("mesh") is not None:
            raise ValueError(
                "chunked prefill is single-device — mesh serving uses "
                "ContinuousEngine (its chunk/stage programs would need "
                "their own shardings)")
        super().__init__(loaded, **kwargs)
        self.chunk_size = int(chunk_size)
        if self.chunk_size <= 0:
            raise ValueError(f"chunk_size must be > 0, got {chunk_size}")
        # FIFO of staged admissions ({slot, emb, plen, start}); the batcher's
        # worker mutates it while /metrics threads read prefilling_slots
        self._staged: "collections.deque" = collections.deque()
        self._stage_lock = threading.Lock()

    @property
    def prefilling_slots(self):
        with self._stage_lock:
            return {st["slot"] for st in self._staged}

    def admit_many(self, requests) -> List[Optional[int]]:
        """Stage up to ``num_slots`` requests (one batched embedding call at
        the bucketed width); returns None per request."""
        requests = self._check_requests(requests)
        _, img, ids, _, plens = self._staging_arrays(requests)
        slots = [slot for slot, *_ in requests]
        emb = self._stage(slots, img, ids)
        with self._stage_lock:
            for i, slot in enumerate(slots):
                self._staged.append({"slot": slot, "emb": emb[i:i + 1], "plen": plens[i],
                                     "start": 0})
        return [None] * len(requests)

    @torch.inference_mode()
    def _stage(self, slots, img, ids) -> torch.Tensor:
        dev = self.device
        emb = self.loaded.model.prompt_embeds(torch.from_numpy(img).to(dev),
                                              torch.from_numpy(ids).to(dev))
        sl = torch.tensor(slots, dtype=torch.long, device=dev)
        # decode steps write every row at its seq_lens: park the slots on the
        # last slot, which no mask ever opens (the step's can_write guard)
        self.seq_lens[sl] = self.cache_len - 1
        self.cache_mask[sl] = 0
        return emb

    def advance_prefill(self):
        """Forward one chunk of the oldest staged admission; returns
        [(slot, first_token)] for the admission it completed, if any."""
        with self._stage_lock:
            st = self._staged[0] if self._staged else None
        if st is None:
            return []
        h = self._chunk_call(st["emb"], st["slot"], st["start"])
        st["start"] += self.chunk_size
        if st["start"] < st["plen"]:
            return []
        off = st["plen"] - 1 - (st["start"] - self.chunk_size)
        first = self._finish(st["slot"], st["plen"], h[off])
        with self._stage_lock:
            self._staged.popleft()
        return [(st["slot"], first)]

    @torch.inference_mode()
    def _chunk_call(self, emb, row: int, start: int) -> torch.Tensor:
        """Forward emb[0, start:start+g] for slot ``row`` against its
        committed prefix [0, start) and return its final-norm hidden states
        [<= g, H].  The last chunk stops where the prompt matrix ends (JAX
        pads it with zero rows whose outputs nothing reads)."""
        cache_row = tuple({part: c[part][row:row + 1] for part in ("k", "v")}
                          for c in self.caches)
        prefix = (torch.arange(self.cache_len, device=self.device) < start).to(torch.int32)
        start_t = torch.tensor([start], dtype=torch.int32, device=self.device)
        chunk = emb[:, start:start + self.chunk_size]
        lm = self.loaded.model.language_model
        return lm.decode_chunk(chunk, cache_row, start_t, prefix[None])[0]

    @torch.inference_mode()
    def _finish(self, row: int, plen: int, h_last: torch.Tensor) -> int:
        """Sample the first token from the prompt's last hidden state and
        put the slot live for the decode loop."""
        first = self._sample(self.loaded.model.language_model.lm_head(h_last[None]))[0]
        self.seq_lens[row] = plen
        self.cache_mask[row] = (torch.arange(self.cache_len, device=self.device)
                                < plen).to(torch.int32)
        self.last_tok[row] = first
        return int(first)


__all__ = ["ChunkedContinuousEngine"]
