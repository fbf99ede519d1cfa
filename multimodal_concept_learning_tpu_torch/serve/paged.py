"""Paged continuous batching (counterpart of multimodal_concept_learning_tpu/serve/paged.py).

Slot-level serving over one shared KV page pool (ops/paged_kv.py):

- **admission** reserves exactly the pages a request's lifetime needs
  (``ceil((prompt_len + max_new_tokens + steps_per_call) / page_size)``
  from its real prompt length) and prefills straight into them; prompt
  attention runs the K1 forward kernel on the card;
- **step** advances every slot ``steps_per_call`` tokens, each decode
  attention a K3 kernel launch per layer on the card (K4 under
  ``MCL_PAGED_KERNEL=2``); ``decode_steps`` counts the decode steps run.
  ``quant_kv=True`` (HTTP ``--int8_kv``) stores the pool as int8 with
  per-(token, head) scales: writes quantize, and each decode attention
  gathers and dequantizes the pages and runs K1 (never K3 or K4), as the
  JAX engine reads int8 pools through its gather branch;
- **release** returns a finished request's pages and zeroes its page-table
  row, so the slot's inert decode writes land on the null page.

The device state (pools, page table, per-slot lengths, caps and last
tokens) lives on the loaded model's device and is updated in place; the
JAX engine's jitted scan is a Python loop here with the same
``can_write``/cap semantics.  Whole-lifetime reservation keeps the decode
free of mid-flight allocation: the free list is the single backpressure
point (``admissible_prefix``).  API-compatible with ``ContinuousBatcher``.
Multi-LoRA banks are refused, as JAX refuses them: a ``language_lora``
run is served here merged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
    PageAllocator,
    PagePoolExhausted,
    init_paged_kv_cache,
    pages_needed,
)
from multimodal_concept_learning_tpu_torch.ops.sampling import sample_logits
from multimodal_concept_learning_tpu_torch.serve.engine import EngineHostAPI


class PagedContinuousEngine(EngineHostAPI):
    """Persistent paged-decode engine; the engine of ContinuousBatcher."""

    def __init__(self, loaded, num_slots: int = 8, max_new_tokens: int = 8,
                 max_prompt_len: int = 64, page_size: int = 16,
                 num_pages: Optional[int] = None, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, steps_per_call: int = 1, quant_kv: bool = False):
        if getattr(loaded, "num_adapters", 0):
            raise ValueError(
                "the paged front does not support multi-LoRA banks — serve "
                "a bank through the dense fronts (ServingEngine or "
                "ContinuousEngine), or merge one adapter for paged serving")
        self.num_adapters = 0
        self.loaded = loaded
        self.num_slots = num_slots
        self.max_new_tokens = max_new_tokens
        self.max_prompt_len = max_prompt_len
        self.page_size = page_size
        self.steps_per_call = steps_per_call
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        tok = loaded.tokenizer
        self.eos_id = getattr(tok, "eos_token_id", None)
        self.pad_id = getattr(tok, "pad_token_id", 0) or 0
        self.nvt = loaded.model.cfg.num_vision_tokens
        self.prompt_t = self.nvt + max_prompt_len
        # pages covering one worst-case request lifetime
        self.max_pages_per_seq = pages_needed(
            self.prompt_t + max_new_tokens + steps_per_call, page_size)
        if num_pages is None:
            num_pages = num_slots * self.max_pages_per_seq + 1
        if num_pages - 1 < self.max_pages_per_seq:
            raise ValueError(f"pool of {num_pages - 1} usable pages cannot hold even one "
                             f"maximal request ({self.max_pages_per_seq} pages)")
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]

        dev = self.device = loaded.device
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        lm_cfg = loaded.model.cfg.lm
        self.quant_kv = quant_kv
        self.pools = init_paged_kv_cache(lm_cfg, num_pages, page_size, device=dev,
                                         quantized=quant_kv)
        i32 = dict(dtype=torch.int32, device=dev)
        self.page_table = torch.zeros((num_slots, self.max_pages_per_seq), **i32)
        self.seq_lens = torch.zeros((num_slots,), **i32)
        self.caps = torch.zeros((num_slots,), **i32)
        self.last_tok = torch.zeros((num_slots,), **i32)
        self.decode_steps = 0  # decode_step_paged calls (one per layer stack pass)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(logits, self._generator, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p)

    # -- host-side API ---------------------------------------------------------

    def _request_pages(self, prompt: str) -> int:
        lifetime = (self.nvt + len(self.encode_prompt(prompt))
                    + self.max_new_tokens + self.steps_per_call)
        return pages_needed(lifetime, self.page_size)

    def admissible_prefix(self, prompts: Sequence[str]) -> int:
        """How many of ``prompts`` (in order) fit the free list right now."""
        avail = self.allocator.available
        n = 0
        for p in prompts:
            need = self._request_pages(p)
            if need > avail:
                break
            avail -= need
            n += 1
        return n

    def admit_many(self, requests) -> List[int]:
        """Install up to ``num_slots`` requests with one batched prefill.

        requests: (slot, image, prompt[, adapter]) with distinct free slots
        (adapter must be 0: no multi-LoRA banks here).  Raises
        PagePoolExhausted before touching any state if the free list cannot
        cover them all.  Returns each request's first generated token."""
        if not 0 < len(requests) <= self.num_slots:
            raise ValueError(f"admit 1..{self.num_slots} requests, got {len(requests)}")
        if any(r[3] for r in requests if len(r) == 4):
            raise ValueError("the paged front has no adapter bank")
        requests = [r[:3] for r in requests]
        # staged BEFORE the reservation: a malformed request raises while the
        # allocator is untouched
        a, img, ids, mask, plens = self._staging_arrays(requests)
        allocs: List[List[int]] = []
        try:
            for _, _, prompt in requests:
                allocs.append(self.allocator.alloc(self._request_pages(prompt)))
        except PagePoolExhausted:
            for pages in allocs:
                self.allocator.free(pages)
            raise
        valid = np.zeros((a,), bool)
        pt_rows = np.zeros((a, self.max_pages_per_seq), np.int32)
        cap_rows = np.zeros((a,), np.int32)
        used = [s for s, _, _ in requests]
        leftovers = [s for s in range(self.num_slots) if s not in used]
        slots = np.asarray(used + leftovers[: a - len(used)], np.int64)
        for i in range(len(requests)):
            valid[i] = True
            pt_rows[i, : len(allocs[i])] = allocs[i]
            cap_rows[i] = plens[i] + self.max_new_tokens + self.steps_per_call
        try:
            firsts = self._admit(slots, valid, pt_rows, cap_rows, img, ids, mask)
        except Exception:
            # a failed device admit must not leak the reservation
            for pages in allocs:
                self.allocator.free(pages)
            raise
        for (slot, _, _), pages in zip(requests, allocs):
            self._slot_pages[slot] = pages
        return [int(firsts[i]) for i in range(len(requests))]

    @torch.inference_mode()
    def _admit(self, slots, valid, pt_rows, cap_rows, img, ids, mask) -> np.ndarray:
        """Prefill the staged rows into their pages (padding rows carry
        all-null page rows) and install the valid rows' slot state."""
        dev = self.device
        model = self.loaded.model
        slots, valid, pt_rows, cap_rows, img, ids, mask = (
            torch.as_tensor(x).to(dev)
            for x in (slots, valid, pt_rows, cap_rows, img, ids, mask))
        hidden = model.prefill_paged(img, ids, mask, self.pools, pt_rows)
        plens = mask.sum(dim=1).to(torch.int32)
        rows = torch.arange(hidden.shape[0], device=dev)
        last = hidden[rows, (plens.long() - 1).clamp(min=0)]
        firsts = self._sample(model.language_model.lm_head(last))
        self.page_table[slots] = torch.where(valid[:, None], pt_rows, self.page_table[slots])
        self.seq_lens[slots] = torch.where(valid, plens, self.seq_lens[slots])
        self.caps[slots] = torch.where(valid, cap_rows, self.caps[slots])
        self.last_tok[slots] = torch.where(valid, firsts, self.last_tok[slots])
        return firsts.cpu().numpy()

    @torch.inference_mode()
    def step(self, active: np.ndarray) -> np.ndarray:
        """One decode call for all slots; returns [num_slots, steps_per_call]
        new tokens (tokens past a row's EOS are overshoot — callers
        truncate).  Rows past their cap, or inactive, stay inert: their K/V
        write lands on the null page or an unread position, and their
        lengths and last tokens freeze."""
        lm = self.loaded.model.language_model
        active = torch.as_tensor(active, dtype=torch.bool).to(self.device)
        toks = []
        for _ in range(self.steps_per_call):
            can_write = active & (self.seq_lens < self.caps)
            hidden = lm.decode_step_paged(lm.embed(self.last_tok[:, None]), self.pools,
                                          self.page_table, self.seq_lens)
            self.decode_steps += 1
            nxt = self._sample(lm.lm_head(hidden[:, 0]))
            self.seq_lens += can_write.to(torch.int32)
            self.last_tok = torch.where(can_write, nxt, self.last_tok)
            toks.append(nxt)
        return torch.stack(toks, dim=1).cpu().numpy()

    def release(self, slot: int) -> None:
        """Return a finished slot's pages and null out its page-table row."""
        pages = self._slot_pages[slot]
        if not pages:
            return
        self._slot_pages[slot] = []
        self.allocator.free(pages)
        self.page_table[slot] = 0

    def pool_bytes(self) -> int:
        """Device bytes of the KV pools (every layer, k and v, and the scale
        planes of an int8 pool)."""
        return sum(t.numel() * t.element_size() for p in self.pools for t in p.values())


__all__ = ["PagedContinuousEngine", "PagePoolExhausted"]
