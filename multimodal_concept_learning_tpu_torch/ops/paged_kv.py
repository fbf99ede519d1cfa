"""Paged KV cache (counterpart of multimodal_concept_learning_tpu/ops/paged_kv.py).

- **pool**: per layer ``{"k", "v"}`` of shape [num_pages, kv_heads,
  page_size, head_dim], one shared arena for every in-flight request
  (head-major: one page of one head is a contiguous [ps, d] block, which
  is what the K3 kernel reads);
- **page table**: [rows, max_pages] int32 shared by all layers; row b's
  token at position p lives at ``(table[b, p // ps], p % ps)``;
- **page 0 is the null page**: never allocated, never read unmasked.
  Writes that must go nowhere (prompt padding, released slots, positions
  past the table) land on it.

Allocation is host-side bookkeeping (``PageAllocator``).  Unlike the JAX
package, whose arrays are immutable, the write ops here update the pools
IN PLACE (``index_put_``): a serving step then moves one token of K/V per
row and layer instead of copying the pool.  The decode read is
ops/paged_attention_kernel.py (K3 on CUDA, the plain gather path on CPU).
Int8 pools (the JAX ``quantized=True`` layout) are not ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
    gather_pages,
    paged_attention_mask,
    paged_decode_attention,
)


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, device,
                        dtype=None):
    """Zero per-layer page pools: a tuple of ``{"k", "v"}`` dicts, each
    [num_pages, kv_heads, page_size, head_dim] in ``dtype`` (default: the
    LM's compute dtype).  Page 0 is the null page — size the pool with one
    page more than you plan to allocate."""
    shape = (num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    dtype = cfg.dtype if dtype is None else dtype
    return tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    )


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-int(num_tokens) // page_size)


class PagePoolExhausted(RuntimeError):
    """Raised by ``PageAllocator.alloc`` when the pool cannot cover a
    request.  Serving fronts treat it as backpressure, not as a failure."""


class PageAllocator:
    """Host-side free list over pages ``1..num_pages-1`` (0 = null page).
    Not thread-safe by itself (the serving front drives it from its single
    worker thread)."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least the null page plus one")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() -> low ids first
        self._free_set = set(self._free)  # O(1) double-free guard

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.num_pages - 1}")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            if p in self._free_set:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
            self._free_set.add(p)


def _page_of(page_table: torch.Tensor, rows: torch.Tensor, pos: torch.Tensor,
             page_size: int) -> torch.Tensor:
    """Page id holding position ``pos`` of row ``rows``; positions past the
    table map to the null page."""
    col = pos // page_size
    inside = col < page_table.shape[1]
    page = page_table[rows, col.clamp(max=page_table.shape[1] - 1)]
    return torch.where(inside, page, torch.zeros_like(page)).long()


def write_prompt_kv(pool: torch.Tensor, page_table: torch.Tensor, lens: torch.Tensor,
                    kv: torch.Tensor) -> None:
    """Scatter a prompt's K or V rows into their pages, in place.

    pool [P, hk, ps, d]; page_table [B, NP]; lens [B] true prompt lengths
    (right-padded layout); kv [B, T, hk, d].  Positions >= lens land on the
    null page."""
    b, t = kv.shape[:2]
    ps = pool.shape[2]
    pos = torch.arange(t, device=kv.device)[None, :].expand(b, t)
    rows = torch.arange(b, device=kv.device)[:, None].expand(b, t)
    page = _page_of(page_table, rows, pos, ps)
    page = torch.where(pos < lens[:, None], page, torch.zeros_like(page))
    # advanced indices (page, off) around the head slice -> [B, T, hk, d]
    pool[page, :, pos % ps] = kv.to(pool.dtype)


def write_token_kv(pool: torch.Tensor, page_table: torch.Tensor, slots: torch.Tensor,
                   kv: torch.Tensor) -> None:
    """Scatter one new token's K or V per row at position ``slots``, in
    place.  pool [P, hk, ps, d]; page_table [B, NP]; slots [B]; kv [B, hk, d]."""
    ps = pool.shape[2]
    rows = torch.arange(kv.shape[0], device=kv.device)
    page = _page_of(page_table, rows, slots.long(), ps)
    pool[page, :, slots.long() % ps] = kv.to(pool.dtype)


__all__ = [
    "PageAllocator",
    "PagePoolExhausted",
    "gather_pages",
    "init_paged_kv_cache",
    "paged_attention_mask",
    "paged_decode_attention",
    "pages_needed",
    "write_prompt_kv",
    "write_token_kv",
]
