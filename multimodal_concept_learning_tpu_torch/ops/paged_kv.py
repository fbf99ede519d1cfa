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
row and layer instead of copying the pool.  The decode read,
``paged_decode_attention``, dispatches as the JAX function does: K3
(ops/paged_attention_kernel.py) by default, K4
(ops/paged_attention_mp_kernel.py) under ``MCL_PAGED_KERNEL=2``; CPU
tensors take each kernel's plain version.

Int8 pools (``init_paged_kv_cache(..., quantized=True)``, the JAX layout)
hold int8 K/V codes with per-(token, head) float32 scale planes: writes
quantize (``quantize_kv``), and the decode read gathers the pages,
dequantizes them (``gather_pages_dequant``) and attends through
``multi_head_attention`` under the mask's bias, as the JAX gather branch
does.  On the card that is K1's forward; the gather and the dequantize
stay PyTorch ops, as JAX keeps them in XLA, and K3/K4 (float pages only,
like the Pallas kernels) never read an int8 pool.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import torch

from multimodal_concept_learning_tpu_torch.ops.attention import multi_head_attention
from multimodal_concept_learning_tpu_torch.ops.flash_attention import _NEG
from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
    gather_pages,
    paged_attention_mask,
    paged_decode_attention_reference,
)
from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
    paged_decode_attention as paged_decode_attention_k3,
)
from multimodal_concept_learning_tpu_torch.ops.paged_attention_mp_kernel import (
    paged_decode_attention_mp,
)


def init_paged_kv_cache(cfg, num_pages: int, page_size: int, device,
                        dtype=None, quantized: bool = False):
    """Zero per-layer page pools: a tuple of ``{"k", "v"}`` dicts, each
    [num_pages, kv_heads, page_size, head_dim] in ``dtype`` (default: the
    LM's compute dtype).  Page 0 is the null page — size the pool with one
    page more than you plan to allocate.  ``quantized=True``: int8 ``k``/
    ``v`` plus float32 ``k_scale``/``v_scale`` [num_pages, kv_heads,
    page_size], all zero, so unwritten pages dequantize to exact zeros."""
    shape = (num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    if quantized:
        return tuple(
            {"k": torch.zeros(shape, dtype=torch.int8, device=device),
             "v": torch.zeros(shape, dtype=torch.int8, device=device),
             "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
             "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
            for _ in range(cfg.num_layers)
        )
    dtype = cfg.dtype if dtype is None else dtype
    return tuple(
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    )


def quantize_kv(kv: torch.Tensor):
    """Symmetric int8 over the trailing (head_dim) axis: (codes [..., d]
    int8, scale [...] float32) with ``codes * scale ~= kv``; the scale's
    floor keeps all-zero rows exactly zero.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    kv = kv.float()
    scale = kv.abs().amax(dim=-1).clamp(min=1e-30) / 127.0
    return torch.round(kv / scale[..., None]).to(torch.int8), scale


def gather_pages_dequant(pool: torch.Tensor, scale: torch.Tensor, page_table: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """``gather_pages`` of an int8 pool [P, hk, ps, d] and its scale plane
    [P, hk, ps], dequantized to ``dtype``: [B, NP * ps, hk, d]."""
    b, np_ = page_table.shape
    _, hk, ps = scale.shape
    q = gather_pages(pool, page_table)
    s = scale[page_table.long()].permute(0, 1, 3, 2).reshape(b, np_ * ps, hk)
    return (q.float() * s[..., None]).to(dtype)


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


def paged_decode_attention(q, pool_k, pool_v, page_table, lens, *,
                           scale: Optional[float] = None, window: Optional[int] = None,
                           use_kernel: Union[None, bool, str] = None,
                           pages_per_block: int = 8, pool_k_scale=None,
                           pool_v_scale=None) -> torch.Tensor:
    """One-token attention against the paged pools; returns [B, 1, Hq, D].

    ``pool_k_scale`` / ``pool_v_scale`` ([P, hk, ps] float32) mark int8
    pools: they always take the dequantizing gather read (K1 on the card),
    and an explicit kernel request raises, as in JAX.

    ``use_kernel`` (the JAX argument): "2" or "mp" runs K4 with
    ``pages_per_block``; True or "1" runs K3; False the gather path, which
    only CPU tensors take (the port runs no gather read on the card).
    ``None`` reads ``MCL_PAGED_KERNEL`` at each call: "2" is K4, unset or
    "1" K3 (the port's default), anything else the gather path.  CPU
    tensors run the chosen kernel's plain version."""
    if pool_k_scale is not None:
        if use_kernel:
            raise ValueError("the paged kernels read float pages only; int8 pools take "
                             "the gather read")
        k = gather_pages_dequant(pool_k, pool_k_scale, page_table, q.dtype)
        v = gather_pages_dequant(pool_v, pool_v_scale, page_table, q.dtype)
        mask = paged_attention_mask(lens, k.shape[1], -1 if window is None else int(window))
        bias = torch.where(mask, 0.0, _NEG)[:, None, None, :]
        return multi_head_attention(q, k, v, bias, scale=scale)
    if use_kernel is None:
        env = os.environ.get("MCL_PAGED_KERNEL", "1")
        use_kernel = env if env in ("1", "2") else False
    if use_kernel in ("2", "mp"):
        return paged_decode_attention_mp(q, pool_k, pool_v, page_table, lens, scale=scale,
                                         window=window, pages_per_block=pages_per_block)
    if use_kernel is True or use_kernel == "1":
        return paged_decode_attention_k3(q, pool_k, pool_v, page_table, lens, scale=scale,
                                         window=window)
    if use_kernel is not False:
        raise ValueError(f"use_kernel must be None, True, False, '1', '2' or 'mp', "
                         f"got {use_kernel!r}")
    if q.device.type != "cpu":
        raise ValueError("the gather read runs on CPU tensors only; on the card "
                         "paged decode runs K3 or K4 (use_kernel '1' or '2')")
    return paged_decode_attention_reference(
        q, pool_k, pool_v, page_table, lens, scale=q.shape[-1] ** -0.5 if scale is None
        else scale, window=-1 if window is None else int(window))


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
    "gather_pages_dequant",
    "init_paged_kv_cache",
    "paged_attention_mask",
    "paged_decode_attention",
    "paged_decode_attention_k3",
    "paged_decode_attention_mp",
    "pages_needed",
    "quantize_kv",
    "write_prompt_kv",
    "write_token_kv",
]
