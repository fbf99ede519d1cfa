"""K4: one-token decode attention against a paged KV pool, block by block.

``paged_decode_attention_mp`` is the wrapper of the CUDA kernel
``csrc/paged_attention_mp.cu``, which replaces the Pallas TPU kernel
``multimodal_concept_learning_tpu/ops/paged_attention_mp_kernel.py:_mp_kernel``.
Same semantics as K3 (``ops/paged_attention_kernel.py``); it walks each
row in blocks of ``pages_per_block`` pages, copying the next block while
the current one computes.

Beside it, ``paged_decode_attention_mp_reference`` is the plain PyTorch
version, the TPU kernel's own algorithm: the same blocks of
``pages_per_block`` pages (the page table padded with the null page to a
whole number of blocks), a float32 online softmax across blocks, masked
entries exactly 0, rows of length 0 giving zeros.  The wrapper runs it for
CPU tensors only; a CUDA tensor goes to the kernel or the wrapper raises.

On the card ``pages_per_block`` (default 8, as JAX) is clamped to what two
stages of K and V fit in shared memory; where one page does not fit twice,
a page is staged in row ranges.  ``mp_schedule`` reports the effective
schedule.  Each (row, kv head) is split over a cluster of K3's
``paged_split_plan`` CTAs, each taking whole segments of the row
(``paged_split_runs(..., aligned=True)``); their float32 partials merge in
rank order.  Results depend on the schedule and the split only
through float32 summation order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_concept_learning_tpu_torch.ops._build import SMEM_PER_BLOCK
from multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel import (
    _DTYPE_CODES,
    MAX_SPLIT,
    kernel_operands,
    split_for,
)

_NEG = -1e30  # the TPU kernel's finite mask value


def _smem(g: int, d: int, blk: int, elem: int) -> int:
    """Shared memory of one K4 CTA (``csrc/paged_attention_mp.cu``,
    ``smem_bytes``): two stages of K and V for ``blk`` tokens, or the merge
    of its lane groups' float32 states if larger, then the cluster merge's
    receive buffer at the largest split."""
    groups = 8 * 32 // min(32, d * elem // 16)  # lane groups of one token row each
    merge = 4 * (-(-(groups * g * (d + 2) + 2 * g) // 4) * 4)
    slice_ = -(-(-(-g * d // MAX_SPLIT)) // 4) * 4
    return max(4 * blk * d * elem, merge) + 4 * (MAX_SPLIT * slice_ + 2 * MAX_SPLIT * g)


def mp_schedule(page_size: int, head_dim: int, dtype: torch.dtype, group: int,
                pages_per_block: int, num_table_pages: int) -> Tuple[int, int]:
    """(tokens per copied segment, segments per block) of K4 for this
    shape: whole pages (segment == page_size) and up to ``pages_per_block``
    of them a block (at most the table's pages, as JAX), as many as fit;
    when one page does not fit twice, the largest divisor of the page size
    that does, one segment a block."""
    elem = torch.empty((), dtype=dtype).element_size()
    ppb = max(1, min(pages_per_block, num_table_pages))
    while ppb > 1 and _smem(group, head_dim, page_size * ppb, elem) > SMEM_PER_BLOCK:
        ppb -= 1
    if _smem(group, head_dim, page_size * ppb, elem) <= SMEM_PER_BLOCK:
        return page_size, ppb
    seg = max(s for s in range(1, page_size + 1) if page_size % s == 0
              and _smem(group, head_dim, s, elem) <= SMEM_PER_BLOCK)
    return seg, 1


def paged_decode_attention_mp_reference(q, pool_k, pool_v, page_table, lens, *,
                                        scale: float, window: int,
                                        pages_per_block: int = 8) -> torch.Tensor:
    """Plain version: the TPU kernel's blocks and float32 online softmax."""
    b, _, hq, d = q.shape
    _, hk, ps, _ = pool_k.shape
    g = hq // hk
    np_ = page_table.shape[1]
    ppb = min(pages_per_block, np_)
    np_pad = -(-np_ // ppb) * ppb
    pt = torch.nn.functional.pad(page_table.long(), (0, np_pad - np_))  # null pages
    blk = ppb * ps
    qg = q[:, 0].float().reshape(b, hk, g, d) * scale
    lens = lens.long()
    pos = (lens - 1)[:, None]
    m = torch.full((b, hk, g, 1), _NEG, device=q.device)
    l = torch.zeros((b, hk, g, 1), device=q.device)
    acc = torch.zeros((b, hk, g, d), device=q.device)
    for c in range(np_pad // ppb):
        pages = pt[:, c * ppb:(c + 1) * ppb]  # [B, ppb]
        # [B, ppb, hk, ps, d] -> [B, hk, blk, d]
        k = pool_k[pages].float().permute(0, 2, 1, 3, 4).reshape(b, hk, blk, d)
        v = pool_v[pages].float().permute(0, 2, 1, 3, 4).reshape(b, hk, blk, d)
        s = qg @ k.transpose(-1, -2)  # [B, hk, g, blk]
        idx = torch.arange(blk, device=q.device)[None, :] + c * blk
        ok = idx < lens[:, None]
        if window >= 0:
            ok = ok & (pos - idx < window)
        ok = ok[:, None, None, :]
        s = torch.where(ok, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.reshape(b, hq, d)[:, None].to(q.dtype)


def paged_decode_attention_mp(q, pool_k, pool_v, page_table, lens, *,
                              scale: Optional[float] = None, window: Optional[int] = None,
                              pages_per_block: int = 8) -> torch.Tensor:
    """One-token attention against a paged KV pool; returns [B, 1, Hq, D].
    CUDA tensors run the K4 kernel (counted in
    ``paged_decode_attention_mp.launches``); CPU tensors the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    window = -1 if window is None else int(window)
    if q.device.type == "cpu":
        return paged_decode_attention_mp_reference(q, pool_k, pool_v, page_table, lens,
                                                   scale=scale, window=window,
                                                   pages_per_block=pages_per_block)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_mp runs on cpu or cuda tensors, got {q.device}")
    if pages_per_block < 1:
        raise ValueError(f"pages_per_block must be >= 1, got {pages_per_block}")
    q, page_table, lens = kernel_operands(q, pool_k, pool_v, page_table, lens)
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, _, hq, d = q.shape
    _, hk, ps, _ = pool_k.shape
    np_ = page_table.shape[1]
    seg, spb = mp_schedule(ps, d, q.dtype, hq // hk, pages_per_block, np_)
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        err = kernels().mcl_paged_decode_attention_mp(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), b, hq, hk, ps, np_, d,
            _DTYPE_CODES[q.dtype], window, float(scale), seg, spb,
            split_for(b, hk, ps, np_, window), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_decode_attention_mp")
    paged_decode_attention_mp.launches += 1
    return out


paged_decode_attention_mp.launches = 0

__all__ = [
    "mp_schedule",
    "paged_decode_attention_mp",
    "paged_decode_attention_mp_reference",
]
