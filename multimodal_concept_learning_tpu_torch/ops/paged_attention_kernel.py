"""K3: one-token decode attention against a paged KV pool.

``paged_decode_attention`` is the wrapper of the CUDA kernel
``csrc/paged_attention.cu``, which replaces the Pallas TPU kernel
``multimodal_concept_learning_tpu/ops/paged_attention_kernel.py:_kernel``.
Beside it, ``paged_decode_attention_reference`` is the plain PyTorch
version (the JAX package's gather path): gather each row's pages into a
contiguous [B, NP * ps, hk, d] copy, mask, attend.  The wrapper runs the
plain version for CPU tensors only; a CUDA tensor goes to the kernel or
the wrapper raises.

Semantics (both versions): q [B, 1, Hq, D]; pools [P, hk, ps, D]
(head-major); page_table [B, NP] int32; lens [B] attendable tokens
INCLUDING the new one (the query sits at position ``lens - 1``); window
< 0 (or None) = global, else position i is attended iff
``lens - 1 - i < window``.  Rows with ``lens == 0`` output zeros (the
Pallas kernel's behaviour; the plain version zeroes them explicitly).

On the card each (row, kv head) is split over a thread block cluster of
``paged_split_plan`` CTAs, each taking one run of the row's attended tokens
(``paged_split_runs``); their float32 partials merge in rank order.  ``paged_decode_split_reference`` is that algorithm in plain PyTorch
(the tests hold it to the JAX kernel; no path runs it).  What bounds the
kernel on the card, and its design: see the source notes in
``csrc/paged_attention.cu`` and ``csrc/paged_split.cuh``.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.ops._build import cuda_operand
from multimodal_concept_learning_tpu_torch.ops.flash_attention import (
    _NEG,
    flash_attention_reference,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8  # q heads per kv head the kernel holds (kMaxGroup)
MAX_SPLIT = 16  # CTAs a cluster may hold (kMaxSplit; > 8 is non-portable)
SPLIT_UNIT = 32  # K3's chunk (kChunk): a run is a whole number of them
NUM_SMS = 132  # H100 SXM


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous KV [B, NP * ps, hk, d]: position p of row b comes
    out at index p (pages are assigned in position order); entries past a
    row's length hold whatever the pages hold and must be masked."""
    b, np_ = page_table.shape
    _, hk, ps, d = pool.shape
    gathered = pool[page_table.long()]  # [B, NP, hk, ps, d]
    return gathered.permute(0, 1, 3, 2, 4).reshape(b, np_ * ps, hk, d)


def paged_attention_mask(lens: torch.Tensor, total: int, window: int) -> torch.Tensor:
    """[B, total] bool: which positions a row's newest token attends to."""
    idx = torch.arange(total, device=lens.device)[None, :]
    valid = idx < lens[:, None]
    if window < 0:
        return valid
    return valid & (lens[:, None] - 1 - idx < window)


def paged_decode_attention_reference(q, pool_k, pool_v, page_table, lens, *,
                                     scale: float, window: int) -> torch.Tensor:
    """Plain version: gather, mask, grouped attention; zero rows of length 0."""
    k = gather_pages(pool_k, page_table)
    v = gather_pages(pool_v, page_table)
    mask = paged_attention_mask(lens, k.shape[1], window)
    bias = torch.where(mask, 0.0, _NEG)[:, None, None, :]
    out = flash_attention_reference(q, k, v, bias, scale=scale)
    return out * (lens > 0).to(out.dtype)[:, None, None, None]


def paged_split_plan(batch: int, kv_heads: int, max_tokens: int) -> int:
    """S, the CTAs (one cluster) that split each (row, kv head) on the card,
    from the shapes alone: enough to give every SM one CTA, at most
    ``MAX_SPLIT``, and no more than the chunks of ``max_tokens`` (the most
    tokens a row can attend: the page table's columns, cut to the window)."""
    rows = max(1, batch * kv_heads)
    fill = -(-NUM_SMS // rows)
    return max(1, min(MAX_SPLIT, fill, -(-max_tokens // SPLIT_UNIT)))


def paged_split_runs(lens: torch.Tensor, *, splits: int, window: int, limit: int,
                     unit: int = SPLIT_UNIT, aligned: bool = False):
    """(lo, hi), each [splits, B]: the run of attended tokens [lo, hi) that
    rank r of a row's cluster takes, as the kernels work it out on the card
    (``csrc/paged_split.cuh``).  The row attends [start, end): end = min(lens,
    limit), start = max(0, lens - window) (0 when window < 0).  K3
    (``aligned=False``): ceil((end - start) / splits) tokens, rounded up to
    whole ``unit``s, counted from start.  K4 (``aligned=True``): the
    ``unit``-token pieces at multiples of ``unit`` that [start, end) touches,
    ceil of their count over splits a rank, cut to [start, end)."""
    lens = lens.long()
    end = lens.clamp(max=limit)
    start = (lens - window).clamp(min=0) if window >= 0 else torch.zeros_like(lens)
    r = torch.arange(splits, device=lens.device)[:, None]
    if not aligned:
        n = (end - start).clamp(min=0)
        per = -(-(-(-n // splits)) // unit) * unit
        lo = torch.minimum(end, start + r * per)
        return lo, torch.minimum(end, lo + per)
    u0 = start // unit
    u1 = torch.where(start < end, -(-end // unit), u0)
    per = -(-(u1 - u0) // splits)
    lo = torch.minimum(end, torch.maximum(start, (u0 + r * per) * unit))
    return lo, torch.maximum(lo, torch.minimum(end, (u0 + (r + 1) * per) * unit))


def paged_decode_split_reference(q, pool_k, pool_v, page_table, lens, *, scale: float,
                                 window: int, splits: int) -> torch.Tensor:
    """Plain version of the card's algorithm: each of ``splits`` runs
    (``paged_split_runs``) gives a float32 partial (max m, denominator l,
    accumulator acc; m = -inf for an empty run), merged in rank order into
    acc / l, exact zeros where l == 0."""
    b, _, hq, d = q.shape
    hk, ps = pool_k.shape[1], pool_k.shape[2]
    g = hq // hk
    k = gather_pages(pool_k, page_table).float()  # [B, T, hk, d]
    v = gather_pages(pool_v, page_table).float()
    total = k.shape[1]
    qg = q[:, 0].float().reshape(b, hk, g, d)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k) * scale  # [B, hk, g, T]
    lo, hi = paged_split_runs(lens, splits=splits, window=window, limit=total)
    idx = torch.arange(total, device=q.device)
    m_all = torch.full((b, hk, g), float("-inf"), device=q.device)
    parts = []
    for r in range(splits):
        ok = ((idx >= lo[r][:, None]) & (idx < hi[r][:, None]))[:, None, None, :]
        m = torch.where(ok, s, float("-inf")).amax(dim=-1)  # [B, hk, g]
        p = torch.where(ok, torch.exp(s - torch.where(m.isinf(), 0.0, m)[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bhgt,bthd->bhgd", p, v)))
        m_all = torch.maximum(m_all, m)
    l_sum = torch.zeros_like(m_all)
    acc = torch.zeros((b, hk, g, d), device=q.device)
    for m, l, a in parts:  # rank order
        w = torch.where(m.isinf(), 0.0, torch.exp(m - torch.where(m_all.isinf(), 0.0, m_all)))
        l_sum = l_sum + w * l
        acc = acc + w[..., None] * a
    out = torch.where(l_sum[..., None] > 0, acc / l_sum.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(b, hq, d)[:, None].to(q.dtype)


def kernel_operands(q, pool_k, pool_v, page_table, lens):
    """Check what the kernels take and return (q, page_table, lens) as they
    read them: q, the page table and lens contiguous and 16-byte aligned,
    copied only if they are not (a strided or offset view, which the JAX
    function takes).  The pools must already be so: a copy would copy the
    whole cache in every layer (``init_paged_kv_cache`` makes them so)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged decode kernel takes float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, D], got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if pool_k.dim() != 4 or pool_k.shape != pool_v.shape or pool_k.shape[3] != d:
        raise ValueError(f"pools must be [P, hk, ps, {d}], got {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)}")
    hk = pool_k.shape[1]
    if hq % hk or hq // hk > _MAX_GROUP:
        raise ValueError(f"q heads {hq} must be a multiple (<= {_MAX_GROUP}x) of kv heads {hk}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged decode kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    for name, t in (("pool_k", pool_k), ("pool_v", pool_v)):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with q's device and dtype")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernel's vector loads)")
    for name, t, shape in (("page_table", page_table, (b, page_table.shape[-1])),
                           ("lens", lens, (b,))):
        if t.dtype != torch.int32 or t.device != q.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be an int32 {shape} tensor on q's device")
    return cuda_operand(q), cuda_operand(page_table), cuda_operand(lens)


def split_for(b: int, hk: int, ps: int, np_: int, window: int) -> int:
    """``paged_split_plan`` at a call's shapes: the most tokens a row can
    attend is the page table's columns, cut to the window."""
    limit = np_ * ps
    return paged_split_plan(b, hk, min(limit, window) if window >= 0 else limit)


def paged_decode_attention(q, pool_k, pool_v, page_table, lens, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a paged KV pool; returns [B, 1, Hq, D].
    CUDA tensors run the K3 kernel (counted in
    ``paged_decode_attention.launches``); CPU tensors the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    window = -1 if window is None else int(window)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, pool_k, pool_v, page_table, lens,
                                                scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cpu or cuda tensors, got {q.device}")
    q, page_table, lens = kernel_operands(q, pool_k, pool_v, page_table, lens)
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, _, hq, d = q.shape
    _, hk, ps, _ = pool_k.shape
    np_ = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        err = kernels().mcl_paged_decode_attention(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), b, hq, hk, ps, np_,
            d, _DTYPE_CODES[q.dtype], window, float(scale), split_for(b, hk, ps, np_, window),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

__all__ = [
    "gather_pages",
    "kernel_operands",
    "paged_attention_mask",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "paged_decode_split_reference",
    "paged_split_plan",
    "paged_split_runs",
    "split_for",
]
