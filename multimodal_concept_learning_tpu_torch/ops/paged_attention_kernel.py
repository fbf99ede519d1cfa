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

What bounds the kernel on the card, and its design: see the source note in
``csrc/paged_attention.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.ops.flash_attention import (
    _NEG,
    flash_attention_reference,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_GROUP = 8  # q heads per kv head the kernel holds (kMaxGroup)


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


def _check(q, pool_k, pool_v, page_table, lens):
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
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t, shape in (("page_table", page_table, (b, page_table.shape[-1])),
                           ("lens", lens, (b,))):
        if (t.dtype != torch.int32 or t.device != q.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 {shape} tensor on q's device")


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
    _check(q, pool_k, pool_v, page_table, lens)
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, _, hq, d = q.shape
    _, hk, ps, _ = pool_k.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        err = kernels().mcl_paged_decode_attention(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), out.data_ptr(),
            page_table.data_ptr(), lens.data_ptr(), b, hq, hk, ps, page_table.shape[1],
            d, _DTYPE_CODES[q.dtype], window, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

__all__ = [
    "gather_pages",
    "paged_attention_mask",
    "paged_decode_attention",
    "paged_decode_attention_reference",
]
