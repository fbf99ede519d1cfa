"""K1 forward: fused attention over [B, T, H, D] tensors.

``flash_attention`` is the wrapper of the CUDA kernel
``csrc/flash_attention_fwd.cu``, which replaces the Pallas TPU kernel
``multimodal_concept_learning_tpu/ops/flash_attention.py:_fwd_kernel``.
Beside it, ``flash_attention_reference`` is the plain PyTorch version of
the same function: the wrapper runs it for CPU tensors, and tests and
``chip_smoke.py`` hold the kernel against it.  A CUDA tensor always goes to
the kernel (or the wrapper raises); nothing falls back.

Masks are descriptors, as the kernel takes them: ``kv_lens`` (right-padded
keys), ``causal`` (offset ``Tk - Tq``, the JAX ``make_attention_bias``
convention) and ``window`` (query at position p attends keys k with
``p - k < window``).  An optional additive float32 ``bias`` broadcastable to
[B, Hq, Tq, Tk] is added on top.  A query row that no key may attend gets a
zero output (the JAX bias path would average it uniformly; such rows are
padding whose outputs no real row reads).

What bounds the kernel on the card, and its design: see the source note in
``csrc/flash_attention_fwd.cu``.  Forward only: a CUDA call that needs a
gradient raises in backward (the backward kernels are a later slice).
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30  # the JAX package's finite mask value (ops/attention.py)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def key_mask(b: int, tq: int, tk: int, *, kv_lens=None, causal: bool = False,
             window: Optional[int] = None, device=None) -> Optional[torch.Tensor]:
    """[B or 1, 1, Tq, Tk] bool, True = attendable; None when nothing is masked."""
    ok = None
    if causal or window is not None:
        qi = torch.arange(tq, device=device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=device)[None, :]
        ok = torch.ones((tq, tk), dtype=torch.bool, device=device)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= qi - ki < window
        ok = ok[None, None]
    if kv_lens is not None:
        pad = torch.arange(tk, device=device)[None, :] < kv_lens.to(device)[:, None]
        pad = pad[:, None, None, :]
        ok = pad if ok is None else ok & pad
    return ok


def flash_attention_reference(q, k, v, bias=None, *, scale: Optional[float] = None,
                              kv_lens=None, causal: bool = False,
                              window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's semantics.

    Grouped GQA without repeating K/V (the einsum layout of the JAX
    ``multi_head_attention``): q head h reads kv head ``h // (Hq / Hk)``.
    Logits and softmax in float32, probabilities cast to the input dtype
    before the value product.
    """
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv heads {hk}")
    g = hq // hk
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, tq, hk, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if bias is not None:
        bias = bias.float()
        while bias.dim() < 4:
            bias = bias[None]
        if bias.shape[1] == hq and g > 1:
            bias = bias.reshape(bias.shape[0], hk, g, *bias.shape[2:])
        else:
            bias = bias[:, :, None]
        logits = logits + bias
    ok = key_mask(b, tq, tk, kv_lens=kv_lens, causal=causal, window=window,
                  device=q.device)
    if ok is not None:
        logits = logits + torch.where(ok, 0.0, _NEG)[:, :, None]
    probs = torch.softmax(logits, dim=-1)
    if ok is not None:
        probs = probs * ok.any(dim=-1, keepdim=True)[:, :, None]  # empty rows -> 0
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return out.reshape(b, tq, hq, d)


def _check(q, k, v, bias, kv_lens):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Tq,Hq,D], k/v [B,Tk,Hk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if bias is not None and (bias.dtype != torch.float32 or bias.device != q.device):
        raise ValueError("bias must be float32 on q's device")
    if kv_lens is not None and (kv_lens.dtype != torch.int32 or kv_lens.device != q.device
                                or kv_lens.shape != (b,) or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 [B] tensor on q's device")


def _launch(q, k, v, bias, scale, kv_lens, causal, window) -> torch.Tensor:
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (0, 0, 0, 0)
    if bias is not None:
        while bias.dim() < 4:
            bias = bias[None]
        bias = bias.expand(b, hq, tq, tk)  # stride 0 on broadcast axes, no copy
        strides = bias.stride()
    with torch.cuda.device(q.device):
        err = kernels().mcl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bias.data_ptr() if bias is not None else None, *strides,
            kv_lens.data_ptr() if kv_lens is not None else None,
            b, tq, tk, hq, hk, d, _DTYPE_CODES[q.dtype], float(scale),
            int(causal), -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


class _FlashAttentionFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, kv_lens, causal, window):
        return _launch(q, k, v, bias, scale, kv_lens, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention backward: the K1 backward kernels are slice 2 of the port "
            "(ROADMAP.md, queue B)")


def flash_attention(q, k, v, bias=None, *, scale: Optional[float] = None,
                    kv_lens=None, causal: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention over q [B, Tq, Hq, D], k/v [B, Tk, Hk, D]; returns
    [B, Tq, Hq, D] in q's dtype.  CUDA tensors run the K1 kernel (counted
    in ``flash_attention.launches``); CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale=scale, kv_lens=kv_lens,
                                         causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    _check(q, k, v, bias, kv_lens)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttentionFwd.apply(q, k, v, bias, scale, kv_lens, causal, window)


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_reference", "key_mask"]
