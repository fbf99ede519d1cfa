"""K1: fused attention over [B, T, H, D] tensors, forward and backward.

``flash_attention`` is the wrapper of three CUDA kernels, which replace the
Pallas TPU kernels of ``multimodal_concept_learning_tpu/ops/flash_attention.py``:

- ``csrc/flash_attention_fwd.cu`` (``_fwd_kernel``): the output and, when a
  gradient is needed, the row logsumexp ``lse`` [B, Hq, Tq] in float32;
- the dQ kernel (``_dq_kernel``): dQ, the row ``delta = rowsum(dO * O)``
  and, when the bias needs a gradient, dS;
- the dK/dV kernel (``_dkv_kernel``): dK, dV, launched after the dQ kernel,
  whose delta it reads.

Each backward kernel is ``csrc/flash_attention_bwd_tc.cu`` for bfloat16 and
``csrc/flash_attention_bwd.cu`` for float32.

Beside them are the plain PyTorch versions of the same functions
(``flash_attention_reference`` and ``flash_attention_backward_reference``):
the wrapper runs them for CPU tensors (autograd included), and tests and
``chip_smoke.py`` hold the kernels against them.  A CUDA tensor always goes
to the kernels (or the wrapper raises); nothing falls back.

Masks are descriptors, as the kernels take them: ``kv_lens`` (right-padded
keys), ``causal`` (offset ``Tk - Tq``, the JAX ``make_attention_bias``
convention) and ``window`` (query at position p attends keys k with
``p - k < window``).  An optional additive float32 ``bias`` broadcastable to
[B, Hq, Tq, Tk] is added on top; its gradient is dS summed over the axes it
was broadcast along.  A query row that no key may attend gets a zero output
and no gradient (the JAX bias path would average it uniformly; such rows are
padding whose outputs no real row reads).

bfloat16 runs on the tensor cores, forward and backward; float32 on the
CUDA cores (float32 results must match the plain version to 1e-4, which
TF32 would miss).  The bfloat16 backward rounds p and dS to bfloat16 before
its second products, where the plain version (and the TPU kernels) keep
them in float32.  What bounds the kernels on the card, and their design:
see the source notes in ``csrc/``.
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


def _bias_groups(bias: torch.Tensor, hq: int, g: int) -> torch.Tensor:
    """A bias broadcastable to [B, Hq, Tq, Tk] as [B|1, Hk|1, g|1, Tq|1, Tk]
    float32, the grouped layout of the logits."""
    bias = bias.float()
    while bias.dim() < 4:
        bias = bias[None]
    if bias.shape[1] == hq and g > 1:
        return bias.reshape(bias.shape[0], hq // g, g, *bias.shape[2:])
    return bias[:, :, None]


def _grouped_logits(q, k, bias, scale, kv_lens, causal, window):
    """Scaled float32 logits [B, Hk, g, Tq, Tk] plus bias, and the mask
    [B|1, 1, 1, Tq, Tk] (None when nothing is masked)."""
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if hq % hk:
        raise ValueError(f"GQA needs q heads {hq} divisible by kv heads {hk}")
    g = hq // hk
    qg = q.reshape(b, tq, hk, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if bias is not None:
        logits = logits + _bias_groups(bias, hq, g)
    ok = key_mask(b, tq, tk, kv_lens=kv_lens, causal=causal, window=window, device=q.device)
    return logits, None if ok is None else ok[:, :, None]


def flash_attention_reference(q, k, v, bias=None, *, scale: Optional[float] = None,
                              kv_lens=None, causal: bool = False,
                              window: Optional[int] = None, return_lse: bool = False):
    """Plain PyTorch attention with the kernels' semantics.

    Grouped GQA without repeating K/V (the einsum layout of the JAX
    ``multi_head_attention``): q head h reads kv head ``h // (Hq / Hk)``.
    Logits and softmax in float32, probabilities cast to the input dtype
    before the value product.  With ``return_lse`` also returns the row
    logsumexp [B, Hq, Tq] in float32 (+inf on rows with no attendable key),
    as the forward kernel writes it for the backward.
    """
    b, tq, hq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    logits, ok = _grouped_logits(q, k, bias, scale, kv_lens, causal, window)
    hk = k.shape[2]
    if ok is not None:
        logits = logits + torch.where(ok, 0.0, _NEG)
    probs = torch.softmax(logits, dim=-1)
    if ok is not None:
        probs = probs * ok.any(dim=-1, keepdim=True)  # empty rows -> 0
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v).reshape(b, tq, hq, d)
    if not return_lse:
        return out
    if ok is not None:
        logits = logits.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    return out, lse.reshape(b, hq, tq)


def _unbroadcast(ds: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """dS [B, Hq, Tq, Tk] summed over the axes ``bias`` was broadcast along
    (leading axes it lacks and its size-1 axes), in ``bias``'s shape and
    dtype: the JAX custom VJP's bias cotangent."""
    pad = 4 - bias.dim()
    axes = tuple(ax for ax in range(4) if ax < pad or bias.shape[ax - pad] == 1)
    if axes:
        ds = ds.sum(dim=axes, keepdim=True)
    return ds.reshape(bias.shape).to(bias.dtype)


def flash_attention_backward_reference(q, k, v, o, lse, do, bias=None, *,
                                       scale: Optional[float] = None, kv_lens=None,
                                       causal: bool = False, window: Optional[int] = None):
    """Plain PyTorch backward with the kernels' semantics: (dq, dk, dv, dbias).

    From the forward's saved ``o`` and ``lse``: p = exp(s - lse),
    dp = dO v^T, delta = rowsum(dO * O), dS = p (dp - delta),
    dQ = dS k * scale, dK = dS^T q * scale (summed over the GQA group),
    dV = p^T dO (likewise); dbias = dS unbroadcast to the bias's shape
    (None without a bias).  Float32 arithmetic; gradients in the inputs'
    dtypes.
    """
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    if scale is None:
        scale = d ** -0.5
    logits, ok = _grouped_logits(q, k, bias, scale, kv_lens, causal, window)
    p = torch.exp(logits - lse.float().reshape(b, hk, g, tq, 1))
    if ok is not None:
        p = torch.where(ok, p, 0.0)
    dog = do.float().reshape(b, tq, hk, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    delta = (dog * o.float().reshape(b, tq, hk, g, d)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, tq, hq, d) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q.float().reshape(b, tq, hk, g, d)) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dbias = None if bias is None else _unbroadcast(ds.reshape(b, hq, tq, tk), bias)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


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
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash_attention kernel takes 16-byte aligned q, k, v")
    if bias is not None and (bias.dtype != torch.float32 or bias.device != q.device):
        raise ValueError("bias must be float32 on q's device")
    if kv_lens is not None and (kv_lens.dtype != torch.int32 or kv_lens.device != q.device
                                or kv_lens.shape != (b,) or not kv_lens.is_contiguous()):
        raise ValueError("kv_lens must be a contiguous int32 [B] tensor on q's device")


def _bias_args(bias, b, hq, tq, tk):
    """(bias tensor expanded to [B, Hq, Tq, Tk] or None, its four element
    strides): stride 0 on broadcast axes, no copy."""
    if bias is None:
        return None, (0, 0, 0, 0)
    while bias.dim() < 4:
        bias = bias[None]
    bias = bias.expand(b, hq, tq, tk)
    return bias, bias.stride()


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(q, k, v, bias, scale, kv_lens, causal, window, with_lse: bool = False):
    """The forward kernel: out, and lse [B, Hq, Tq] float32 when ``with_lse``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return out, lse
    bias, strides = _bias_args(bias, b, hq, tq, tk)
    with torch.cuda.device(q.device):
        err = kernels().mcl_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse),
            _ptr(bias), *strides, _ptr(kv_lens),
            b, tq, tk, hq, hk, d, _DTYPE_CODES[q.dtype], float(scale),
            int(causal), -1 if window is None else int(window), _stream(q))
    check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, o, lse, do, bias=None, *, scale: float, kv_lens=None,
                           causal: bool = False, window: Optional[int] = None,
                           need_ds: bool = False):
    """The dQ kernel on CUDA tensors: (dq, delta [B, Hq, Tq] float32, dS
    [B, Hq, Tq, Tk] float32 or None).  Counted in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("the bf16 backward kernels take 16-byte aligned o and dO")
    dq = torch.empty_like(q)
    delta = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    ds = torch.zeros((b, hq, tq, tk), dtype=torch.float32, device=q.device) if need_ds else None
    bias, strides = _bias_args(bias, b, hq, tq, tk)
    with torch.cuda.device(q.device):
        err = kernels().mcl_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(ds), _ptr(bias), *strides,
            _ptr(kv_lens), b, tq, tk, hq, hk, d, _DTYPE_CODES[q.dtype], float(scale),
            int(causal), -1 if window is None else int(window), _stream(q))
    check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta, ds


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias=None, *, scale: float, kv_lens=None,
                            causal: bool = False, window: Optional[int] = None):
    """The dK/dV kernel on CUDA tensors, given the dQ kernel's ``delta``:
    (dk, dv).  Counted in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and do.data_ptr() % 16:
        raise ValueError("the bf16 backward kernels take a 16-byte aligned dO")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bias, strides = _bias_args(bias, b, hq, tq, tk)
    with torch.cuda.device(q.device):
        err = kernels().mcl_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(bias), *strides,
            _ptr(kv_lens), b, tq, tk, hq, hk, d, _DTYPE_CODES[q.dtype], float(scale),
            int(causal), -1 if window is None else int(window), _stream(q))
    check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward with lse, backward from the saved (q, k, v, o, lse): the
    kernels for CUDA tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, kv_lens, causal, window):
        if q.is_cuda:
            out, lse = _launch(q, k, v, bias, scale, kv_lens, causal, window, with_lse=True)
        else:
            out, lse = flash_attention_reference(q, k, v, bias, scale=scale, kv_lens=kv_lens,
                                                 causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, bias, kv_lens)
        ctx.mask = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse, bias, kv_lens = ctx.saved_tensors
        kw = dict(ctx.mask, kv_lens=kv_lens)
        need_db = ctx.needs_input_grad[3]
        if not q.is_cuda:
            dq, dk, dv, db = flash_attention_backward_reference(
                q, k, v, out, lse, grad_out, bias, **kw)
            return dq, dk, dv, db if need_db else None, None, None, None, None
        do = grad_out.contiguous()
        if do.data_ptr() % 16:  # a view at an odd offset: the bf16 kernels read 16 bytes at a time
            do = do.clone()
        dq, delta, ds = flash_attention_bwd_dq(q, k, v, out, lse, do, bias, need_ds=need_db,
                                               **kw)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias, **kw)
        db = _unbroadcast(ds, bias) if need_db else None
        return dq, dk, dv, db, None, None, None, None


def flash_attention(q, k, v, bias=None, *, scale: Optional[float] = None,
                    kv_lens=None, causal: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Attention over q [B, Tq, Hq, D], k/v [B, Tk, Hk, D]; returns
    [B, Tq, Hq, D] in q's dtype, differentiable in q, k, v and bias.  CUDA
    tensors run the K1 kernels (counted in ``flash_attention.launches``,
    ``flash_attention_bwd_dq.launches`` and
    ``flash_attention_bwd_dkv.launches``); CPU tensors run the plain
    versions."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    if q.device.type == "cuda":
        _check(q, k, v, bias, kv_lens)
    if grad:
        return _FlashAttention.apply(q, k, v, bias, scale, kv_lens, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, scale=scale, kv_lens=kv_lens,
                                         causal=causal, window=window)
    return _launch(q, k, v, bias, scale, kv_lens, causal, window)[0]


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0

__all__ = [
    "flash_attention",
    "flash_attention_backward_reference",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_reference",
    "key_mask",
]
