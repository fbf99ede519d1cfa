"""K6: the fused pre-LN attention sublayer (counterpart of
multimodal_concept_learning_tpu/ops/fused_attention_block.py).

    y = x + attn(LN(x)·Wqkv + bqkv)·Wo + bo

with ``attn`` the softmax attention of each sample's own keys below
``t_real``, per head of D (the kernels take ``attention_core.HEAD_DIMS``,
16, 32 or 64, and T <= 320; the float32 backward bblk·T <= 640 merged
rows, the bfloat16 backward any).  Layouts are the JAX package's: x [B, T, W],
``wqkv`` [W, 3·H·D] (columns [q | k | v], head-major within each),
``bqkv`` [3·H·D], ``wo`` [H·D, W], ``bo`` [W].

``fused_attention_fwd`` is the wrapper of the forward kernels of
``csrc/fused_attention_block.cu`` (the JAX ``_fwd_kernel``): LayerNorm, the
qkv projection and attention of one head over a block of whole samples in
one launch (bf16: after one that writes each row's LN statistics), so LN(x)
and qkv never reach device memory, then ``attn·Wo + bo + x`` in another;
it returns ``y`` and ``attn`` (the backward's residual, as the TPU kernel
writes it).  ``fused_bwd_attn`` wraps the backward kernels (the JAX
``_bwd_attn_kernel``): dqkv from the recomputed qkv and dA; bfloat16 on the
tensor cores (two launches, counted once: the pair K2 and K2-bd share,
``csrc/merged_bwd_tc.cuh``), float32 on the CUDA cores.  The
rest of the backward (the recompute of LN and qkv, the dWo / dbo / dA
products, the qkv-projection and LN backward) is plain tensor code, as the
JAX package leaves it to XLA; its five products go through ``mm_f32``: on
the card a bf16 product with float32 output (the JAX
``preferred_element_type=jnp.float32``), elsewhere float32.  Beside the
kernels are their plain versions (``fused_attention_reference``,
``fused_bwd_attn_reference``); CPU tensors take them, CUDA tensors the
kernels (or the wrapper raises).

Rounding points (the JAX ``_fused_fwd_impl`` and ``_fused_bwd``):
- forward: ``ln_scale``, ``ln_bias``, ``wqkv``, ``bqkv``, ``wo`` and ``bo``
  cast to the compute dtype (x's); LN in float32 with the rounded scale and
  bias; qkv = float32(LN→cdt · Wqkv) + bqkv, cast to cdt; P cast to cdt
  before P·V; ``attn`` cast to cdt; y = float32(attn·Wo) + bo + x, cast to
  x's dtype;
- backward: LN recomputed with the float32 ``ln_scale`` / ``ln_bias`` and
  qkv with the float32 ``bqkv`` (so a bf16 backward does not see the
  forward's rounded values); dS cast to cdt unscaled and D**-0.5 applied
  to each float32 product before its cast.

The JAX wrapper pads T to a multiple of 16 for the TPU; the port runs at T
(``attention_sublayer``: ``t_real = T``).
"""

from __future__ import annotations

import torch

from multimodal_concept_learning_tpu_torch.ops._build import SMEM_PER_BLOCK, cuda_operand
from multimodal_concept_learning_tpu_torch.ops.attention_core import (
    _DTYPE_CODES,
    _bwd_workspace,
    _scores_probs,
    _split,
    _stream,
    backward_from_probs,
    backward_max_rows,
    bd_block,
    check_kernel_shape,
    key_ok,
)

MAX_T = 320  # the forward keeps one sample's Q, K and V of a head in shared memory
# the bf16 forward's qkv-attention kernel (csrc/fused_attention_block.cu)
K6_PASS_ROWS = 128  # projection rows a pass: whole samples a CTA up to this many rows
K6_STAGES = 3  # its cp.async ring of operand chunks


def pack_qkv(wq, bq, wk, bk, wv, bv):
    """Three ``nn.Linear`` weights [H·D, W] and biases [H·D] -> the packed
    ``wqkv`` [W, 3·H·D] and ``bqkv`` [3·H·D] (the JAX ``pack_qkv`` layout)."""
    return torch.cat([wq.t(), wk.t(), wv.t()], dim=1), torch.cat([bq, bk, bv])


def _ln(x, scale, bias, eps: float):
    """The JAX ``_ln_forward``: (LN(x) float32, xhat, var) over the last dim."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return xhat * scale.float() + bias.float(), xhat, var


def mm_f32(a, b):
    """``a @ b`` (2-D) in float32 from operands in the compute dtype, the JAX
    ``jnp.dot(..., preferred_element_type=jnp.float32)``.  Two bf16 operands
    on the card: one bf16 product with float32 output
    (``torch.mm(..., out_dtype=torch.float32)``, the tensor cores with
    float32 accumulation).  Otherwise, and always on the CPU, both operands
    upcast and multiplied in float32.  A product of two bf16 numbers is
    exact in float32, so the two differ only in the order of the sums."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, eps: float):
    """(qkv [B, T, 3·H·D], LN(x) in cdt, xhat, var): qkv = float32(LN(x)→cdt
    · Wqkv→cdt) + float32(bqkv), cast to cdt = x's dtype.  The forward
    passes parameters already cast to cdt, the backward the float32 ones."""
    cdt = x.dtype
    ln, xhat, var = _ln(x, ln_scale, ln_bias, eps)
    ln16 = ln.to(cdt)
    qkv = mm_f32(ln16.reshape(-1, ln16.shape[-1]), wqkv.to(cdt))
    qkv = (qkv.reshape(*ln16.shape[:-1], -1) + bqkv.float()).to(cdt)
    return qkv, ln16, xhat, var


def _probs(qkv, heads: int, t_real: int):
    b, t, _ = qkv.shape
    q, k, v = _split(qkv, heads)
    _, p = _scores_probs(q, k, key_ok(b, t, t_real, False, None, qkv.device))
    return q, k, v, p


def fused_attention_reference(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                              t_real: int, ln_eps: float = 1e-12):
    """Plain PyTorch K6 forward: (y [B, T, W] in x's dtype, attn [B, T, H·D]
    in cdt), with the kernel's rounding points."""
    cdt = x.dtype
    lns, lnb, wqkv, bqkv, wo, bo = (a.to(cdt) for a in (ln_scale, ln_bias, wqkv, bqkv, wo, bo))
    qkv, _, _, _ = ln_qkv(x, lns, lnb, wqkv, bqkv, ln_eps)
    _, _, v, p = _probs(qkv, heads, t_real)
    b, t, _ = x.shape
    attn = torch.einsum("bhqk,bkhd->bqhd", p.to(cdt).float(), v.float()).to(cdt).reshape(b, t, -1)
    y = torch.matmul(attn.float(), wo.float()) + bo.float() + x.float()
    return y.to(x.dtype), attn


def fused_bwd_attn_reference(qkv, da, heads: int, t_real: int):
    """Plain PyTorch K6 backward kernel: dqkv [B, T, 3·H·D] in qkv's dtype
    from qkv and dA [B, T, H·D] (keys at or past ``t_real`` masked)."""
    q, k, v, p = _probs(qkv, heads, t_real)
    return backward_from_probs(q, k, v, p, da.to(qkv.dtype).reshape(q.shape), scale_after=True)


def _check(x, wqkv, wo, heads: int) -> int:
    """The forward kernels' shape checks; returns the head dim."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused attention kernels take float32/bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"expected x [B, T, W], got {tuple(x.shape)}")
    b, t, width = x.shape
    hd = wo.shape[0]
    if hd % heads or tuple(wqkv.shape) != (width, 3 * hd) or tuple(wo.shape) != (hd, width):
        raise ValueError(f"fused attention kernels take wqkv [{width}, 3·H·D] and wo [H·D, "
                         f"{width}] for {heads} heads, got {tuple(wqkv.shape)} and "
                         f"{tuple(wo.shape)}")
    if width % 32:
        raise ValueError(f"fused attention kernels take a width that is a multiple of 32, "
                         f"got {width}")
    check_kernel_shape("fused attention forward kernels (T rows)", hd // heads, t, MAX_T)
    return hd // heads


def k6_fwd_plan(b: int, t: int, d: int, width: int):
    """(samples a CTA, CTAs a head, chunk depth, shared-memory bytes) of
    the bf16 forward's qkv-attention kernel: whole samples up to
    ``K6_PASS_ROWS`` rows a CTA (one sample past that), the reduction in
    64-deep chunks where the width and the shared memory allow, else 32.
    Its shared memory holds the bf16 LN scale and bias [width], the float32
    LN statistics, bf16 Q, K and V rows (stride D + 8) and a ring of
    ``K6_STAGES`` operand chunks (qkv_attn_smem of
    csrc/fused_attention_block.cu)."""
    bblk = max(1, min(b, K6_PASS_ROWS // t))
    rows = bblk * t

    def smem(bk):
        return (4 * width + 8 * (-(-rows // 4) * 4) + 3 * rows * (d + 8) * 2
                + K6_STAGES * (K6_PASS_ROWS * (bk + 8) + bk * (3 * d + 8)) * 2)

    bk = 64 if width % 64 == 0 and smem(64) <= SMEM_PER_BLOCK else 32
    return bblk, -(-b // bblk), bk, smem(bk)


def _cuda_operand(a, dtype):
    return cuda_operand(a.to(dtype))


def fused_attention_fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int, t_real: int,
                        ln_eps: float = 1e-12):
    """The K6 forward kernels on CUDA tensors: (y [B, T, W], attn [B, T,
    H·D]).  bf16: three launches on the tensor cores (each row's LN
    statistics into a float32 workspace; LN + qkv + attention per (head,
    block of whole samples, ``k6_fwd_plan``); the output projection with
    bias and residual); float32: two on the CUDA cores (LN + qkv +
    attention per (head, sample); the output projection).  Counted once a
    call in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    d = _check(x, wqkv, wo, heads)
    cdt = x.dtype
    x = _cuda_operand(x, cdt)
    lns, lnb, wqkv, bqkv, wo, bo = (_cuda_operand(a, cdt)
                                    for a in (ln_scale, ln_bias, wqkv, bqkv, wo, bo))
    b, t, width = x.shape
    y = torch.empty_like(x)
    attn = torch.empty((b, t, heads * d), dtype=cdt, device=x.device)
    bblk, ws = 1, None
    if cdt == torch.bfloat16:
        bblk, _, _, smem = k6_fwd_plan(b, t, d, width)
        if smem > SMEM_PER_BLOCK:
            raise ValueError(f"fused attention forward kernel: T {t} at head dim {d} needs "
                             f"{smem} bytes of shared memory")
        ws = torch.empty(2 * b * t, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = kernels().mcl_fused_attention_fwd(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), attn.data_ptr(),
            None if ws is None else ws.data_ptr(), b, t, width, heads, d, int(t_real),
            float(ln_eps), d ** -0.5, bblk, _DTYPE_CODES[cdt], _stream(x))
    check(err, "fused_attention_fwd")
    fused_attention_fwd.launches += 1
    return y, attn


def fused_bwd_attn(qkv, da, heads: int, t_real: int, bblk=None):
    """The K6 backward kernels on CUDA tensors: dqkv [B, T, 3·H·D] from qkv
    and dA, with lse and rowsum(dP∘P) recomputed inside.  bf16: two
    launches on the tensor cores over 16-row slots of one sample each (lse
    and rowsum(dP∘P) pass between them through a float32 workspace;
    ``bblk`` is checked but not read); float32: one CTA per (head, block of
    ``bblk`` whole samples merged into rows, default ``bd_block(T)``).
    Counted once a call in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, hd3 = qkv.shape
    if qkv.dtype not in _DTYPE_CODES or hd3 % (3 * heads):
        raise ValueError(f"fused attention backward kernel takes float32/bfloat16 qkv [B, T, "
                         f"3 x {heads} x D], got {qkv.dtype} {tuple(qkv.shape)}")
    d = hd3 // (3 * heads)
    bblk = bd_block(t) if bblk is None else int(bblk)
    check_kernel_shape(f"fused attention backward kernel (bblk {bblk} x T {t} merged rows)",
                       d, bblk * t, backward_max_rows(qkv.dtype))
    qkv = _cuda_operand(qkv, qkv.dtype)
    da = _cuda_operand(da, qkv.dtype)
    dqkv = torch.empty_like(qkv)
    ws = _bwd_workspace(qkv, heads)
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_fused_attention_bwd(
            qkv.data_ptr(), da.data_ptr(), dqkv.data_ptr(), None if ws is None else ws.data_ptr(),
            b, t, heads, d, int(t_real), d ** -0.5, bblk, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "fused_bwd_attn")
    fused_bwd_attn.launches += 1
    return dqkv


class _FusedSublayer(torch.autograd.Function):
    """The K6 kernels for CUDA tensors, the plain versions for CPU tensors;
    the backward follows the JAX ``_fused_bwd``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads, t_real, ln_eps):
        fwd = fused_attention_fwd if x.is_cuda else fused_attention_reference
        y, attn = fwd(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads, t_real, ln_eps)
        ctx.save_for_backward(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, attn)
        ctx.args = (heads, t_real, ln_eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, attn = ctx.saved_tensors
        heads, t_real, eps = ctx.args
        b, t, width = x.shape
        cdt = x.dtype
        qkv, ln16, xhat, var = ln_qkv(x, ln_scale, ln_bias, wqkv, bqkv, eps)
        dyf = dy.reshape(-1, width).float()
        dy16 = dy.reshape(-1, width).to(cdt)
        dwo = mm_f32(attn.reshape(-1, attn.shape[-1]).t(), dy16)
        dbo = dyf.sum(dim=0)
        da = mm_f32(dy16, wo.to(cdt).t()).to(cdt).reshape(attn.shape)
        bwd = fused_bwd_attn if qkv.is_cuda else fused_bwd_attn_reference
        dqkv = bwd(qkv, da, heads, t_real).reshape(-1, qkv.shape[-1])
        dwqkv = mm_f32(ln16.reshape(-1, width).t(), dqkv)
        dbqkv = dqkv.float().sum(dim=0)
        dln = mm_f32(dqkv, wqkv.to(cdt).t())
        xhat, var = xhat.reshape(-1, width), var.reshape(-1, 1)
        dxhat = dln * ln_scale.float()
        dx_ln = torch.rsqrt(var + eps) * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                                          - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        dx = (dyf + dx_ln).to(x.dtype).reshape(b, t, width)
        return (dx, (dln * xhat).sum(dim=0).to(ln_scale.dtype), dln.sum(dim=0).to(ln_bias.dtype),
                dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype), dwo.to(wo.dtype), dbo.to(bo.dtype),
                None, None, None)


def fused_attention_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                             t_real: int, ln_eps: float = 1e-12) -> torch.Tensor:
    """x [B, T, W] -> x + attn·Wo + bo (module docstring), differentiable in
    x and every parameter; keys at or past ``t_real`` are masked.  CUDA
    tensors run the K6 kernels, CPU tensors the plain versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cpu or cuda tensors, got {x.device}")
    return _FusedSublayer.apply(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads, t_real, ln_eps)


def attention_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads: int,
                       ln_eps: float = 1e-12) -> torch.Tensor:
    """Any-T entry with the JAX signature: ``fused_attention_sublayer`` with
    ``t_real = T`` (the JAX wrapper pads T to a multiple of 16 for the TPU)."""
    return fused_attention_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo, heads, x.shape[1],
                                    ln_eps)


fused_attention_fwd.launches = 0
fused_bwd_attn.launches = 0

__all__ = [
    "MAX_T",
    "attention_sublayer",
    "fused_attention_fwd",
    "fused_attention_reference",
    "fused_attention_sublayer",
    "fused_bwd_attn",
    "fused_bwd_attn_reference",
    "k6_fwd_plan",
    "ln_qkv",
    "mm_f32",
    "pack_qkv",
]
