"""K2: token-major attention core on the packed qkv projection output.

    qkv [B, T, 3·H·D]  ->  attn [B, T, H·D]

Column ``part·H·D + h·D + d`` of ``qkv`` holds part q/k/v (0/1/2) of head
``h``; the output is token-major, so the o-projection reads it with no
relayout, and the backward writes ``dqkv`` in the packed layout.

``attention_core`` is the wrapper of two CUDA kernels in
``csrc/attention_core.cu``, which replace the Pallas TPU kernels of
``multimodal_concept_learning_tpu/ops/attention_core.py``:

- ``attention_core_fwd`` (``_fwd_kernel``): the output and, when a gradient
  is needed, the row logsumexp [B, H, T] in float32;
- ``attention_core_bwd`` (``_bwd_kernel``): ``dqkv`` from the saved qkv,
  output and logsumexp.

Beside them are the plain PyTorch versions (``attention_core_reference``,
``attention_core_backward_reference``): the wrapper runs them for CPU
tensors, and tests and ``chip_smoke.py`` hold the kernels against them.  A
CUDA tensor always goes to the kernels (or the wrapper raises).

Semantics (the JAX kernel's): scores ``q·kᵀ`` in float32 times ``D**-0.5``;
a key is masked when it is at or past ``t_real``, after the query under
``causal``, or where ``kv_mask`` is 0 (a mask shorter than T is
zero-padded); softmax in float32; the probabilities cast to the compute
dtype before ``P·V``.  Backward: ``dP = dA·Vᵀ``, ``dS = P∘(dP − rowsum(dP∘P))``,
``dS·D**-0.5`` cast to the compute dtype before ``dQ = dS·K`` and
``dK = dSᵀ·Q``, and ``dV = Pᵀ·dA``.  One difference: a query row with no
valid key gets a zero output and no gradient here; the JAX kernel gives it
a uniform average over all keys (such rows never occur on the CLIP path).

The JAX package pads T to a multiple of 16 (a TPU sublane rule); the port
runs at T.  The sample-merged block-diagonal variants (``block_diag=True``)
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30  # the JAX kernel's finite mask value
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64  # the only head dim the kernels are built for (every ViT/CLIP preset)
MAX_T_BWD = 640  # the backward keeps a [T, 64] float32 dQ tile in shared memory


def _split(qkv: torch.Tensor, heads: int):
    """(q, k, v) views [B, T, H, D] of the packed layout."""
    b, t, hd3 = qkv.shape
    return qkv.view(b, t, 3, heads, hd3 // (3 * heads)).unbind(2)


def _padded_mask(kv_mask, b: int, t: int, device) -> Optional[torch.Tensor]:
    """``kv_mask`` [B, T'] (T' <= T) as an int32 [B, T] tensor, zero-padded."""
    if kv_mask is None:
        return None
    kvm = kv_mask.to(device=device, dtype=torch.int32)
    if kvm.shape[1] != t:
        kvm = torch.nn.functional.pad(kvm, (0, t - kvm.shape[1]))
    if kvm.shape != (b, t):
        raise ValueError(f"kv_mask must be [B, <=T] = [{b}, <={t}], got {tuple(kv_mask.shape)}")
    return kvm.contiguous()


def key_ok(b: int, t: int, t_real: int, causal: bool, kvm, device) -> torch.Tensor:
    """[B|1, 1, T, T] bool, True where query row r may attend key c."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    ok = (cols < t_real).expand(t, t)
    if causal:
        ok = ok & (cols <= rows)
    ok = ok[None, None]
    if kvm is not None:
        ok = ok & (kvm != 0)[:, None, None, :]
    return ok


def _scores_probs(q, k, ok):
    """(scaled float32 scores, probabilities) [B, H, T, T]; the
    probabilities are zero on rows with no valid key."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    p = torch.softmax(torch.where(ok, s, _NEG), dim=-1)
    return s, p * ok.any(dim=-1, keepdim=True)


def attention_core_reference(qkv, heads: int, t_real: int, causal: bool = False,
                             kv_mask=None, return_lse: bool = False):
    """Plain PyTorch K2 forward: [B, T, H·D] in qkv's dtype; with
    ``return_lse`` also the row logsumexp [B, H, T] float32 (+inf on rows
    with no valid key), as the forward kernel writes it."""
    b, t, _ = qkv.shape
    q, k, v = _split(qkv, heads)
    ok = key_ok(b, t, t_real, causal, _padded_mask(kv_mask, b, t, qkv.device), qkv.device)
    s, p = _scores_probs(q, k, ok)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(qkv.dtype), v).reshape(b, t, -1)
    if not return_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)
    return out, torch.where(torch.isneginf(lse), float("inf"), lse)


def attention_core_backward_reference(qkv, d_out, heads: int, t_real: int,
                                      causal: bool = False, kv_mask=None):
    """Plain PyTorch K2 backward: dqkv [B, T, 3·H·D] in qkv's dtype."""
    b, t, _ = qkv.shape
    cdt = qkv.dtype
    q, k, v = _split(qkv, heads)
    ok = key_ok(b, t, t_real, causal, _padded_mask(kv_mask, b, t, qkv.device), qkv.device)
    _, p = _scores_probs(q, k, ok)
    da = d_out.to(cdt).reshape(q.shape)
    dp = torch.einsum("bqhd,bkhd->bhqk", da.float(), v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds16 = (ds * q.shape[-1] ** -0.5).to(cdt)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(cdt), da)
    return torch.stack([dq, dk, dv], dim=2).reshape(qkv.shape).to(cdt)


def _check(qkv, heads: int) -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_core kernel takes float32/bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"expected qkv [B, T, 3·H·D] with H={heads}, got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // (3 * heads)
    if d != HEAD_DIM:
        raise ValueError(f"attention_core kernel takes head dim {HEAD_DIM}, got {d}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention_core kernel takes a contiguous, 16-byte aligned qkv")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_core_fwd(qkv, heads: int, t_real: int, causal: bool, kvm, with_lse: bool):
    """The forward kernel on CUDA tensors (``kvm``: int32 [B, T] or None):
    (out [B, T, H·D], lse [B, H, T] float32 or None).  Counted in
    ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, hd3 = qkv.shape
    out = torch.empty((b, t, hd3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device) if with_lse else None
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_fwd(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if kvm is None else kvm.data_ptr(), b, t, heads, HEAD_DIM, int(t_real),
            int(causal), HEAD_DIM ** -0.5, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "attention_core_fwd")
    attention_core_fwd.launches += 1
    return out, lse


def attention_core_bwd(qkv, out, d_out, lse, heads: int, t_real: int, causal: bool, kvm):
    """The backward kernel on CUDA tensors: dqkv [B, T, 3·H·D] in qkv's
    dtype, from the forward's ``out`` and ``lse``.  Counted in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, _ = qkv.shape
    if t > MAX_T_BWD:
        raise ValueError(f"attention_core backward kernel takes T <= {MAX_T_BWD}, got {t}")
    d_out = d_out.to(qkv.dtype).contiguous()
    if d_out.data_ptr() % 16:  # the kernel reads dA with 16-byte loads
        d_out = d_out.clone()
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_bwd(
            qkv.data_ptr(), out.data_ptr(), d_out.data_ptr(), lse.data_ptr(),
            None if kvm is None else kvm.data_ptr(), dqkv.data_ptr(), b, t, heads, HEAD_DIM,
            int(t_real), int(causal), HEAD_DIM ** -0.5, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "attention_core_bwd")
    attention_core_bwd.launches += 1
    return dqkv


class _AttentionCore(torch.autograd.Function):
    """The kernels for CUDA tensors, the plain versions for CPU tensors;
    ``kv_mask`` gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, kvm, heads, t_real, causal):
        if qkv.is_cuda:
            out, lse = attention_core_fwd(qkv, heads, t_real, causal, kvm, with_lse=True)
            ctx.save_for_backward(qkv, kvm, out, lse)
        else:
            out = attention_core_reference(qkv, heads, t_real, causal, kvm)
            ctx.save_for_backward(qkv, kvm)
        ctx.args = (heads, t_real, causal)
        return out

    @staticmethod
    def backward(ctx, d_out):
        heads, t_real, causal = ctx.args
        if d_out.is_cuda:
            qkv, kvm, out, lse = ctx.saved_tensors
            dqkv = attention_core_bwd(qkv, out, d_out, lse, heads, t_real, causal, kvm)
        else:
            qkv, kvm = ctx.saved_tensors
            dqkv = attention_core_backward_reference(qkv, d_out, heads, t_real, causal, kvm)
        return dqkv, None, None, None, None


def attention_core(qkv, heads: int, t_real: int, causal: bool = False, kv_mask=None,
                   block_diag=None) -> torch.Tensor:
    """Packed token-major attention: qkv [B, T, 3·H·D] -> [B, T, H·D] in
    qkv's dtype, differentiable in qkv.  ``kv_mask`` [B, <=T] (nonzero =
    valid key) masks per-sample padding.  CUDA tensors run the K2 kernels
    (counted in ``attention_core_fwd.launches`` and
    ``attention_core_bwd.launches``); CPU tensors the plain versions."""
    if block_diag:
        raise NotImplementedError("the block-diagonal attention core (block_diag=True) is not "
                                  "ported yet (ROADMAP.md, queue B)")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_core runs on cpu or cuda tensors, got {qkv.device}")
    b, t, _ = qkv.shape
    kvm = _padded_mask(kv_mask, b, t, qkv.device)
    if qkv.is_cuda:
        _check(qkv, heads)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _AttentionCore.apply(qkv, kvm, heads, t_real, causal)
    if qkv.is_cuda:
        return attention_core_fwd(qkv, heads, t_real, causal, kvm, with_lse=False)[0]
    return attention_core_reference(qkv, heads, t_real, causal, kvm)


def attention_core_padded(qkv, heads: int, causal: bool = False, kv_mask=None,
                          block_diag=None) -> torch.Tensor:
    """Any-T entry with the JAX signature.  The JAX wrapper pads T to a
    multiple of 16 for the TPU; the kernels take any T, so this is
    ``attention_core`` with ``t_real = T``."""
    return attention_core(qkv, heads, qkv.shape[1], causal, kv_mask, block_diag)


attention_core_fwd.launches = 0
attention_core_bwd.launches = 0

__all__ = [
    "attention_core",
    "attention_core_backward_reference",
    "attention_core_bwd",
    "attention_core_fwd",
    "attention_core_padded",
    "attention_core_reference",
    "key_ok",
]
