"""K2: token-major attention core on the packed qkv projection output.

    qkv [B, T, 3·H·D]  ->  attn [B, T, H·D]

Column ``part·H·D + h·D + d`` of ``qkv`` holds part q/k/v (0/1/2) of head
``h``; the output is token-major, so the o-projection reads it with no
relayout, and the backward writes ``dqkv`` in the packed layout.

``attention_core`` is the wrapper of two CUDA kernels in
``csrc/attention_core.cu``, which replace the Pallas TPU kernels of
``multimodal_concept_learning_tpu/ops/attention_core.py``:

- ``attention_core_fwd`` (``_fwd_kernel``): the output and, when a gradient
  is needed, the row logsumexp [B, H, T] in float32; bfloat16 on the
  tensor cores, float32 on the CUDA cores;
- ``attention_core_bwd`` (``_bwd_kernel``): ``dqkv``; bfloat16 on the
  tensor cores from qkv and dA alone (``csrc/merged_bwd_tc.cuh``, the pair
  K2-bd and K6 share, which recomputes the logsumexp, so a bfloat16
  forward for training keeps neither its output nor a logsumexp), float32
  on the CUDA cores from the saved qkv, output and logsumexp.

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
runs at T.  The kernels take head dims 16, 32 and 64 (``HEAD_DIMS``: 16
and 64 cover every ViT and CLIP preset; no preset has 32); the float32
backward at most 640 rows (T, or bblk·T merged), the bfloat16 backward any
number (``backward_max_rows``); ``check_kernel_shape`` refuses anything
else with a ValueError.

K2-bd, the sample-merged (block-diagonal) variants, compute the same
function on rows merged across samples: ``attention_core_bd_fwd`` and
``attention_core_bd_bwd`` (``csrc/attention_core_bd.cu``) replace
``_fwd_kernel_bd`` and ``_bwd_kernel_bd`` of the JAX module; both run
bfloat16 on the tensor cores over each tile's compacted live keys
(``csrc/merged_tiles.cuh``; the backward through the pair K2 and K6 share)
and float32 on the CUDA cores.  Their plain
versions (``attention_core_bd_reference``,
``attention_core_bd_backward_reference``) build the JAX ``_flat_mask`` of a
stated block of ``bblk`` samples; cross-sample keys are masked, so every
row with a valid key equals K2's, and with the port's zero rows the block
size changes nothing.  ``block_diag=None`` reads ``MCL_ATTN_CORE_BD`` at
each call ("1": K2-bd), as the JAX ``_block_diag_default`` does.  The JAX
block pickers (``_pick_bblk``, ``MCL_ATTN_CORE_BBLK``) size TPU VMEM
blocks and are not ported: the kernels pick their own merge.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.ops._build import cuda_operand
from multimodal_concept_learning_tpu_torch.utils.profiling import span

_NEG = -1e30  # the JAX kernel's finite mask value
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)  # built head dims: 16 (vit-t-8) and 64 (every other ViT/CLIP preset)
MAX_T_BWD = 640  # the float32 backward keeps a [T, D] float32 dQ tile in shared memory
BD_ROWS = 256  # K2-bd backward: whole samples merged into about this many rows a CTA


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


def backward_from_probs(q, k, v, p, da, scale_after: bool = False) -> torch.Tensor:
    """dqkv [B, T, 3·H·D] in q's dtype from the float32 probabilities ``p``
    [B, H, T, T] and dA [B, T, H, D].  K2's rounding: ``dS·D**-0.5`` cast to
    the compute dtype before ``dQ = dS·K`` and ``dK = dSᵀ·Q``; with
    ``scale_after`` (K6's): ``dS`` cast unscaled, the scale applied to each
    float32 product before its cast.  ``P`` is cast before ``dV = Pᵀ·dA``."""
    cdt = q.dtype
    scale = q.shape[-1] ** -0.5
    dp = torch.einsum("bqhd,bkhd->bhqk", da.float(), v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if scale_after:
        ds16 = ds.to(cdt)
        dq = (torch.einsum("bhqk,bkhd->bqhd", ds16.float(), k.float()) * scale).to(cdt)
        dk = (torch.einsum("bhqk,bqhd->bkhd", ds16.float(), q.float()) * scale).to(cdt)
    else:
        ds16 = (ds * scale).to(cdt)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds16, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds16, q)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(cdt), da)
    b, t, h, d = q.shape
    return torch.stack([dq, dk, dv], dim=2).reshape(b, t, 3 * h * d).to(cdt)


def attention_core_backward_reference(qkv, d_out, heads: int, t_real: int,
                                      causal: bool = False, kv_mask=None):
    """Plain PyTorch K2 backward: dqkv [B, T, 3·H·D] in qkv's dtype."""
    b, t, _ = qkv.shape
    q, k, v = _split(qkv, heads)
    ok = key_ok(b, t, t_real, causal, _padded_mask(kv_mask, b, t, qkv.device), qkv.device)
    _, p = _scores_probs(q, k, ok)
    return backward_from_probs(q, k, v, p, d_out.to(qkv.dtype).reshape(q.shape))


def _merged(qkv, kvm, bblk: int):
    """qkv [B, T, F] and the int32 mask [B, T] (None: all ones) as blocks of
    ``bblk`` samples merged into rows: [B', bblk·T, F] and [B', bblk·T],
    B' = ceil(B / bblk); the samples added to fill the last block have no
    valid key."""
    b, t, f = qkv.shape
    nblk = -(-b // bblk)
    pad = nblk * bblk - b
    kvm = torch.ones((b, t), dtype=torch.int32, device=qkv.device) if kvm is None else kvm
    if pad:
        qkv = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
        kvm = torch.nn.functional.pad(kvm, (0, 0, 0, pad))
    return qkv.reshape(nblk, bblk * t, f), kvm.reshape(nblk, bblk * t)


def _flat_mask(bblk: int, t: int, t_real: int, causal: bool, kvm_rows, device) -> torch.Tensor:
    """The JAX ``_flat_mask``: [B', 1, R, R] bool over R = bblk·T merged
    rows, True where row r may attend key c: the same sample, ``c`` below
    ``t_real``, not after ``r`` under ``causal``, kept by ``kvm_rows`` [B', R]."""
    r = torch.arange(bblk * t, device=device)
    rows, cols = r[:, None], r[None, :]
    tok_c = cols % t
    ok = (rows // t == cols // t) & (tok_c < t_real)
    if causal:
        ok = ok & (tok_c <= rows % t)
    return ok[None, None] & (kvm_rows != 0)[:, None, None, :]


def _bd_probs(qkv, heads, t_real, causal, kvm, bblk):
    """(q, k, v [B', R, H, D] merged, float32 scores and probabilities
    [B', H, R, R], mask)."""
    b, t, _ = qkv.shape
    flat, kvm_rows = _merged(qkv, kvm, bblk)
    q, k, v = _split(flat, heads)
    ok = _flat_mask(bblk, t, t_real, causal, kvm_rows, qkv.device)
    s, p = _scores_probs(q, k, ok)
    return q, k, v, s, p, ok


def attention_core_bd_reference(qkv, heads: int, t_real: int, causal: bool = False,
                                kv_mask=None, bblk: int = 2, return_lse: bool = False):
    """Plain PyTorch K2-bd forward over blocks of ``bblk`` samples merged
    into rows (the last block filled with samples that have no valid key):
    [B, T, H·D] in qkv's dtype, and with ``return_lse`` the row logsumexp
    [B, H, T] float32 (+inf on rows with no valid key)."""
    b, t, _ = qkv.shape
    _, _, v, s, p, ok = _bd_probs(qkv, heads, t_real, causal,
                                  _padded_mask(kv_mask, b, t, qkv.device), bblk)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(qkv.dtype), v)
    out = out.reshape(-1, t, out.shape[-2] * out.shape[-1])[:b]
    if not return_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)  # [B', H, R]
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    lse = lse.reshape(lse.shape[0], heads, -1, t).transpose(1, 2).reshape(-1, heads, t)
    return out, lse[:b]


def attention_core_bd_backward_reference(qkv, d_out, heads: int, t_real: int,
                                         causal: bool = False, kv_mask=None, bblk: int = 2):
    """Plain PyTorch K2-bd backward: dqkv [B, T, 3·H·D] in qkv's dtype."""
    b, t, f = qkv.shape
    q, k, v, _, p, _ = _bd_probs(qkv, heads, t_real, causal,
                                 _padded_mask(kv_mask, b, t, qkv.device), bblk)
    da, _ = _merged(d_out.to(qkv.dtype).reshape(b, t, -1), None, bblk)
    dqkv = backward_from_probs(q, k, v, p, da.reshape(q.shape))
    return dqkv.reshape(-1, t, f)[:b]


def backward_max_rows(dtype) -> Optional[int]:
    """The most rows (T, or bblk·T merged) the K2, K2-bd and K6 backward
    kernels take in ``dtype``: ``MAX_T_BWD`` for float32, whose CUDA-core
    kernels keep a [rows, D] dQ tile in shared memory; None (no cap) for
    bfloat16, whose tensor-core pair stages its rows in chunks."""
    return None if dtype == torch.bfloat16 else MAX_T_BWD


def check_kernel_shape(what: str, head_dim: int, rows: Optional[int] = None,
                       max_rows: Optional[int] = MAX_T_BWD) -> None:
    """The shapes the K2, K2-bd and K6 kernels are built for: a head dim in
    ``HEAD_DIMS`` and, where a kernel keeps rows in shared memory, ``0 <
    rows <= max_rows`` (``max_rows`` None: ``0 < rows``).  Raises ValueError
    naming ``what`` otherwise."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{what} takes head dim in {HEAD_DIMS}, got {head_dim}")
    if rows is not None and not (0 < rows and (max_rows is None or rows <= max_rows)):
        raise ValueError(f"{what} takes 0 < rows <= {max_rows}, got {rows}")


def _head_dim(qkv, heads: int) -> int:
    return qkv.shape[-1] // (3 * heads)


def _check(qkv, heads: int) -> None:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_core kernel takes float32/bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"expected qkv [B, T, 3·H·D] with H={heads}, got {tuple(qkv.shape)}")
    check_kernel_shape("attention_core kernel", _head_dim(qkv, heads))


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention_core_fwd(qkv, heads: int, t_real: int, causal: bool, kvm, with_lse: bool):
    """The forward kernel on CUDA tensors (``kvm``: int32 [B, T] or None):
    (out [B, T, H·D], lse [B, H, T] float32 or None).  Counted in
    ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, hd3 = qkv.shape
    d = _head_dim(qkv, heads)
    out = torch.empty((b, t, hd3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device) if with_lse else None
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_fwd(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if kvm is None else kvm.data_ptr(), b, t, heads, d, int(t_real),
            int(causal), d ** -0.5, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "attention_core_fwd")
    attention_core_fwd.launches += 1
    return out, lse


def _bwd_workspace(qkv, heads: int):
    """The bfloat16 backward's float32 lse and rowsum(dP∘P) [2, H, B·T];
    None for float32."""
    if qkv.dtype != torch.bfloat16:
        return None
    return torch.empty((2, heads, qkv.shape[0] * qkv.shape[1]), dtype=torch.float32,
                       device=qkv.device)


def _forward_residuals(what: str, qkv, out, lse):
    """The pointers of the forward's ``out`` and ``lse`` that a backward
    kernel reads: both for float32; neither for bfloat16, whose tensor-core
    pair recomputes lse from qkv and dA (so both must be None)."""
    if qkv.dtype == torch.bfloat16:
        if out is not None or lse is not None:
            raise ValueError(f"{what}: the bfloat16 kernels recompute lse from qkv and dA; "
                             "pass out=None and lse=None")
        return None, None
    if out is None or lse is None:
        raise ValueError(f"{what}: the float32 kernel reads the forward's out and lse")
    return out.data_ptr(), lse.data_ptr()


def attention_core_bwd(qkv, out, d_out, lse, heads: int, t_real: int, causal: bool, kvm):
    """The backward kernel on CUDA tensors: dqkv [B, T, 3·H·D] in qkv's
    dtype.  bfloat16: two launches on the tensor cores over 16-row slots of
    one sample each, from qkv and dA alone (``out`` and ``lse`` None: lse
    and rowsum(dP∘P) are recomputed, through a workspace allocated here);
    float32: one CTA per (head, sample) on the CUDA cores from the
    forward's ``out`` and ``lse``.  Counted once a call in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, _ = qkv.shape
    d = _head_dim(qkv, heads)
    check_kernel_shape("attention_core backward kernel", d, t, backward_max_rows(qkv.dtype))
    out_p, lse_p = _forward_residuals("attention_core backward kernel", qkv, out, lse)
    d_out = cuda_operand(d_out.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    ws = _bwd_workspace(qkv, heads)
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_bwd(
            qkv.data_ptr(), out_p, d_out.data_ptr(), lse_p,
            None if kvm is None else kvm.data_ptr(), dqkv.data_ptr(),
            None if ws is None else ws.data_ptr(), b, t, heads, d,
            int(t_real), int(causal), d ** -0.5, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "attention_core_bwd")
    attention_core_bwd.launches += 1
    return dqkv


def bd_block(t: int) -> int:
    """Samples merged into one CTA of the K2-bd and K6 float32 backward
    (the bfloat16 pair groups rows in slots of one sample and does not read
    it): whole samples filling about ``BD_ROWS`` rows (at least one)."""
    return max(1, BD_ROWS // t)


def attention_core_bd_fwd(qkv, heads: int, t_real: int, causal: bool, kvm, with_lse: bool):
    """The K2-bd forward kernel on CUDA tensors (``kvm``: int32 [B, T] or
    None): bfloat16 on the tensor cores, one CTA per (4 slots of 16 rows,
    each of one sample, head); float32 on the CUDA cores, one CTA per (64
    rows merged across samples, head).  Returns (out [B, T, H·D], lse
    [B, H, T] float32 or None).  Counted in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, hd3 = qkv.shape
    d = _head_dim(qkv, heads)
    out = torch.empty((b, t, hd3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device) if with_lse else None
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_bd_fwd(
            qkv.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if kvm is None else kvm.data_ptr(), b, t, heads, d, int(t_real),
            int(causal), d ** -0.5, _DTYPE_CODES[qkv.dtype], _stream(qkv))
    check(err, "attention_core_bd_fwd")
    attention_core_bd_fwd.launches += 1
    return out, lse


def attention_core_bd_bwd(qkv, out, d_out, lse, heads: int, t_real: int, causal: bool, kvm,
                          bblk: Optional[int] = None):
    """The K2-bd backward kernel on CUDA tensors: dqkv [B, T, 3·H·D].
    bfloat16: K2's kernels (the two compute one function): two launches on
    the tensor cores over 16-row slots of one sample each, from qkv and dA
    alone (``out`` and ``lse`` None; ``bblk`` is checked but not read);
    float32: one CTA per (head, block of ``bblk`` whole samples merged into
    rows, default ``bd_block(T)``) on the CUDA cores, from the forward's
    ``out`` and ``lse``.  Counted once a call in ``.launches``."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    b, t, _ = qkv.shape
    d = _head_dim(qkv, heads)
    bblk = bd_block(t) if bblk is None else int(bblk)
    check_kernel_shape(f"attention_core_bd backward kernel (bblk {bblk} x T {t} merged rows)",
                       d, bblk * t, backward_max_rows(qkv.dtype))
    out_p, lse_p = _forward_residuals("attention_core_bd backward kernel", qkv, out, lse)
    d_out = cuda_operand(d_out.to(qkv.dtype))
    dqkv = torch.empty_like(qkv)
    ws = _bwd_workspace(qkv, heads)
    with torch.cuda.device(qkv.device):
        err = kernels().mcl_attention_core_bd_bwd(
            qkv.data_ptr(), out_p, d_out.data_ptr(), lse_p,
            None if kvm is None else kvm.data_ptr(), dqkv.data_ptr(),
            None if ws is None else ws.data_ptr(), b, t, heads, d,
            int(t_real), int(causal), d ** -0.5, bblk, _DTYPE_CODES[qkv.dtype],
            _stream(qkv))
    check(err, "attention_core_bd_bwd")
    attention_core_bd_bwd.launches += 1
    return dqkv


class _AttentionCore(torch.autograd.Function):
    """K2 (or K2-bd with ``bd``) for CUDA tensors, the plain versions for
    CPU tensors; ``kv_mask`` gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, kvm, heads, t_real, causal, bd):
        if qkv.is_cuda:
            fwd = attention_core_bd_fwd if bd else attention_core_fwd
            # the bfloat16 backward recomputes lse from qkv and dA: no out or lse kept
            keep = qkv.dtype != torch.bfloat16
            out, lse = fwd(qkv, heads, t_real, causal, kvm, with_lse=keep)
            ctx.save_for_backward(qkv, kvm, out if keep else None, lse)
        else:
            ref = attention_core_bd_reference if bd else attention_core_reference
            out = ref(qkv, heads, t_real, causal, kvm)
            ctx.save_for_backward(qkv, kvm)
        ctx.args = (heads, t_real, causal, bd)
        return out

    @staticmethod
    def backward(ctx, d_out):
        heads, t_real, causal, bd = ctx.args
        if d_out.is_cuda:
            qkv, kvm, out, lse = ctx.saved_tensors
            bwd = attention_core_bd_bwd if bd else attention_core_bwd
            dqkv = bwd(qkv, out, d_out, lse, heads, t_real, causal, kvm)
        else:
            qkv, kvm = ctx.saved_tensors
            ref = attention_core_bd_backward_reference if bd else attention_core_backward_reference
            dqkv = ref(qkv, d_out, heads, t_real, causal, kvm)
        return dqkv, None, None, None, None, None


def _block_diag_default() -> bool:
    """``MCL_ATTN_CORE_BD=1`` selects K2-bd; read at each call."""
    return os.environ.get("MCL_ATTN_CORE_BD", "0") == "1"


def attention_core(qkv, heads: int, t_real: int, causal: bool = False, kv_mask=None,
                   block_diag=None) -> torch.Tensor:
    """Packed token-major attention: qkv [B, T, 3·H·D] -> [B, T, H·D] in
    qkv's dtype, differentiable in qkv.  ``kv_mask`` [B, <=T] (nonzero =
    valid key) masks per-sample padding.  ``block_diag`` picks K2-bd (None:
    ``MCL_ATTN_CORE_BD``, read now).  CUDA tensors run the kernels (counted
    in ``attention_core_fwd.launches`` / ``attention_core_bwd.launches``, or
    the ``attention_core_bd_*`` pair); CPU tensors the plain versions.  An
    ``attention`` span (``utils/profiling.py``)."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention_core runs on cpu or cuda tensors, got {qkv.device}")
    with span("attention"):
        bd = _block_diag_default() if block_diag is None else bool(block_diag)
        b, t, _ = qkv.shape
        kvm = _padded_mask(kv_mask, b, t, qkv.device)
        if qkv.is_cuda:
            _check(qkv, heads)
            qkv = cuda_operand(qkv)
        if torch.is_grad_enabled() and qkv.requires_grad:
            return _AttentionCore.apply(qkv, kvm, heads, t_real, causal, bd)
        if qkv.is_cuda:
            fwd = attention_core_bd_fwd if bd else attention_core_fwd
            return fwd(qkv, heads, t_real, causal, kvm, with_lse=False)[0]
        ref = attention_core_bd_reference if bd else attention_core_reference
        return ref(qkv, heads, t_real, causal, kvm)


def attention_core_padded(qkv, heads: int, causal: bool = False, kv_mask=None,
                          block_diag=None) -> torch.Tensor:
    """Any-T entry with the JAX signature.  The JAX wrapper pads T to a
    multiple of 16 for the TPU; the kernels take any T, so this is
    ``attention_core`` with ``t_real = T`` (its ``attention`` span too)."""
    return attention_core(qkv, heads, qkv.shape[1], causal, kv_mask, block_diag)


attention_core_fwd.launches = 0
attention_core_bwd.launches = 0
attention_core_bd_fwd.launches = 0
attention_core_bd_bwd.launches = 0

__all__ = [
    "attention_core",
    "attention_core_backward_reference",
    "attention_core_bd_backward_reference",
    "attention_core_bd_bwd",
    "attention_core_bd_fwd",
    "attention_core_bd_reference",
    "attention_core_bwd",
    "attention_core_fwd",
    "attention_core_padded",
    "attention_core_reference",
    "backward_from_probs",
    "backward_max_rows",
    "bd_block",
    "check_kernel_shape",
    "key_ok",
]
