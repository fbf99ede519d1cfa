"""Sequence parallelism: ring attention over a sharded sequence axis
(counterpart of multimodal_concept_learning_tpu/parallel/ring_attention.py).

Each rank of the ``seq`` axis holds its [B, T/P, H, D] blocks of q, k and
v and its query rows of the bias, [B, 1|H, T/P, T].  The k/v blocks
travel around the ring for P hops (``collectives.ring_shift``: send to
the next rank, receive from the previous, the backward the other way
round) while each rank keeps a float32 online softmax (running max,
denominator and accumulator) of its queries, JAX's ``_ring_attention_local``
step for step.  The bias is the finite -1e30 convention, so a row whose
keys are all masked gives the uniform average of V, as JAX's ring and its
dense softmax do (K1 gives such a row zeros; the ring is not K1).  GQA
k/v are repeated to the query heads first.  Autograd through the einsums
and the shifts is the ring's backward.

JAX computes the blocks with XLA einsums inside ``shard_map``, not with a
Pallas kernel, so the blocks here are ``torch.einsum``: there is no
kernel to port.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.parallel import collectives as col


def _ring_attention_local(q, k, v, bias, scale: float, group: col.AxisGroup):
    """This rank's [B, t, H, D] output: q/k/v local blocks, bias its query
    rows against all T keys [B, H, t, T]."""
    b, t, h, d = q.shape
    n = group.size
    q32 = q.float() * scale
    m = torch.full((b, h, t), -torch.inf, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        # after ``step`` hops this rank holds the block that started at (my - step) mod P
        src = (group.index - step) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
        logits = logits + bias[..., src * t:(src + 1) * t].float()
        m_new = torch.maximum(m, logits.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if step < n - 1:
            k_blk, v_blk = col.ring_shift(k_blk, group), col.ring_shift(v_blk, group)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def make_ring_attention(mesh, axis: str = "seq"):
    """``fn(q, k, v, bias, scale=None) -> out``: this rank's [B, T/P, H, D]
    blocks of q/k/v (k/v may have fewer heads: repeated to q's) and its
    query rows of the bias [B, 1|H, T/P, T]; returns this rank's block of
    the attention output.  Default scale ``D ** -0.5``."""
    group = col.mesh_group(mesh, axis)

    def fn(q, k, v, bias, scale: Optional[float] = None):
        if k.shape[2] != q.shape[2]:
            rep = q.shape[2] // k.shape[2]
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        if scale is None:
            scale = q.shape[-1] ** -0.5
        if bias.shape[1] == 1:
            bias = bias.expand(q.shape[0], q.shape[2], *bias.shape[2:])
        return _ring_attention_local(q, k, v, bias, scale, group)

    return fn


def shard_seq(x: torch.Tensor, mesh, axis: str = "seq", dim: int = 1) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` over the ``axis`` ranks."""
    return col.chunk_of(x, col.mesh_group(mesh, axis), dim).contiguous()


__all__ = ["make_ring_attention", "shard_seq"]
