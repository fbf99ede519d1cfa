"""How the reference computes its matrix products.

``Numerics("float32")`` is the reference: every product in float32, with
TF32 off on the card (``full_float32``).  ``Numerics("fp8")`` is the
control, the reference in the precision one step below the bfloat16 that
the configurations state: the operands of every product that the program
computes in bfloat16 (the linear layers, the attention's two products and
the contrastive logits) are rounded to float8 e4m3 with one scale a tensor
(its largest magnitude to 448), in the forward pass and, for the incoming
gradient, in the backward pass; the product itself accumulates in float32.
What the program keeps in float32 (LayerNorm, softmax, the losses, the
classifier head, the L2 normalisation) stays float32 in both.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, as float32."""
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = fp8_round(dy)
        dx = dyq @ wq
        dw = dyq.reshape(-1, dyq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return dx, dw


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq, bq = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, dy):
        aq, bq = ctx.saved_tensors
        dyq = fp8_round(dy)
        return dyq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ dyq


class Numerics:
    """The products of the reference (``"float32"``) or of the control
    (``"fp8"``)."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def linear(self, x, weight, bias=None):
        if self.mode == "float32":
            return F.linear(x, weight, bias)
        y = _Fp8Linear.apply(x, weight)
        return y if bias is None else y + bias

    def matmul(self, a, b):
        return a @ b if self.mode == "float32" else _Fp8MatMul.apply(a, b)


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
