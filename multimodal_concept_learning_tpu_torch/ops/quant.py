"""Int8 weight quantization for the serving path (counterpart of
multimodal_concept_learning_tpu/ops/quant.py).

- ``quantize_weight``: symmetric per-output-channel int8 weights,
  ``kernel`` int8 [in, out] and ``scale`` float32 [out], bitwise the JAX
  quantizer (its [in, out] orientation, the transpose of
  ``nn.Linear.weight``).
- ``int8_matmul``: activations quantized per row (symmetric, dynamic), an
  exact int8 x int8 -> int32 product, then the two float32 scales.  The
  JAX package runs XLA's native int8 dot here (no Pallas kernel); on the
  card the port runs ``torch._int_mm`` (cuBLAS), whose rules it meets by
  padding the rows (zero rows quantize to zero) and slicing the padding
  off.  On the CPU the product runs in float64, which is exact for these
  magnitudes (|sum| <= 127 * 127 * in < 2 ** 53).
- ``QuantLinear``: buffers ``kernel``/``scale`` (the JAX ``QuantDense`` /
  ``QuantDenseGeneral`` params) and an optional float ``bias``; not an
  ``nn.Linear``, so the device policy's casts leave it alone.
- Converters over the port's float state dicts: the LM projections
  (``quantize_lm_params``), the ViT tower (``quantize_vit_params``), both
  (``quantize_mllm_params``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.ops.int4 import (
    _contract,
    _features,
    _prod,
    lm_projection_prefixes,
    quantize_state_dict,
)
from multimodal_concept_learning_tpu_torch.parallel import collectives as col

_INT_MM_MIN_ROWS = 17  # cuBLAS int8 products take more than 16 rows, in multiples of 8


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of ``w [in, *out]``:
    (w_q int8, scale float32 [*out]) with w ~ w_q * scale."""
    w32 = w.float().contiguous()  # row-major results whatever w's strides
    absmax = w32.abs().amax(dim=0)
    scale = absmax.clamp(min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return w_q, scale


def _int_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 [rows, out] = x_q [rows, in] @ w_q [in, out] (int8)."""
    if x_q.device.type == "cpu":
        return (x_q.double() @ w_q.double()).to(torch.int32)
    return int_mm_padded(x_q, w_q)


def int_mm_padded(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` under cuBLAS's rules: rows padded with zeros to
    more than 16 and a multiple of 8, the padding sliced off."""
    rows, d_in = x_q.shape
    if d_in % 8 or w_q.shape[1] % 8:
        raise ValueError(f"torch._int_mm needs in and out multiples of 8, got "
                         f"{d_in}, {w_q.shape[1]}")
    padded = max(_INT_MM_MIN_ROWS, rows)
    padded = -(-padded // 8) * 8
    if padded != rows:
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, padded - rows))
    return torch._int_mm(x_q, w_q)[:rows]


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                group=None) -> torch.Tensor:
    """``x [..., in] @ (w_q [in, *out] * scale [*out])`` with per-row
    dynamic int8 activations; the result in x's dtype, [..., *out].
    ``group`` (a row-parallel shard: x and w_q hold this rank's part of
    ``in``): the row's absmax is the max over the group and the int32
    partial products are summed over it, so the result is the unsharded
    one exactly."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        absmax = col.all_reduce_max(absmax, group)
    sx = absmax.clamp(min=1e-8) / 127.0
    x_q = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    out_dims = tuple(w_q.shape[1:])
    acc = _int_product(x_q.reshape(-1, x.shape[-1]), w_q.reshape(w_q.shape[0], -1))
    if group is not None:
        acc = col.all_reduce(acc, group)
    acc = acc.float().reshape(*x.shape[:-1], *out_dims)
    sx_b = sx.reshape(*sx.shape[:-1], *(1,) * len(out_dims))
    return (acc * sx_b * scale.float()).to(x.dtype)


class QuantLinear(nn.Module):
    """Int8 projection: buffers ``kernel`` int8 [in, F] and ``scale``
    float32 [F], optional float ``bias`` shaped like the features.
    ``features`` as a tuple and ``axis`` give the JAX ``QuantDenseGeneral``.
    Under tensor parallelism (``self._tp``) the kernel holds this rank's
    output columns (col: the replicated scale is sliced to them) or input
    rows (row: ``int8_matmul`` over the model group)."""

    def __init__(self, in_features: int, features: Union[int, Sequence[int]],
                 bias: bool = False, axis: Sequence[int] = (-1,)):
        super().__init__()
        self.features = _features(features)
        self.axis = tuple(axis)
        out = _prod(self.features)
        self.register_buffer("kernel", torch.zeros((in_features, out), dtype=torch.int8))
        self.register_buffer("scale", torch.zeros((out,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(self.features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _contract(x, self.axis)
        tp = getattr(self, "_tp", None)
        if tp is None:
            y = int8_matmul(x, self.kernel, self.scale)
            y = y.reshape(*y.shape[:-1], *self.features)
        elif tp.kind == "col":
            scale = col.scatter_to(self.scale, tp.group, 0)
            y = int8_matmul(col.copy_to(x, tp.group), self.kernel, scale)
        else:
            y = int8_matmul(x, self.kernel, self.scale, group=tp.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def quantize_linear(weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """An ``nn.Linear.weight`` [out, in] as {"kernel" [in, out], "scale"}."""
    kernel, scale = quantize_weight(weight.t())
    return {"kernel": kernel, "scale": scale}


def quantize_params(state_dict: Dict[str, torch.Tensor], prefixes: Sequence[str]
                    ) -> Dict[str, torch.Tensor]:
    """The JAX ``quantize_params`` over a state dict: the named projections
    int8, biases and everything else passed through."""
    return quantize_state_dict(state_dict, prefixes, quantize_linear)


def quantize_lm_params(state_dict: Dict[str, torch.Tensor], root: str = "model."
                       ) -> Dict[str, torch.Tensor]:
    """A float ``CausalLM`` state dict -> the ``int8_weights=True`` layout."""
    return quantize_params(state_dict, lm_projection_prefixes(state_dict, root))


# the ViT block's projections that int8 covers (JAX vit.py: q/k/v/output, the MLP)
VIT_PROJECTIONS = ("attention.attention.query", "attention.attention.key",
                   "attention.attention.value", "attention.output.dense",
                   "intermediate.dense", "output.dense")


def vit_projection_prefixes(state_dict, root: str = "") -> list:
    """Names of the ViT tower's int8 projections in ``state_dict`` (the
    patch embedding and the norms stay float)."""
    return sorted({k[: -len(".weight")] for k in state_dict
                   if k.startswith(root + "encoder.layer.") and k.endswith(".weight")
                   and k[: -len(".weight")].endswith(VIT_PROJECTIONS)})


def quantize_vit_params(state_dict: Dict[str, torch.Tensor], root: str = ""
                        ) -> Dict[str, torch.Tensor]:
    """A float ViT encoder state dict -> the ``int8_weights=True`` layout."""
    return quantize_params(state_dict, vit_projection_prefixes(state_dict, root))


def quantize_mllm_params(state_dict: Dict[str, torch.Tensor], vision: bool = True,
                         lm: bool = True) -> Dict[str, torch.Tensor]:
    """An MLLM state dict with the chosen towers int8 (projector, LoRA
    factors and norms stay float, untouched: a multi-LoRA bank's stacked
    factors and projectors keep their leading bank axis)."""
    if lm:
        state_dict = quantize_lm_params(state_dict, "language_model.model.")
    if vision:
        state_dict = quantize_vit_params(state_dict, "vision_model.")
    return state_dict


__all__ = [
    "QuantLinear",
    "int8_matmul",
    "quantize_linear",
    "quantize_lm_params",
    "quantize_mllm_params",
    "quantize_params",
    "quantize_vit_params",
    "quantize_weight",
]
