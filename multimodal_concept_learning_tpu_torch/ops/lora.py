"""LoRA adapters (counterpart of multimodal_concept_learning_tpu/ops/lora.py).

- ``LoRAAdapter``: ``scale * x @ a @ b`` with ``a`` [in, rank] and ``b``
  [rank, features], scale = alpha / rank.  The factors keep the JAX
  layout (not ``nn.Linear``'s [out, in]), under the names
  ``checkpoint/torch_interop.mllm_params_to_torch`` writes verbatim
  (``...self_attn.q_proj_lora.a``, ``...mlp.gate_proj_lora.b``), so a
  ``.pt`` of either package loads into the other.  The rounding order is
  JAX's: x cast to the compute dtype, ``x @ a`` in it, then ``@ b`` in
  it, then the product by the scale rounded to it.  A fresh adapter
  (``b`` zero) is an exact identity.
- Per-row factors (multi-LoRA banks, ``ops/multi_lora.py``): inside
  ``adapter_rows`` each adapter takes row i's factors for row i of x, a
  ``torch.bmm`` pair over [B, in, r] and [B, r, out].  The rows are a
  context variable, so two threads serving one model do not see each
  other's.
- ``merge_lora_params``: every ``<proj>_lora`` pair folded into its
  sibling ``<proj>.weight`` ([out, in]), the ``*_lora`` entries dropped:
  serve the result with ``lora_rank=0``.

The adapters' products are plain matrix products, in JAX (einsum) as
here: no kernel of their own.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.parallel import collectives as col

# {module: per-row tensors} while a bank's rows are selected (adapter_rows)
_ROWS: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar("lora_rows",
                                                                        default=None)


def rows_of(module: nn.Module) -> Optional[Tuple[torch.Tensor, ...]]:
    """``module``'s per-row tensors under ``adapter_rows``, else None."""
    rows = _ROWS.get()
    return None if rows is None else rows.get(module)


@contextlib.contextmanager
def adapter_rows(rows: Dict[nn.Module, Tuple[torch.Tensor, ...]]):
    """Run every module in ``rows`` on per-row tensors: a ``LoRAAdapter``
    on (a [B, in, r], b [B, r, out]), the MLLM's projector on (weight
    [B, out, in], bias [B, out]); row i of every input takes row i."""
    token = _ROWS.set(rows)
    try:
        yield
    finally:
        _ROWS.reset(token)


class LoRAAdapter(nn.Module):
    """``scale * x @ a @ b``: a [in, rank] (normal(0.02) init), b [rank,
    features] (zeros), scale = alpha / rank, computed in ``dtype``.  The
    factors are replicated under tensor parallelism; beside a column-
    parallel base (``self._tp`` "col") the delta is its local output
    columns (b's columns sliced on use), beside a row-parallel one ("row")
    x holds local input features (a's rows sliced, ``x @ a`` summed over
    the model axis in float32 and rounded once)."""

    def __init__(self, in_features: int, features: int, rank: int, alpha: float,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.a = nn.Parameter(torch.zeros(in_features, rank))
        self.b = nn.Parameter(torch.zeros(rank, features))
        # the scale as a compute-dtype value: products of two such values
        # round once, as JAX's multiply in the compute dtype does
        self.scale = torch.tensor(alpha / rank, dtype=dtype, device="cpu").item()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         std: float = 0.02) -> None:
        self.a.normal_(0.0, std, generator=generator)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        rows = rows_of(self)
        tp = getattr(self, "_tp", None)
        if tp is not None and tp.kind == "col":
            u = col.copy_to(x @ self.a.to(dt), tp.group)
            y = u @ col.scatter_to(self.b, tp.group, 1).to(dt)
        elif tp is not None:
            a = col.scatter_to(self.a, tp.group, 0).to(dt)
            u = col.reduce_from(x.float() @ a.float(), tp.group).to(dt)
            y = u @ self.b.to(dt)
        elif rows is None:
            y = (x @ self.a.to(dt)) @ self.b.to(dt)
        else:
            a, b = rows
            flat = x.reshape(x.shape[0], -1, x.shape[-1])
            y = torch.bmm(torch.bmm(flat, a.to(dt)), b.to(dt)).reshape(*x.shape[:-1], -1)
        return y * self.scale


def merge_lora_params(state_dict: Dict[str, torch.Tensor], alpha: float
                      ) -> Dict[str, torch.Tensor]:
    """Fold every ``<proj>_lora.{a,b}`` pair into ``<proj>.weight``:
    weight += ((alpha / rank) * (a @ b) in float32).T cast to the weight's
    dtype.  Returns a state dict WITHOUT the ``*_lora`` entries, for a
    ``lora_rank=0`` model.  Float weights only (the first other one, in
    name order, raises): an int8 or int4 tree is re-quantized from the
    merged float one."""
    out = {k: v for k, v in state_dict.items() if "_lora." not in k}
    for key in sorted(k for k in state_dict if k.endswith("_lora.a")):  # JAX's tree order
        prefix = key[: -len("_lora.a")]
        a, b = state_dict[key], state_dict[prefix + "_lora.b"]
        weight = out.get(prefix + ".weight")
        if weight is None or not weight.is_floating_point():
            name = prefix.rsplit(".", 1)[-1]
            raise ValueError(f"cannot merge LoRA into non-float kernel {name}")
        delta = (a.float() @ b.float()) * (alpha / a.shape[1])
        out[prefix + ".weight"] = weight + delta.T.to(weight.dtype)
    return out


__all__ = ["LoRAAdapter", "adapter_rows", "merge_lora_params", "rows_of"]
