"""Multi-LoRA serving: per-request adapters in one batch (counterpart of
multimodal_concept_learning_tpu/ops/multi_lora.py).

The **adapter surface** is what ``trainable_params_setting=
"language_lora"`` trains: every ``<proj>_lora`` factor and the vision ->
LM projector.  Two checkpoints fine-tuned from one base differ in exactly
those entries, so selecting them per row reproduces each checkpoint.

- ``stack_adapter_params``: k state dicts -> one bank, the surface
  stacked to [k, ...], every other entry taken from the first;
- ``identity_adapter_params``: a state dict with its LoRA factors zeroed
  (the bank's "no adapter" entry: the base model through its own
  projector);
- ``select_adapter_params``: each row's surface, ``bank[name][idx]``;
- ``bank_rows``: those rows as ``ops/lora.adapter_rows`` takes them;
- ``multi_lora_generate``: ``models/mllm.generate`` with per-row adapters.

JAX maps one row's generate over the batch (``jax.vmap``).  Here the batch
stays one: the base projections are the plain model's batched products,
each LoRA delta is a ``torch.bmm`` pair over the rows' factors and the
projector a ``torch.bmm`` over the rows' weights.  The rows are gathered
once per generate call, not once per decode step.  Greedy rows decode
exactly their own adapter's tokens; sampled rows draw from one
``torch.Generator`` (JAX splits its key per row: other random streams).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.ops.lora import adapter_rows


def _is_lora(name: str) -> bool:
    return any(part.endswith("_lora") for part in name.split("."))


def is_adapter_name(name: str) -> bool:
    """True for a state-dict entry on the adapter surface: a ``<proj>_lora``
    factor or the MLLM's projector."""
    return name.split(".", 1)[0] == "projector" or _is_lora(name)


def stack_adapter_params(state_dicts: Sequence[Dict[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """One bank from k same-architecture state dicts: the adapter surface
    stacked to [k, ...], every other entry from ``state_dicts[0]`` (every
    adapter is presumed trained from that base)."""
    if not state_dicts:
        raise ValueError("stack_adapter_params needs at least one state dict")
    first = state_dicts[0]
    return {name: torch.stack([sd[name] for sd in state_dicts]) if is_adapter_name(name)
            else t for name, t in first.items()}


def identity_adapter_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state_dict`` with its LoRA factors zeroed (delta = x @ 0 @ 0)."""
    return {name: torch.zeros_like(t) if _is_lora(name) else t
            for name, t in state_dict.items()}


def select_adapter_params(bank: Dict[str, torch.Tensor], adapter_idx: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Each row's adapter entries, ``bank[name][adapter_idx]`` [B, ...];
    every other entry passes through."""
    return {name: t[adapter_idx.to(t.device)] if is_adapter_name(name) else t
            for name, t in bank.items()}


def bank_rows(model: nn.Module, bank: Dict[str, torch.Tensor], adapter_idx: torch.Tensor,
              projector: bool = True) -> Dict[nn.Module, tuple]:
    """``ops/lora.adapter_rows``' argument: for each of ``model``'s LoRA
    adapters (a [B, in, r], b [B, r, out]) and, with ``projector``, for its
    projector (weight [B, out, in], bias [B, out]; a decode step has no use
    for it), gathered from the bank's adapter entries by ``adapter_idx``
    [B] (on the bank's device).  Entries off the surface are not read."""
    idx = adapter_idx.long()
    rows = {}
    for name, module in model.named_modules():
        if name.endswith("_lora") or (projector and name == "projector"):
            leaves = ("weight", "bias") if name == "projector" else ("a", "b")
            rows[module] = tuple(bank[f"{name}.{leaf}"][idx] for leaf in leaves)
    return rows


def multi_lora_generate(model, bank: Dict[str, torch.Tensor], adapter_idx: torch.Tensor,
                        images, input_ids, attention_mask, **generate_kwargs) -> torch.Tensor:
    """``models/mllm.generate`` with row i under adapter ``adapter_idx[i]``
    of ``bank`` (a ``stack_adapter_params`` result, or its adapter entries,
    on the model's device).  The model holds the shared base weights."""
    from multimodal_concept_learning_tpu_torch.models.mllm import generate

    dev = next(model.parameters()).device
    with adapter_rows(bank_rows(model, bank, torch.as_tensor(adapter_idx, device=dev))):
        return generate(model, images, input_ids, attention_mask, **generate_kwargs)


__all__ = [
    "bank_rows",
    "identity_adapter_params",
    "is_adapter_name",
    "multi_lora_generate",
    "select_adapter_params",
    "stack_adapter_params",
]
