"""Sharded serving: KV-cache generation over a device mesh (counterpart of
multimodal_concept_learning_tpu/parallel/serving.py).

The training layout (``parallel/sharding_rules.py``: Megatron tensor
parallelism on ``model_axis``, optionally FSDP on another axis) applied
to the decode paths of ``models/mllm.py``.  Every rank calls the returned
``gen_fn`` with the whole global batch; it decodes its stripe of the rows
over ``data_axis`` with its model group's shards (K1 at this rank's query
and KV heads in the prefill and the dense decode steps; K3, or K4 under
``MCL_PAGED_KERNEL=2``, in the paged decode steps, whose pools hold this
rank's rows and KV heads) and all-gathers the token rows over the data
axis, so every rank returns the global [B, max_new_tokens] matrix.

int4 models are refused, as in JAX: their K5 product is not part of the
sharded layout.  Sampling (``temperature > 0``) draws each data stripe's
rows from the ``generator`` its ranks pass: a seed reproduces a run, but
the draws are not a single process's.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_concept_learning_tpu_torch.models.mllm import generate, paged_generate
from multimodal_concept_learning_tpu_torch.parallel import collectives as col
from multimodal_concept_learning_tpu_torch.parallel.sharding_rules import shard_params

_INT4 = ("sharded {what} does not support int4 models: the int4 matmul (K5) is not part "
         "of the sharded layout (untested composition) — use --int8 for mesh-sharded serving")


def _check_int4(model, what: str) -> None:
    if model.cfg.lm.int4_weights:
        raise ValueError(_INT4.format(what=what))


def _striped(model, mesh, data_axis: str, run):
    """``gen_fn`` running ``run(images, ids, mask, generator)`` on this
    rank's stripe of the global batch and gathering the tokens."""
    group = col.mesh_group(mesh, data_axis) if data_axis in mesh.mesh_dim_names else None

    def gen_fn(images, input_ids, attention_mask, generator: Optional[torch.Generator] = None):
        b = input_ids.shape[0]
        n = 1 if group is None else group.size
        if b % n:
            raise ValueError(f"the global batch {b} must divide over the data-axis size {n}")
        i = 0 if group is None else group.index
        rows = slice(i * b // n, (i + 1) * b // n)
        dev = next(model.parameters()).device
        local = [torch.as_tensor(x)[rows].to(dev) for x in (images, input_ids, attention_mask)]
        tokens = run(*local, generator)
        return tokens if group is None else col.all_gather(tokens, group, 0)

    return gen_fn


def make_sharded_generate(model, mesh, max_new_tokens: int, eos_id: Optional[int] = None,
                          pad_id: int = 0, temperature: float = 0.0,
                          top_k: Optional[int] = None, top_p: Optional[float] = None,
                          data_axis: str = "data", model_axis: str = "model",
                          fsdp_axis: Optional[str] = None):
    """``(gen_fn, model)``: ``model`` sharded in place over ``mesh`` and
    ``gen_fn(images, input_ids, attention_mask, generator=None)`` -> int32
    [B, max_new_tokens] through ``models/mllm.generate`` (dense caches,
    right-padded prompts).  The data-axis size must divide B."""
    _check_int4(model, "decode")
    shard_params(model, mesh, model_axis=model_axis, fsdp_axis=fsdp_axis)

    def run(images, ids, mask, generator):
        return generate(model, images, ids, mask, max_new_tokens, eos_id=eos_id, pad_id=pad_id,
                        generator=generator, temperature=temperature, top_k=top_k, top_p=top_p)

    return _striped(model, mesh, data_axis, run), model


def make_sharded_paged_generate(model, mesh, max_new_tokens: int, page_size: int = 16,
                                eos_id: Optional[int] = None, pad_id: int = 0,
                                data_axis: str = "data", model_axis: str = "model",
                                fsdp_axis: Optional[str] = None, quant_kv: bool = False):
    """``make_sharded_generate`` over ``models/mllm.paged_generate``
    (greedy): each rank's page pools hold its rows' pages at its KV heads;
    ``quant_kv``: int8 pools, read by the dequantizing gather (as in a
    single process)."""
    _check_int4(model, "paged decode")
    shard_params(model, mesh, model_axis=model_axis, fsdp_axis=fsdp_axis)

    def run(images, ids, mask, generator):
        del generator  # greedy
        return paged_generate(model, images, ids, mask, max_new_tokens, page_size,
                              eos_id=eos_id, pad_id=pad_id, quant_kv=quant_kv)

    return _striped(model, mesh, data_axis, run), model


__all__ = ["make_sharded_generate", "make_sharded_paged_generate"]
