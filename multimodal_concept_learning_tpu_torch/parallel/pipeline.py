"""GPipe pipeline parallelism for the LM's layer stack (counterpart of
multimodal_concept_learning_tpu/parallel/pipeline.py).

``shard_pipeline_params`` keeps stage s's contiguous ``L / P`` blocks of
the LM's ``ModuleList`` on rank s of the ``pipe`` axis (the others are
dropped there; everything else stays replicated).  The function
``make_pipelined_hidden_states`` returns runs JAX's skewed schedule of
``M + P - 1`` ticks: at tick t stage s runs microbatch t - s (local block
j as global layer ``s * L / P + j``, so the sliding-window pattern and the
two rope bases follow the global index) and sends its activation to stage
s + 1; the last stage's outputs are broadcast to every stage, and the
final norm runs outside the pipeline.  The schedule is one autograd
function whose backward runs the GPipe backward: microbatches in reverse,
each stage receiving its output gradient from stage s + 1 and sending its
input gradient to stage s - 1, the stage's parameter gradients summed
over its microbatches, and stage 0's input gradient broadcast to every
stage, so the replicated parameters upstream of the pipeline (vision
tower, projector, embedding) get their whole gradient on every rank.  The
gradients are the unpipelined ones.  Attention in the stages is K1 (and
its backward kernels) on the card.

``make_pipelined_mllm_loss`` keeps the vision tower, projector, embedding,
final norm and sparse answer loss replicated and pipelines the LM blocks.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.models.lm import CausalLM
from multimodal_concept_learning_tpu_torch.ops.losses import sparse_answer_cross_entropy
from multimodal_concept_learning_tpu_torch.parallel import collectives as col


def shard_pipeline_params(model: nn.Module, mesh, pipe_axis: str = "pipe") -> nn.Module:
    """Keep this stage's blocks of the LM (``model`` a ``CausalLM`` or an
    MLLM) in place and return ``model``; num_layers must divide over the
    pipe-axis size."""
    lm = model.language_model if hasattr(model, "language_model") else model
    group = col.mesh_group(mesh, pipe_axis)
    layers = lm.model.layers
    n, p = len(layers), group.size
    if n % p:
        raise ValueError(f"num_layers {n} must divide into {p} stages")
    per = n // p
    first = group.index * per
    lm.model.layers = nn.ModuleList(layers[first:first + per])
    lm._mcl_pipe = dict(group=group, first=first)
    return model


class _Pipeline(torch.autograd.Function):
    """(stage runner, M, x [B, T, H], *stage params) -> the last stage's
    [B, T, H] on every stage; see the module docstring."""

    @staticmethod
    def forward(ctx, run, m, x, *params):
        group = run.group
        s, n_stages = group.index, group.size
        mbs = x.chunk(m, dim=0)
        ins: List[Optional[torch.Tensor]] = [None] * m
        outs: List[Optional[torch.Tensor]] = [None] * m
        for tick in range(m + n_stages - 1):
            k = tick - s
            if not 0 <= k < m:
                continue
            src = mbs[k] if s == 0 else col.recv(mbs[k], group, s - 1)
            xin = src.detach().requires_grad_(x.requires_grad or bool(params))
            with torch.enable_grad():
                y = run(xin, k)
            ins[k], outs[k] = xin, y
            if s < n_stages - 1:
                col.send(y.detach(), group, s + 1).wait()
        last = torch.cat([y.detach() for y in outs], 0) if s == n_stages - 1 else \
            torch.empty_like(x)
        ctx.run, ctx.ins, ctx.outs, ctx.params = run, ins, outs, params
        return col.broadcast(last, group, n_stages - 1)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.run.group
        s, n_stages = group.index, group.size
        m = len(ctx.outs)
        gouts = grad.chunk(m, dim=0)
        pgrads = [None] * len(ctx.params)
        gins: List[Optional[torch.Tensor]] = [None] * m
        for k in reversed(range(m)):
            y = ctx.outs[k]
            dy = gouts[k].contiguous() if s == n_stages - 1 else col.recv(y, group, s + 1)
            wrt = [ctx.ins[k]] + [p for p in ctx.params]
            got = torch.autograd.grad(y, wrt, dy, allow_unused=True)
            gins[k] = got[0]
            for i, g in enumerate(got[1:]):
                if g is not None:
                    pgrads[i] = g if pgrads[i] is None else pgrads[i] + g
            if s > 0:
                col.send(got[0].contiguous(), group, s - 1).wait()
        dx = torch.cat(gins, 0) if s == 0 else torch.empty_like(grad)
        dx = col.broadcast(dx, group, 0)
        ctx.run = ctx.ins = ctx.outs = None
        return (None, None, dx, *pgrads)


class _StageRunner:
    """This stage's blocks on microbatch k (its rows of the mask)."""

    def __init__(self, lm: CausalLM, group, first: int, attention_mask, m: int):
        self.lm, self.group, self.first = lm, group, first
        self.masks = None if attention_mask is None else attention_mask.chunk(m, dim=0)

    def __call__(self, x: torch.Tensor, k: int) -> torch.Tensor:
        lm = self.lm
        b, t, _ = x.shape
        mask = None if self.masks is None else self.masks[k]
        inputs = lm.layer_inputs(mask, None, b, t, x.device)
        for j, layer in enumerate(lm.model.layers):
            x = lm.run_layer(self.first + j, layer, x, inputs)
        return x


def make_pipelined_hidden_states(model: CausalLM, mesh, num_microbatches: int,
                                 pipe_axis: str = "pipe"):
    """``fn(inputs_embeds [B, T, H], attention_mask [B, T]) -> hidden``:
    ``CausalLM.hidden_states`` with the layer stack pipelined over
    ``pipe_axis`` (the model sharded by ``shard_pipeline_params``; the
    mask goes to attention as the JAX bias).  B must divide into
    ``num_microbatches``."""
    pipe = getattr(model, "_mcl_pipe", None)
    if pipe is None:
        raise ValueError("shard the model with shard_pipeline_params first")
    group = col.mesh_group(mesh, pipe_axis)
    m = num_microbatches

    def fn(inputs_embeds: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        b = inputs_embeds.shape[0]
        if b % m:
            raise ValueError(f"batch {b} must divide into {m} microbatches")
        run = _StageRunner(model, group, pipe["first"], attention_mask, m)
        params = [p for p in model.model.layers.parameters() if p.requires_grad]
        x = inputs_embeds.to(model.cfg.dtype)
        hidden = _Pipeline.apply(run, m, x, *params)
        return model.model.norm(hidden)

    return fn


def make_pipelined_mllm_loss(mllm, mesh, num_microbatches: int, pipe_axis: str = "pipe"):
    """``loss_fn(batch) -> loss`` for the MLLM with the LM stack pipelined
    (the model sharded by ``shard_pipeline_params``): vision tower,
    projector, embedding, final norm and the sparse answer loss stay
    replicated.  The gradients through the pipeline are exact (GPipe)."""
    lm = mllm.language_model
    piped = make_pipelined_hidden_states(lm, mesh, num_microbatches, pipe_axis)

    def loss_fn(batch):
        embeds = mllm.prompt_embeds(batch["images"], batch["input_ids"])
        hidden = piped(embeds, batch["attention_mask"])
        loss, _, _, _ = sparse_answer_cross_entropy(
            hidden, batch["labels"], lm.lm_head, max_positions=mllm.cfg.max_answer_tokens)
        return loss

    return loss_fn


__all__ = ["make_pipelined_hidden_states", "make_pipelined_mllm_loss", "shard_pipeline_params"]
