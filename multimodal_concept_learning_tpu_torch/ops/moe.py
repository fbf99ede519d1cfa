"""Mixture-of-Experts GeGLU MLP (counterpart of
multimodal_concept_learning_tpu/ops/moe.py).

- ``MoEMLP``: a router (float32, [E, H], under ``router.weight``) and the
  stacked expert tensors ``experts_gate`` / ``experts_up`` [E, H, I] and
  ``experts_down`` [E, I, H], the names ``mllm_params_to_torch`` writes
  (the stacked tensors verbatim, the router kernel transposed), so a
  ``.pt`` of either package loads into the other.  ``forward`` returns
  (out, aux) as the JAX module does: the router runs in float32 on
  ``x.float()``, a softmax over all experts, the gate ``probs >= k-th
  largest`` (over-selecting on ties, as JAX does), renormalised with
  ``max(sum, 1e-9)``; the Switch aux ``E * sum(frac * mean_prob)`` over
  every position of the call.
- Dense dispatch: every expert over every token, four einsums in the
  compute dtype, the gate zeroing the experts not selected.
- Sparse dispatch (GShard capacity): each token's k experts (the largest
  gates, the lowest index first on ties: a stable sort, as
  ``jax.lax.top_k`` breaks them), the assignments stably sorted by expert
  into a static [E, C, H] buffer with a sentinel row (C =
  ceil(k * N * cf / E) rounded up to 8, at most N = the call's B * T), the
  earliest tokens winning a full expert, each expert's GeGLU over its C
  slots, and the gate-weighted sum back to the tokens.  The sum is taken
  per token in ascending expert order (the order in which JAX's scatter-add
  meets a token's assignments), as a gather and a fixed sum over k, so it
  is deterministic on the card for any k (``index_add_`` adds with
  atomics in no fixed order).
- ``MoEAux``: what the MoE layers of one forward report to their caller
  (each layer's aux, and its router logits when asked), plus an optional
  ``reduce`` that turns a layer's local routing sums into the global
  batch's: a data-parallel trainer takes the aux of the whole batch, not a
  mean of the ranks' (``parallel/multihost.py``).
- ``router_stats``: host numpy routing diagnostics, the JAX function's dict.
- Expert parallelism (``self._tp``, set by
  ``parallel/sharding_rules.shard_params``: the experts sharded on E over
  the model axis): every model rank routes the same N tokens (the
  capacity, and so the drops, are the single process's), computes its
  E/m experts (dense: their einsums; sparse: their rows of the [E, C, H]
  buffer) under its slice of the gates, and the float32 partial outputs
  are summed over the model axis and rounded once.

The products are ``torch.einsum`` / ``torch.bmm``: JAX computes them in
XLA einsums outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_concept_learning_tpu_torch.parallel import collectives as col

EXPERT_PARAMS = ("experts_gate", "experts_up", "experts_down")


@dataclasses.dataclass
class MoEAux:
    """The MoE report of one forward: ``aux`` (one 0-d tensor a layer, in
    layer order) and, with ``keep_logits``, each layer's router logits
    [B, T, E] (detached).  ``reduce(frac_sum [E], prob_sum [E], n)`` ->
    the same three over the global batch (a data-parallel step passes
    ``parallel.multihost.global_routing_sums``)."""

    reduce: Optional[Callable] = None
    keep_logits: bool = False
    aux: List[torch.Tensor] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)


class Router(nn.Module):
    """The bias-free float32 router: logits = x.float() @ weight.T."""

    def __init__(self, hidden_size: int, num_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_experts, hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.weight.float().T


def capacity_of(n: int, top_k: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(k * n * cf / E) rounded up to 8, at most n
    (the JAX formula, float division included)."""
    capacity = int(-(-(top_k * n * capacity_factor) // num_experts))
    return min(-(-capacity // 8) * 8, n)


def top_k_indices(values: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of the last axis, ties broken
    toward the lowest index (``jax.lax.top_k``'s order)."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


class MoEMLP(nn.Module):
    """Drop-in GeGLU MLP with ``num_experts`` experts (see the module
    docstring).  Parameters as the JAX module's, float32 at init."""

    # stored in the compute dtype by ``device.cast_for_compute``; the router stays float32
    compute_dtype_params = EXPERT_PARAMS

    def __init__(self, hidden_size: int, intermediate_size: int, num_experts: int,
                 top_k: int = 2, dtype: torch.dtype = torch.bfloat16, dispatch: str = "dense",
                 capacity_factor: float = 1.25):
        super().__init__()
        if dispatch not in ("dense", "sparse"):
            raise ValueError(f"MoEMLP.dispatch must be 'dense' or 'sparse', got {dispatch!r}")
        e, h, i = num_experts, hidden_size, intermediate_size
        self.num_experts, self.top_k, self.dtype = e, top_k, dtype
        self.dispatch, self.capacity_factor = dispatch, capacity_factor
        self.router = Router(h, e)
        self.experts_gate = nn.Parameter(torch.empty(e, h, i))
        self.experts_up = nn.Parameter(torch.empty(e, h, i))
        self.experts_down = nn.Parameter(torch.empty(e, i, h))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         std: float = 0.02) -> None:
        """normal(std) everywhere, as the JAX initialisers."""
        for p in (self.router.weight, *(getattr(self, n) for n in EXPERT_PARAMS)):
            p.normal_(0.0, std, generator=generator)

    def gates(self, x: torch.Tensor):
        """(router logits, probs, renormalised top-k gates), all float32 [B, T, E]."""
        logits = self.router(x)
        probs = torch.softmax(logits, dim=-1)
        thresh = torch.topk(probs, self.top_k, dim=-1).values[..., -1:]
        gates = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return logits, probs, gates

    def forward(self, x: torch.Tensor,
                record: Optional[MoEAux] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out [B, T, H] in x's dtype, aux load-balance loss 0-d float32);
        ``record`` gets the router logits when it keeps them, and its
        ``reduce`` makes the aux the global batch's."""
        e, dt = self.num_experts, self.dtype
        logits, probs, gates = self.gates(x)
        if record is not None and record.keep_logits:
            record.logits.append(logits.detach())
        frac_sum = (gates > 0).float().sum(dim=(0, 1))
        prob_sum = probs.sum(dim=(0, 1))
        n = probs.shape[0] * probs.shape[1]
        if record is not None and record.reduce is not None:
            frac_sum, prob_sum, n = record.reduce(frac_sum, prob_sum, n)
        aux = e * torch.sum((frac_sum / n) * (prob_sum / n))

        xd = x.to(dt)
        w_gate, w_up, w_down = (getattr(self, name).to(dt) for name in EXPERT_PARAMS)
        tp = getattr(self, "_tp", None)
        if self.dispatch == "sparse":
            out = sparse_moe(xd, gates, self.top_k, self.capacity_factor, w_gate, w_up, w_down,
                             tp=tp)
        elif tp is not None:  # this rank's experts under its columns of the gates
            xd = col.copy_to(xd, tp.group)
            g_local = col.scatter_to(gates, tp.group, -1).to(dt)
            hidd = torch.einsum("bth,ehi->beti", xd, w_gate)
            up = torch.einsum("bth,ehi->beti", xd, w_up)
            act = F.gelu(hidd, approximate="tanh") * up
            down = torch.einsum("beti,eih->beth", act, w_down)
            partial = torch.einsum("beth,bte->bth", down.float(), g_local.float())
            out = col.reduce_from(partial, tp.group).to(dt)
        else:
            hidd = torch.einsum("bth,ehi->beti", xd, w_gate)
            up = torch.einsum("bth,ehi->beti", xd, w_up)
            act = F.gelu(hidd, approximate="tanh") * up
            down = torch.einsum("beti,eih->beth", act, w_down)
            out = torch.einsum("beth,bte->bth", down, gates.to(dt))
        return out.to(x.dtype), aux


def sparse_moe(x: torch.Tensor, gates: torch.Tensor, top_k: int, capacity_factor: float,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
               tp=None) -> torch.Tensor:
    """Capacity (GShard) dispatch of x [B, T, H] (compute dtype) under the
    [B, T, E] gates the dense path uses (JAX ``_sparse_moe``).  With ``tp``
    (expert parallelism) the expert tensors are this rank's ``tp.count``
    experts from ``tp.offset``."""
    b, t, h = x.shape
    e = gates.shape[-1]
    n = b * t
    n_assign = n * top_k
    capacity = capacity_of(n, top_k, e, capacity_factor)
    dev = x.device

    xf = x.reshape(n, h)
    top_idx = top_k_indices(gates, top_k).reshape(n, top_k)       # [N, k]
    top_g = torch.gather(gates.reshape(n, e), 1, top_idx)         # [N, k]
    e_flat, g_flat = top_idx.reshape(n_assign), top_g.reshape(n_assign)
    tok = torch.arange(n, device=dev).repeat_interleave(top_k)

    order = torch.sort(e_flat, stable=True).indices              # deterministic drops
    e_s, tok_s, g_s = e_flat[order], tok[order], g_flat[order]
    counts = torch.zeros(e, dtype=e_s.dtype, device=dev).scatter_add_(
        0, e_s, torch.ones_like(e_s))  # bincount would read its max back to the host
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n_assign, device=dev) - starts[e_s]       # rank within the expert
    keep = pos < capacity
    slot = torch.where(keep, e_s * capacity + pos, torch.full_like(pos, e * capacity))

    buf = torch.zeros(e * capacity + 1, h, dtype=x.dtype, device=dev)
    buf = buf.index_put((slot,), xf[tok_s])                      # the sentinel row is dropped
    eb = buf[: e * capacity].reshape(e, capacity, h)
    if tp is not None:  # this rank's experts' rows; the others' outputs are zero here
        eb = col.scatter_to(eb, tp.group, 0)
    act = F.gelu(torch.bmm(eb, w_gate), approximate="tanh") * torch.bmm(eb, w_up)
    down = torch.bmm(act, w_down).reshape(-1, h)
    if tp is not None:
        before = tp.offset * capacity
        down = F.pad(down.float(), (0, 0, before, e * capacity - before - down.shape[0]))
        g_s = col.copy_to(g_s, tp.group)

    y = down[slot.clamp(max=e * capacity - 1)]                   # the sentinel's gate is 0
    y = y * (g_s * keep).to(y.dtype)[:, None]
    # back to (token, expert-ascending) order: a permutation, then a fixed sum over k
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n_assign, device=dev)
    y_tok = y[inv].reshape(n, top_k, h)
    by_expert = torch.argsort(top_idx, dim=-1)                   # a token's experts are distinct
    y_tok = torch.gather(y_tok, 1, by_expert[:, :, None].expand(n, top_k, h))
    out = y_tok[:, 0]
    for j in range(1, top_k):
        out = out + y_tok[:, j]
    if tp is not None:
        out = col.reduce_from(out, tp.group).to(x.dtype)
    return out.reshape(b, t, h)


def moe_mlp(x: torch.Tensor, module: MoEMLP):
    """Functional convenience wrapper (the JAX module's)."""
    return module(x)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def router_stats(logits, top_k: int, capacity_factor: float) -> dict:
    """Routing diagnostics from raw router logits: one layer's [B, T, E], a
    stack [L, B, T, E] or a list of per-layer [B, T, E] (tensors or
    arrays).  Per-layer capacity bookkeeping as each layer's sparse
    dispatch sees it, aggregated over layers; host numpy.  Returns the JAX
    function's dict: ``drop_frac``, ``drop_frac_worst_layer``,
    ``load_frac`` [E], ``entropy`` (nats), ``aux`` (mean over layers) and
    ``capacity``."""
    if isinstance(logits, (list, tuple)):
        layers = [_host(lg) for lg in logits]
    else:
        arr = _host(logits)
        layers = list(arr) if arr.ndim == 4 else [arr]

    e = layers[0].shape[-1]
    tot_drop = tot_assign = 0
    worst = 0.0
    load = np.zeros(e)
    aux_sum = ent_sum = ent_n = 0.0
    capacity = None
    for lg in layers:
        x = lg.reshape(-1, e)
        x = x - x.max(axis=-1, keepdims=True)
        probs = np.exp(x)
        probs /= probs.sum(axis=-1, keepdims=True)
        n = probs.shape[0]
        top_idx = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
        counts = np.bincount(top_idx.reshape(-1), minlength=e)
        capacity = capacity_of(n, top_k, e, capacity_factor)
        dropped = int(np.maximum(counts - capacity, 0).sum())
        tot_drop += dropped
        tot_assign += n * top_k
        worst = max(worst, dropped / (n * top_k))
        thresh = np.take_along_axis(probs, top_idx[:, -1:], axis=-1)
        frac = (probs >= thresh).mean(axis=0)
        aux_sum += float(e * np.sum(frac * probs.mean(axis=0)))
        load += counts / n
        p = np.clip(probs, 1e-9, None)
        ent_sum += float(-(p * np.log(p)).sum(-1).sum())
        ent_n += n
    nl = len(layers)
    return {
        "drop_frac": tot_drop / tot_assign,
        "drop_frac_worst_layer": worst,
        "load_frac": load / nl,
        "entropy": ent_sum / ent_n,
        "aux": aux_sum / nl,
        "capacity": capacity,
    }


__all__ = ["EXPERT_PARAMS", "MoEAux", "MoEMLP", "Router", "capacity_of", "moe_mlp",
           "router_stats", "sparse_moe", "top_k_indices"]
