"""Gemma-style causal LM (counterpart of multimodal_concept_learning_tpu/models/lm.py).

The full Gemma-3 block: RMSNorm with float32 ``(1 + w)`` scaling cast back
last, rotary embeddings with separate global and local bases, GQA with
per-head q/k RMSNorm and ``query_pre_attn_scalar`` logit scaling, the
sliding-window layer pattern, sandwich norms, GeGLU MLP (tanh GELU),
embeddings scaled by sqrt(hidden), and an LM head tied to the embedding.
Parameter names are HF Gemma-3's (``model.layers.{i}.self_attn.q_proj``
...), as ``checkpoint/torch_interop.mllm_params_to_torch`` writes them.

Masks: the caller says whether its mask is RIGHT-padded (the collator's
layout and the serving contract) by passing the rows' lengths
(``kv_lens``), decided on the host; attention then takes mask descriptors.
Any other mask (left padding, holes) becomes the JAX
``make_attention_bias`` float32 bias, so ``hidden_states`` matches the
JAX module for every mask and never reads the mask back to the host.
Every parameter is cast where it is used (``device.linear``), so the model
trains float32 parameters in the compute dtype.  Serving may quantize the
seven projections of every block: ``int8_weights`` (``ops/quant.py``) or
``int4_weights`` (``ops/int4.py``; a decode step runs the K5 kernel in each
of them), never both; embedding, head and norms stay float.  ``lora_rank``
adds a LoRA delta (``ops/lora.py``) to each of the seven projections, where
the JAX module adds it.  Entry points: ``embed``,
``hidden_states``, ``prefill_paged`` (fills page pools in place),
``decode_step_paged``, ``lm_head``, and the dense-cache surface of the JAX
module: ``init_kv_cache``, ``prefill``, ``decode_step`` and
``decode_chunk``.  The port writes the caches in place (JAX returns new
ones): one [B, S, Hk, D] tensor per layer and part, no copy a step.
Decode attention takes the JAX float32 bias over the whole cache (the
cache mask, plus ``position - slot < window`` on sliding layers): a
decode query sits at its row's own position, not at S - 1 where K1's
causal and window descriptors would put it.  Page pools may be int8
(``init_paged_kv_cache(..., quantized=True)``): prompt and token writes
quantize, and the decode reads dequantize after a gather (K1 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_concept_learning_tpu_torch.device import linear
from multimodal_concept_learning_tpu_torch.ops.attention import (
    make_attention_bias,
    multi_head_attention,
)
from multimodal_concept_learning_tpu_torch.ops.flash_attention import _NEG
from multimodal_concept_learning_tpu_torch.ops.int4 import Int4Linear
from multimodal_concept_learning_tpu_torch.ops.lora import LoRAAdapter
from multimodal_concept_learning_tpu_torch.ops.moe import MoEAux, MoEMLP
from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
    paged_decode_attention,
    quantize_kv,
    write_prompt_kv,
    write_token_kv,
)
from multimodal_concept_learning_tpu_torch.ops.quant import QuantLinear
from multimodal_concept_learning_tpu_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 2048
    hidden_size: int = 1152
    intermediate_size: int = 6912
    num_layers: int = 26
    num_heads: int = 4
    num_kv_heads: int = 1
    head_dim: int = 256
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    final_logit_softcap: Optional[float] = None
    use_qk_norm: bool = False
    sandwich_norms: bool = False
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 6
    rope_local_theta: float = 10000.0
    query_pre_attn_scalar: Optional[float] = None
    int8_weights: bool = False  # serving: int8 projections (ops/quant.py)
    int4_weights: bool = False  # serving: int4 projections through K5 (ops/int4.py)
    # LoRA (ops/lora.py): rank-r deltas on the seven projections of every
    # block; 0 = off.  The base projection may be float, int8 or int4.
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # Mixture-of-Experts (ops/moe.py): 0 = the dense GeGLU MLP; > 0 puts a
    # top-k routed MoEMLP in every block's MLP place ("dense" dispatch, or
    # "sparse": GShard capacity, dropping over-capacity assignments)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.int8_weights and self.int4_weights:
            raise ValueError("int8_weights and int4_weights are mutually exclusive")
        if self.moe_experts > 0 and (self.int8_weights or self.int4_weights):
            # the JAX refusal: quantizing only the attention projections
            # would leave the expert weights, the bulk of the bytes, float
            raise ValueError(
                "int8_weights/int4_weights do not cover MoE expert MLPs "
                "(moe_experts > 0) — the quantized path would skip the bulk "
                "of the weight bytes; unset quantization or moe_experts"
            )

    def layer_is_sliding(self, i: int) -> bool:
        """HF Gemma-3 layer_types: every ``pattern``-th layer is global."""
        if self.sliding_window is None:
            return False
        return (i + 1) % self.sliding_window_pattern != 0

    def layer_window(self, i: int) -> Optional[int]:
        return self.sliding_window if self.layer_is_sliding(i) else None

    @classmethod
    def preset(cls, name: str, vocab_size: int) -> "LMConfig":
        presets = {
            # google/gemma-3-1b architecture (per its published config)
            "gemma3-1b": dict(hidden_size=1152, intermediate_size=6912, num_layers=26,
                              num_heads=4, num_kv_heads=1, head_dim=256,
                              rope_theta=1_000_000.0, rope_local_theta=10_000.0,
                              use_qk_norm=True, sandwich_norms=True,
                              sliding_window=512, sliding_window_pattern=6,
                              query_pre_attn_scalar=256.0),
            "nano": dict(hidden_size=128, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=32),
            "small": dict(hidden_size=512, intermediate_size=2048, num_layers=6,
                          num_heads=8, num_kv_heads=4, head_dim=64),
        }
        if name not in presets:
            raise ValueError(f"Unknown LM preset: {name}")
        return cls(vocab_size=vocab_size, **presets[name])


class RMSNorm(nn.Module):
    """Gemma RMSNorm: float32 statistics and float32 ``(1 + weight)``
    scaling, cast back to the input dtype last."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        # under tensor parallelism a q/k norm over this rank's heads sees
        # part of its gradient: summed over the model axis (shard_params)
        weight = col.copy_to(self.weight, getattr(self, "_tp_partial", None))
        return (y * (1.0 + weight.float())).to(x.dtype)


Rope = Tuple[torch.Tensor, torch.Tensor]


def projection(cfg: LMConfig, in_features: int, out_features: int) -> nn.Module:
    """A bias-free projection as the config quantizes it."""
    if cfg.int8_weights:
        return QuantLinear(in_features, out_features)
    if cfg.int4_weights:
        return Int4Linear(in_features, out_features)
    return nn.Linear(in_features, out_features, bias=False)


def lora_adapter(cfg: LMConfig, in_features: int, out_features: int) -> LoRAAdapter:
    """The LoRA delta of one projection, as the config sets it."""
    return LoRAAdapter(in_features, out_features, cfg.lora_rank, cfg.lora_alpha, cfg.dtype)


def init_kv_cache(cfg: LMConfig, batch_size: int, cache_len: int, device) -> tuple:
    """Zero per-layer KV caches for ``CausalLM.prefill`` / ``decode_step``:
    one {"k", "v"} dict per layer, each [B, cache_len, kv_heads, head_dim]
    in the compute dtype on ``device`` (the JAX ``init_kv_cache``)."""
    shape = (batch_size, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
                 for _ in range(cfg.num_layers))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> Rope:
    """(sin, cos) tables [B, T, head_dim // 2] for one base frequency."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[:, :, None].float() * freq[None, None, :]
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Rotary embedding over [B, T, H, D] (computed in float32)."""
    sin, cos = rope
    half = x.shape[-1] // 2
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _write_pool(write, pool, page_table, positions, k, v) -> None:
    """``write`` (``write_prompt_kv`` or ``write_token_kv``) K and V into
    the layer's pool; an int8 pool gets codes and scale planes."""
    if "k_scale" not in pool:
        write(pool["k"], page_table, positions, k)
        write(pool["v"], page_table, positions, v)
        return
    for part, kv in (("k", k), ("v", v)):
        codes, scale = quantize_kv(kv)
        write(pool[f"{part}_scale"], page_table, positions, scale)
        write(pool[part], page_table, positions, codes)


class LMAttention(nn.Module):
    """Gemma attention.  Under tensor parallelism (``self._tp``, a
    ``parallel.sharding_rules.AttentionPlan``) ``self.cfg`` counts this
    rank's query and KV heads and ``full_cfg`` the model's: the column-
    parallel q/k/v outputs are this rank's heads (or are gathered when a
    projection splits a head), a replicated K/V is narrowed to the heads
    the local queries read, and the attention output enters the
    row-parallel o projection as its local input rows."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = self.full_cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = projection(cfg, h, cfg.num_heads * d)
        self.k_proj = projection(cfg, h, cfg.num_kv_heads * d)
        self.v_proj = projection(cfg, h, cfg.num_kv_heads * d)
        self.o_proj = projection(cfg, cfg.num_heads * d, h)
        if cfg.lora_rank > 0:
            self.q_proj_lora = lora_adapter(cfg, h, cfg.num_heads * d)
            self.k_proj_lora = lora_adapter(cfg, h, cfg.num_kv_heads * d)
            self.v_proj_lora = lora_adapter(cfg, h, cfg.num_kv_heads * d)
            self.o_proj_lora = lora_adapter(cfg, cfg.num_heads * d, h)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(d, cfg.rms_norm_eps)
            self.k_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.scale = (cfg.query_pre_attn_scalar ** -0.5
                      if cfg.query_pre_attn_scalar is not None else None)

    def _qkv(self, x: torch.Tensor, rope: Rope):
        cfg = self.cfg
        b, t, _ = x.shape
        q, k, v = (linear(p, x, cfg.dtype) for p in (self.q_proj, self.k_proj, self.v_proj))
        if cfg.lora_rank > 0:  # on the projection outputs, before qk-norm and rope (as JAX)
            q = q + self.q_proj_lora(x)
            k = k + self.k_proj_lora(x)
            v = v + self.v_proj_lora(x)
        plan = getattr(self, "_tp", None)
        if plan is not None:  # columns split mid-head: the whole heads, on every rank
            q, k, v = (col.gather_from(y, plan.group, -1) if mode == "gather" else y
                       for y, mode in ((q, plan.q), (k, plan.k), (v, plan.k)))
        q = q.view(b, t, -1, cfg.head_dim)
        k = k.view(b, t, -1, cfg.head_dim)
        v = v.view(b, t, -1, cfg.head_dim)
        if cfg.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k = apply_rope(q, rope), apply_rope(k, rope)
        if plan is not None and plan.kv_sel is not None:
            # the replicated K/V heads this rank's queries read
            sel = torch.tensor(plan.kv_sel, device=k.device)
            k = col.copy_to(k, plan.group).index_select(2, sel)
            v = col.copy_to(v, plan.group).index_select(2, sel)
        return q, k, v

    def _out(self, attn: torch.Tensor) -> torch.Tensor:
        """o_proj (plus its LoRA delta) of the flattened heads [B, T, heads * D]."""
        plan = getattr(self, "_tp", None)
        if plan is not None and plan.o == "scatter":
            attn = col.scatter_to(attn, plan.group, -1)
        elif plan is not None and plan.o == "gather":
            attn = col.gather_from(attn, plan.group, -1)
        out = linear(self.o_proj, attn, self.cfg.dtype)
        if self.cfg.lora_rank > 0:
            out = out + self.o_proj_lora(attn)
        return out

    def forward(self, x, rope: Rope, *, kv_lens=None, window: Optional[int] = None,
                bias=None, causal: bool = True, pool=None, page_table=None,
                cache=None) -> torch.Tensor:
        """Self-attention over the prompt, masked by the descriptors
        (``kv_lens``, ``causal``, ``window``) and/or an additive ``bias``;
        with ``pool`` ({"k","v"} page pools) the prompt's K/V are also
        written into ``page_table``'s pages (positions >= kv_lens go to the
        null page; an int8 pool takes codes and scales); with ``cache``
        ({"k","v"} [B, S, Hk, D]) into its slots [0:T], padding included
        (the decode mask hides those slots)."""
        b, t, _ = x.shape
        q, k, v = self._qkv(x, rope)
        if pool is not None:
            _write_pool(write_prompt_kv, pool, page_table, kv_lens, k, v)
        if cache is not None:
            cache["k"][:, :t] = k
            cache["v"][:, :t] = v
        attn = multi_head_attention(q, k, v, bias, scale=self.scale, kv_lens=kv_lens,
                                    causal=causal, window=window)
        return self._out(attn.reshape(b, t, -1))

    def decode_paged(self, x, rope: Rope, pool, page_table, seq_lens,
                     window: Optional[int]) -> torch.Tensor:
        """One token per row: write its K/V at position ``seq_lens`` and
        attend against the pool (positions < seq_lens + 1); an int8 pool
        takes the dequantizing gather read."""
        b = x.shape[0]
        q, k, v = self._qkv(x, rope)
        _write_pool(write_token_kv, pool, page_table, seq_lens, k[:, 0], v[:, 0])
        attn = paged_decode_attention(q, pool["k"], pool["v"], page_table, seq_lens + 1,
                                      scale=self.scale, window=window,
                                      pool_k_scale=pool.get("k_scale"),
                                      pool_v_scale=pool.get("v_scale"))
        return self._out(attn.reshape(b, 1, -1))

    def decode_dense(self, x, rope: Rope, cache, slots, bias) -> torch.Tensor:
        """G tokens per row (x [B, G, H]): write their K/V into ``cache`` at
        ``slots`` [B, G] and attend against the whole cache under the float32
        ``bias`` [B, 1, G, S]."""
        b, g, _ = x.shape
        q, k, v = self._qkv(x, rope)
        rows = torch.arange(b, device=x.device)[:, None]
        slots = slots.long()
        cache["k"][rows, slots] = k
        cache["v"][rows, slots] = v
        attn = multi_head_attention(q, cache["k"], cache["v"], bias, scale=self.scale)
        return self._out(attn.reshape(b, g, -1))


class LMMLP(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.lora = cfg.lora_rank > 0
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = projection(cfg, h, f)
        self.up_proj = projection(cfg, h, f)
        self.down_proj = projection(cfg, f, h)
        if self.lora:
            self.gate_proj_lora = lora_adapter(cfg, h, f)
            self.up_proj_lora = lora_adapter(cfg, h, f)
            self.down_proj_lora = lora_adapter(cfg, f, h)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        gate, up = linear(self.gate_proj, h, dt), linear(self.up_proj, h, dt)
        if self.lora:
            gate = gate + self.gate_proj_lora(h)
            up = up + self.up_proj_lora(h)
        y = F.gelu(gate, approximate="tanh") * up
        out = linear(self.down_proj, y, dt)
        if self.lora:
            out = out + self.down_proj_lora(y)
        return out


class LMBlock(nn.Module):
    """One decoder block.  Under ``moe_experts`` the MLP is a ``MoEMLP``
    named ``moe`` (no MLP LoRA adapters, as in JAX; attention keeps its);
    each forward path takes ``moe_aux`` (an ``ops.moe.MoEAux``), to which
    the block appends its aux."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.rms_norm_eps
        self.self_attn = LMAttention(cfg)
        if cfg.moe_experts > 0:
            self.moe = MoEMLP(cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts,
                              top_k=cfg.moe_top_k, dtype=cfg.dtype, dispatch=cfg.moe_dispatch,
                              capacity_factor=cfg.moe_capacity_factor)
        else:
            self.mlp = LMMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        if cfg.sandwich_norms:
            self.pre_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)
            self.post_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)

    def _ffn(self, h: torch.Tensor, moe_aux: Optional[MoEAux]) -> torch.Tensor:
        if self.cfg.moe_experts == 0:
            return self.mlp(h)
        out, aux = self.moe(h, moe_aux)
        if moe_aux is not None:
            moe_aux.aux.append(aux)
        return out

    def _residual(self, x: torch.Tensor, h: torch.Tensor, moe_aux=None) -> torch.Tensor:
        if self.cfg.sandwich_norms:
            # Gemma-2/3: the post-attn norm wraps the attention output before
            # the residual add; the MLP has its own pre/post norms
            x = x + self.post_attention_layernorm(h)
            h = self.post_feedforward_layernorm(
                self._ffn(self.pre_feedforward_layernorm(x), moe_aux))
            return x + h
        x = x + h  # Gemma-1/llama: the post-attn norm is the pre-MLP norm
        return x + self._ffn(self.post_attention_layernorm(x), moe_aux)

    def forward(self, x, rope: Rope, moe_aux: Optional[MoEAux] = None,
                **attn_kwargs) -> torch.Tensor:
        return self._residual(x, self.self_attn(self.input_layernorm(x), rope, **attn_kwargs),
                              moe_aux)

    def decode_paged(self, x, rope: Rope, *args, moe_aux=None) -> torch.Tensor:
        return self._residual(x, self.self_attn.decode_paged(self.input_layernorm(x), rope, *args),
                              moe_aux)

    def decode_dense(self, x, rope: Rope, *args, moe_aux=None) -> torch.Tensor:
        return self._residual(x, self.self_attn.decode_dense(self.input_layernorm(x), rope, *args),
                              moe_aux)


class _DecoderStack(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LMBlock(cfg) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)


class CausalLM(nn.Module):
    """Decoder-only LM with the JAX module's decomposed surface."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _DecoderStack(cfg)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        # Gemma scales embeddings by sqrt(hidden), the factor rounded to the
        # compute dtype first (as the JAX module does)
        dtype = self.cfg.dtype
        scale = torch.tensor(self.cfg.hidden_size ** 0.5, dtype=dtype, device=input_ids.device)
        emb = self.model.embed_tokens
        tp = getattr(emb, "_tp", None)
        if tp is None:
            return emb(input_ids.long()).to(dtype) * scale
        # vocab-sharded table: this rank's rows, zeros elsewhere, summed over the model axis
        local = input_ids.long() - tp.offset
        mine = (local >= 0) & (local < tp.count)
        rows = F.embedding(local.clamp(0, tp.count - 1), emb.weight) * mine[..., None]
        return col.reduce_from(rows, tp.group).to(dtype) * scale

    def _ropes(self, positions: torch.Tensor) -> Tuple[Rope, Rope]:
        cfg = self.cfg
        rope_global = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        if cfg.sliding_window is None:
            return rope_global, rope_global
        return rope_global, rope_tables(positions, cfg.head_dim, cfg.rope_local_theta)

    def layer_inputs(self, attention_mask, kv_lens, b: int, t: int, device):
        """(per-layer attention keywords, global rope, sliding rope) of a
        [B, T] prompt: mask descriptors under ``kv_lens``, else the JAX
        bias built once per window; no mask is a causal [B, T] prompt."""
        cfg = self.cfg
        masks = [dict(causal=True, window=cfg.layer_window(i)) for i in range(cfg.num_layers)]
        if attention_mask is not None:
            positions = (attention_mask.long().cumsum(dim=1) - 1).clamp(min=0)
            if kv_lens is not None:
                for m in masks:
                    m["kv_lens"] = kv_lens
            else:  # left padding or holes: the JAX bias, built once per window
                biases = {}
                for m in masks:
                    w = m.pop("window")
                    w = w if w is not None and t > w else None  # below t the window masks nothing
                    if w not in biases:
                        biases[w] = make_attention_bias(attention_mask, True, t, t, window=w)
                    m.update(bias=biases[w], causal=False)
        else:
            positions = torch.arange(t, device=device)[None].expand(b, t)
        rope_global, rope_sliding = self._ropes(positions)
        return masks, rope_global, rope_sliding

    def run_layer(self, i: int, layer, x, inputs, moe_aux=None, **kw) -> torch.Tensor:
        """Block ``layer`` as global layer ``i`` (its window and rope) of
        ``layer_inputs``' ``inputs``."""
        masks, rope_global, rope_sliding = inputs
        rope = rope_sliding if self.cfg.layer_is_sliding(i) else rope_global
        return layer(x, rope, moe_aux=moe_aux, **masks[i], **kw)

    def _prompt(self, inputs_embeds, attention_mask, kv_lens=None, pools=None, page_table=None,
                caches=None, moe_aux=None):
        b, t, _ = inputs_embeds.shape
        inputs = self.layer_inputs(attention_mask, kv_lens, b, t, inputs_embeds.device)
        x = inputs_embeds.to(self.cfg.dtype)
        for i, layer in enumerate(self.model.layers):
            kw = {}
            if pools is not None:
                kw = dict(pool=pools[i], page_table=page_table)
            if caches is not None:
                kw = dict(kw, cache=caches[i])
            x = self.run_layer(i, layer, x, inputs, moe_aux=moe_aux, **kw)
        return self.model.norm(x)

    def hidden_states(self, inputs_embeds: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      kv_lens: Optional[torch.Tensor] = None,
                      moe_aux: Optional[MoEAux] = None) -> torch.Tensor:
        """Final-norm hidden states [B, T, H] under any [B, T] 1/0 mask.
        ``kv_lens`` [B] int32, the mask's row sums, says that the mask is
        right-padded (attention takes descriptors); without it the mask
        goes to attention as a bias.  Under MoE, ``moe_aux`` collects each
        layer's aux (the JAX module sows them)."""
        if kv_lens is not None and attention_mask is None:
            raise ValueError("kv_lens describes an attention mask; pass the mask too")
        return self._prompt(inputs_embeds, attention_mask, kv_lens, moe_aux=moe_aux)

    def prefill_paged(self, inputs_embeds, attention_mask, pools, page_table) -> torch.Tensor:
        """Forward the prompt, writing K/V into the page pools IN PLACE.
        Each row's pages in ``page_table`` must cover its whole generation.
        Returns hidden [B, T, H]."""
        if attention_mask is None:
            raise ValueError("prefill_paged needs the prompt's attention mask")
        kv_lens = attention_mask.sum(dim=1).to(torch.int32)  # right-padded: the serving contract
        return self._prompt(inputs_embeds, attention_mask, kv_lens, pools, page_table)

    def decode_step_paged(self, inputs_embeds, pools, page_table, seq_lens) -> torch.Tensor:
        """One decode step: inputs_embeds [B, 1, H]; seq_lens [B] int32
        committed tokens per row (the new token's position; its page must be
        allocated).  Updates the pools in place; returns hidden [B, 1, H]."""
        cfg = self.cfg
        rope_global, rope_sliding = self._ropes(seq_lens[:, None])
        x = inputs_embeds.to(cfg.dtype)
        for i, layer in enumerate(self.model.layers):
            rope = rope_sliding if cfg.layer_is_sliding(i) else rope_global
            x = layer.decode_paged(x, rope, pools[i], page_table, seq_lens, cfg.layer_window(i))
        return self.model.norm(x)

    def prefill(self, inputs_embeds, attention_mask, caches, kv_lens=None) -> torch.Tensor:
        """Forward the prompt, writing its K/V into slots [0:T] of the dense
        ``caches`` (``init_kv_cache``, S >= T + new tokens) IN PLACE.
        ``kv_lens`` says the mask is right-padded (attention takes
        descriptors), as in ``hidden_states``.  Returns hidden [B, T, H]."""
        if attention_mask is None:
            raise ValueError("prefill needs the prompt's attention mask")
        return self._prompt(inputs_embeds, attention_mask, kv_lens, caches=caches)

    def _cache_biases(self, attendable: torch.Tensor, qpos: torch.Tensor):
        """(global, sliding) float32 biases [B, 1, G, S] from ``attendable``
        [B, G|1, S] and the query positions ``qpos`` [B, G] (slot index ==
        position, as right-padded prompts keep it)."""
        bias_global = torch.where(attendable, 0.0, _NEG)[:, None].float()
        if self.cfg.sliding_window is None:
            return bias_global, bias_global
        slots = torch.arange(attendable.shape[-1], device=qpos.device)
        in_window = qpos[:, :, None] - slots < self.cfg.sliding_window
        return bias_global, bias_global + torch.where(in_window, 0.0, _NEG)[:, None].float()

    def _decode_layers(self, inputs_embeds, caches, qpos, biases, num_layers=None):
        cfg = self.cfg
        rope_global, rope_sliding = self._ropes(qpos)
        x = inputs_embeds.to(cfg.dtype)
        for i, layer in enumerate(self.model.layers[:num_layers]):
            sliding = cfg.layer_is_sliding(i)
            x = layer.decode_dense(x, rope_sliding if sliding else rope_global, caches[i], qpos,
                                   biases[sliding])
        return self.model.norm(x)

    def decode_step(self, inputs_embeds, caches, seq_lens, cache_mask) -> torch.Tensor:
        """One decode step (the JAX ``decode_step``): inputs_embeds [B, 1, H]
        of the newest token; ``seq_lens`` [B] real tokens so far (the new
        token's slot and rope position); ``cache_mask`` [B, S] 1 on every
        valid slot INCLUDING the new token's.  Writes the caches in place;
        returns hidden [B, 1, H]."""
        qpos = seq_lens[:, None]
        biases = self._cache_biases(cache_mask.bool()[:, None, :], qpos)
        return self._decode_layers(inputs_embeds, caches, qpos, biases)

    def decode_chunk(self, inputs_embeds, caches, start_lens, cache_mask,
                     num_layers: Optional[int] = None) -> torch.Tensor:
        """G tokens per row against the cache (the JAX ``decode_chunk``):
        token i of row b goes to slot and position ``start_lens[b] + i``;
        ``cache_mask`` [B, S] marks only the committed prefix (slots <
        start), and token i sees the chunk's slots up to its own.
        ``num_layers`` runs only the first N blocks (the early-exit draft;
        ``final_norm`` is shared).  Writes the caches of the blocks that ran
        in place; returns hidden [B, G, H]."""
        b, g, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        slots = torch.arange(cache_mask.shape[1], device=dev)
        start = start_lens[:, None, None]
        qpos = start_lens[:, None] + torch.arange(g, device=dev)[None, :]
        prefix = cache_mask.bool()[:, None, :] & (slots < start)
        within = (slots <= qpos[:, :, None]) & (slots >= start)
        return self._decode_layers(inputs_embeds, caches, qpos,
                                   self._cache_biases(prefix | within, qpos), num_layers)

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied head: float32 logits of compute-dtype operands (the JAX
        einsum with preferred_element_type=float32)."""
        dtype = self.cfg.dtype
        emb = self.model.embed_tokens.weight.to(dtype).float()
        tp = getattr(self.model.embed_tokens, "_tp", None)
        if tp is None:
            logits = hidden.to(dtype).float() @ emb.T
        else:  # this rank's vocab columns, gathered over the model axis
            logits = col.gather_from(col.copy_to(hidden.to(dtype).float(), tp.group) @ emb.T,
                                     tp.group, -1)
        if self.cfg.final_logit_softcap is not None:
            cap = self.cfg.final_logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits


__all__ = ["CausalLM", "LMConfig", "RMSNorm", "apply_rope", "init_kv_cache", "rope_tables"]
