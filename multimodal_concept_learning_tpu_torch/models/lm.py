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
trains float32 parameters in the compute dtype.  Entry points: ``embed``,
``hidden_states``, ``prefill_paged`` (fills page pools in place),
``decode_step_paged`` and ``lm_head``.
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
from multimodal_concept_learning_tpu_torch.ops.paged_kv import (
    paged_decode_attention,
    write_prompt_kv,
    write_token_kv,
)


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
    dtype: torch.dtype = torch.bfloat16

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
        return (y * (1.0 + self.weight.float())).to(x.dtype)


Rope = Tuple[torch.Tensor, torch.Tensor]


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


class LMAttention(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_heads * d, bias=False)
        self.k_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.v_proj = nn.Linear(h, cfg.num_kv_heads * d, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * d, h, bias=False)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(d, cfg.rms_norm_eps)
            self.k_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.scale = (cfg.query_pre_attn_scalar ** -0.5
                      if cfg.query_pre_attn_scalar is not None else None)

    def _qkv(self, x: torch.Tensor, rope: Rope):
        cfg = self.cfg
        b, t, _ = x.shape
        q = linear(self.q_proj, x, cfg.dtype).view(b, t, cfg.num_heads, cfg.head_dim)
        k = linear(self.k_proj, x, cfg.dtype).view(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = linear(self.v_proj, x, cfg.dtype).view(b, t, cfg.num_kv_heads, cfg.head_dim)
        if cfg.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        return apply_rope(q, rope), apply_rope(k, rope), v

    def forward(self, x, rope: Rope, *, kv_lens=None, window: Optional[int] = None,
                bias=None, causal: bool = True, pool=None, page_table=None) -> torch.Tensor:
        """Self-attention over the prompt, masked by the descriptors
        (``kv_lens``, ``causal``, ``window``) and/or an additive ``bias``;
        with ``pool`` ({"k","v"} page pools) the prompt's K/V are also
        written into ``page_table``'s pages (positions >= kv_lens go to the
        null page)."""
        b, t, _ = x.shape
        q, k, v = self._qkv(x, rope)
        if pool is not None:
            write_prompt_kv(pool["k"], page_table, kv_lens, k)
            write_prompt_kv(pool["v"], page_table, kv_lens, v)
        attn = multi_head_attention(q, k, v, bias, scale=self.scale, kv_lens=kv_lens,
                                    causal=causal, window=window)
        return linear(self.o_proj, attn.reshape(b, t, -1), self.cfg.dtype)

    def decode_paged(self, x, rope: Rope, pool, page_table, seq_lens,
                     window: Optional[int]) -> torch.Tensor:
        """One token per row: write its K/V at position ``seq_lens`` and
        attend against the pool (positions < seq_lens + 1)."""
        b = x.shape[0]
        q, k, v = self._qkv(x, rope)
        write_token_kv(pool["k"], page_table, seq_lens, k[:, 0])
        write_token_kv(pool["v"], page_table, seq_lens, v[:, 0])
        attn = paged_decode_attention(q, pool["k"], pool["v"], page_table, seq_lens + 1,
                                      scale=self.scale, window=window)
        return linear(self.o_proj, attn.reshape(b, 1, -1), self.cfg.dtype)


class LMMLP(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        gate = F.gelu(linear(self.gate_proj, h, dt), approximate="tanh")
        return linear(self.down_proj, gate * linear(self.up_proj, h, dt), dt)


class LMBlock(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.rms_norm_eps
        self.self_attn = LMAttention(cfg)
        self.mlp = LMMLP(cfg)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        if cfg.sandwich_norms:
            self.pre_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)
            self.post_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)

    def _residual(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.sandwich_norms:
            # Gemma-2/3: the post-attn norm wraps the attention output before
            # the residual add; the MLP has its own pre/post norms
            x = x + self.post_attention_layernorm(h)
            h = self.post_feedforward_layernorm(self.mlp(self.pre_feedforward_layernorm(x)))
            return x + h
        x = x + h  # Gemma-1/llama: the post-attn norm is the pre-MLP norm
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, rope: Rope, **attn_kwargs) -> torch.Tensor:
        return self._residual(x, self.self_attn(self.input_layernorm(x), rope, **attn_kwargs))

    def decode_paged(self, x, rope: Rope, *args) -> torch.Tensor:
        return self._residual(x, self.self_attn.decode_paged(self.input_layernorm(x), rope, *args))


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
        return self.model.embed_tokens(input_ids.long()).to(dtype) * scale

    def _ropes(self, positions: torch.Tensor) -> Tuple[Rope, Rope]:
        cfg = self.cfg
        rope_global = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        if cfg.sliding_window is None:
            return rope_global, rope_global
        return rope_global, rope_tables(positions, cfg.head_dim, cfg.rope_local_theta)

    def _prompt(self, inputs_embeds, attention_mask, kv_lens=None, pools=None, page_table=None):
        cfg = self.cfg
        b, t, _ = inputs_embeds.shape
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
            positions = torch.arange(t, device=inputs_embeds.device)[None].expand(b, t)
        rope_global, rope_sliding = self._ropes(positions)
        x = inputs_embeds.to(cfg.dtype)
        for i, layer in enumerate(self.model.layers):
            kw = masks[i]
            if pools is not None:
                kw = dict(kw, pool=pools[i], page_table=page_table)
            x = layer(x, rope_sliding if cfg.layer_is_sliding(i) else rope_global, **kw)
        return self.model.norm(x)

    def hidden_states(self, inputs_embeds: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None,
                      kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-norm hidden states [B, T, H] under any [B, T] 1/0 mask.
        ``kv_lens`` [B] int32, the mask's row sums, says that the mask is
        right-padded (attention takes descriptors); without it the mask
        goes to attention as a bias."""
        if kv_lens is not None and attention_mask is None:
            raise ValueError("kv_lens describes an attention mask; pass the mask too")
        return self._prompt(inputs_embeds, attention_mask, kv_lens)

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

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied head: float32 logits of compute-dtype operands (the JAX
        einsum with preferred_element_type=float32)."""
        dtype = self.cfg.dtype
        emb = self.model.embed_tokens.weight.to(dtype).float()
        logits = hidden.to(dtype).float() @ emb.T
        if self.cfg.final_logit_softcap is not None:
            cap = self.cfg.final_logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits


__all__ = ["CausalLM", "LMConfig", "RMSNorm", "apply_rope", "rope_tables"]
