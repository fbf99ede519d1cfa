"""FLOPs and bytes of the benchmark's transformer steps, from the shapes.

The bound rule (the one the port's kernel table uses): a kernel's least
time is the larger of its operations over the chip's peak bf16 rate and
its bytes over the peak memory bandwidth, counting every input read once
and every output written once, whatever the kernel reads again.

- A product ``[M, K] x [K, N]`` is ``2 M K N`` FLOPs.  In a train step its
  backward computes the weight's gradient and, where the input needs one,
  the input's (the patch embedding's input is the images: no gradient), so
  it is done 2 or 3 times.
- Attention at ``heads`` heads of size ``D``: ``4 D`` FLOPs a valid
  query-key pair in the forward pass (``Q K^T`` and ``P V``), ``8 D`` in
  the backward (``dV``, ``dP``, ``dQ``, ``dK``), nothing for a recompute.
  A pair is valid when its key is unmasked (the caption mask) and, under
  causality, not after the query.  Bytes in bf16: forward ``q`` and the
  output for every row, ``k`` and ``v`` up to each sample's last valid
  key; backward ``q``, ``dO``, ``dq`` for every row and ``k``, ``v``,
  ``dk``, ``dv`` up to the last valid key.
- A model's FLOPs for its utilization: the forward products plus the
  forward attention over valid pairs, times 3 for a train step (the usual
  convention; no recompute counted).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

BF16 = 2  # bytes


@dataclasses.dataclass(frozen=True)
class Product:
    m: int
    k: int
    n: int
    input_grad: bool = True  # a train step also computes the input's gradient

    def flops(self, train: bool) -> float:
        once = 2.0 * self.m * self.k * self.n
        return once * ((3 if self.input_grad else 2) if train else 1)


@dataclasses.dataclass(frozen=True)
class Attention:
    """One attention call: ``batch`` samples of ``rows`` queries at
    ``heads`` x ``head_dim``; ``keys`` the valid keys (to the last) of each
    sample, ``pairs`` the valid pairs of each sample, per head."""
    heads: int
    head_dim: int
    rows: int
    keys: Tuple[int, ...]
    pairs: Tuple[int, ...]

    def flops(self, backward: bool) -> float:
        return (8.0 if backward else 4.0) * self.head_dim * self.heads * sum(self.pairs)

    def bytes(self, backward: bool) -> float:
        width = self.heads * self.head_dim * BF16
        per_row, per_key = (3, 4) if backward else (2, 2)
        return width * (per_row * self.rows * len(self.keys) + per_key * sum(self.keys))

    def bound_s(self, train: bool, peak_flops: float, peak_bytes: float) -> float:
        def one(bwd):
            return max(self.flops(bwd) / peak_flops, self.bytes(bwd) / peak_bytes)
        return one(False) + (one(True) if train else 0.0)


def full(batch: int, rows: int, heads: int, head_dim: int) -> Attention:
    return Attention(heads, head_dim, rows, (rows,) * batch, (rows * rows,) * batch)


def causal_masked(lengths: Sequence[int], rows: int, heads: int, head_dim: int) -> Attention:
    """Causal attention whose keys past each sample's length are masked."""
    return Attention(heads, head_dim, rows, tuple(int(n) for n in lengths),
                     tuple(int(n) * (int(n) + 1) // 2 + (rows - int(n)) * int(n)
                           for n in lengths))


def vit_tower(batch: int, cfg: dict) -> Tuple[List[Product], List[Attention]]:
    """The image tower's products and attention calls at ``batch`` images."""
    h, i, ps = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    patches = (cfg["image_size"] // ps) ** 2
    t = patches + 1
    rows = batch * t
    prods = [Product(batch * patches, cfg["num_channels"] * ps * ps, h, input_grad=False)]
    attn = []
    heads = cfg["num_attention_heads"]
    for _ in range(cfg["num_hidden_layers"]):
        prods += [Product(rows, h, 3 * h), Product(rows, h, h), Product(rows, h, i),
                  Product(rows, i, h)]
        attn.append(full(batch, t, heads, h // heads))
    return prods, attn


def text_tower(lengths: Sequence[int], cfg: dict) -> Tuple[List[Product], List[Attention]]:
    w, t, heads = cfg["text_width"], cfg["context_length"], cfg["text_heads"]
    rows = len(lengths) * t
    prods, attn = [], []
    for _ in range(cfg["text_layers"]):
        prods += [Product(rows, w, 3 * w), Product(rows, w, w), Product(rows, w, 4 * w),
                  Product(rows, 4 * w, w)]
        attn.append(causal_masked(lengths, t, heads, w // heads))
    prods.append(Product(len(lengths), w, cfg["embed_dim"]))
    return prods, attn


class Step:
    """The work of one step: its products and attention calls."""

    def __init__(self, products: List[Product], attention: List[Attention], train: bool):
        self.products, self.attention, self.train = products, attention, train

    def product_flops(self) -> float:
        return sum(p.flops(self.train) for p in self.products)

    def model_flops(self) -> float:
        fwd = sum(p.flops(False) for p in self.products)
        fwd += sum(a.flops(False) for a in self.attention)
        return fwd * (3 if self.train else 1)

    def attention_bound_s(self, peak_flops: float, peak_bytes: float) -> float:
        return sum(a.bound_s(self.train, peak_flops, peak_bytes) for a in self.attention)
