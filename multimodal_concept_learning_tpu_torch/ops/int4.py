"""Int4 weight-only quantization for the decode path (counterpart of
multimodal_concept_learning_tpu/ops/int4.py).

- **Storage** (the JAX layout, bit for bit, so quantized trees interchange):
  ``packed`` int8 [in/2, out], two 4-bit codes per byte, the low nibble
  holding input row ``i`` and the high nibble row ``i + in/2``; ``scale``
  bf16 [in/group, out], one scale per ``group`` input rows and output
  column.  The orientation is JAX's [in, out], the transpose of
  ``nn.Linear.weight``.
- **Compute**: ``int4_matmul`` is the wrapper of the CUDA kernel K5
  ``csrc/int4_matmul.cu``, which replaces the Pallas TPU kernel
  ``multimodal_concept_learning_tpu/ops/int4.py:_kernel``.  On a CUDA
  tensor with at most 64 rows (a decode step) it launches K5 or raises
  (split-K over thread block clusters on the tensor cores; ``k5_plan``
  picks the stripes and clusters);
  with more rows (prefill) it dequantizes and runs one matrix product, as
  the JAX package leaves that case to XLA.  CPU tensors run
  ``int4_matmul_reference``, the JAX fallback's math: x rounded to bf16,
  the weight dequantized in float32 and rounded to bf16 once, a
  float32-accumulated product, the result cast to x's dtype.
- **A/B variants** (off every model path): ``v3a_matmul`` and
  ``v3b_matmul`` wrap K5v3a and K5v3b (``csrc/int4_matmul_v3.cu``), which
  replace the JAX script ``scripts/bench_int4_kernel.py:_kernel_v3a`` and
  ``_kernel_v3b``; beside them their plain versions.  They share K5's
  split-K frame (``csrc/int4_split.cuh``) with whole groups a CTA
  (``v3_plan``); v3b quantizes x inside its kernel.  Only the port's A/B
  entry point (``scripts/bench_int4_kernel.py``) calls them.
- **Modules**: ``Int4Linear`` holds ``packed``/``scale`` (and an optional
  float ``bias``) as buffers; it is not an ``nn.Linear``, so the device
  policy's casts leave its integer weights alone.  ``axis``/``features``
  give the JAX ``Int4DenseGeneral`` form (the o_proj case).  Converters
  turn a float state dict of the port into the int4 layout.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn

from multimodal_concept_learning_tpu_torch.ops._build import cuda_operand

GROUP_SIZE = 64
MAX_KERNEL_ROWS = 64  # decode-shaped calls take K5; more rows take the prefill product
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K5's split plan (csrc/int4_matmul.cu): output stripes of K5_WIDTHS columns,
# the 16-row units of the packed rows split over a thread block cluster of
# K5_CLUSTERS CTAs a stripe
K5_TARGET_CTAS = 264  # 2 CTAs an SM of an H100
K5_WIDTHS = (64, 32, 16, 8)
K5_CLUSTERS = (1, 2, 4, 8, 16)
K5_UNIT = 16  # packed rows a unit
K5_CHUNK_UNITS = 16  # units a CTA stages at once (kChunkUnits)


def quantize_weight_int4(w: torch.Tensor, group_size: int = GROUP_SIZE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric group-wise int4 quantization of ``w [in, out]``:
    (packed int8 [in/2, out], scale bf16 [in/group_size, out]), bitwise the
    JAX ``quantize_weight_int4``."""
    d_in, d_out = w.shape
    if d_in % (2 * group_size):
        raise ValueError(f"in features {d_in} must be a multiple of 2 * group_size "
                         f"({2 * group_size})")
    w32 = w.float().contiguous().reshape(d_in // group_size, group_size, d_out)
    absmax = w32.abs().amax(dim=1)
    scale = (absmax.clamp(min=1e-8) / 7.0).to(torch.bfloat16)
    w_q = torch.clamp(torch.round(w32 / scale.float()[:, None, :]), -7, 7)
    w_q = w_q.reshape(d_in, d_out).to(torch.int32)
    half = d_in // 2
    packed = (w_q[:half] & 0xF) | ((w_q[half:] & 0xF) << 4)
    return packed.to(torch.int8), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 [in/2, out] -> int8 codes [in, out] (low-nibble rows
    over high-nibble rows)."""
    p32 = packed.to(torch.int32)
    lo = ((p32 & 0xF) ^ 8) - 8
    hi = (((p32 >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    group_size: int = GROUP_SIZE) -> torch.Tensor:
    """The float32 weight [in, out] of the packed layout."""
    w_q = unpack_int4(packed).float()
    d_in, d_out = w_q.shape
    w_g = w_q.reshape(d_in // group_size, group_size, d_out)
    return (w_g * scale.float()[:, None, :]).reshape(d_in, d_out)


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                          group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version of K5 (the JAX fallback's math): ``x [..., in] @
    bf16(dequantize_int4)`` with bf16 operands and float32 accumulation,
    cast to x's dtype."""
    w = dequantize_int4(packed, scale, group_size).to(torch.bfloat16)
    x2d = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
    y = x2d.float() @ w.float()  # bf16 x bf16 products are exact in float32
    return y.reshape(*x.shape[:-1], w.shape[1]).to(x.dtype)


def _prefill_matmul(x2d: torch.Tensor, packed, scale, group_size: int) -> torch.Tensor:
    """Many rows on the card: dequantize, then one library matrix product
    (float32 accumulation; bf16 output for bf16 x, as the JAX fallback's
    float32 result cast to bf16)."""
    w = dequantize_int4(packed, scale, group_size).to(torch.bfloat16)
    if x2d.dtype == torch.bfloat16:
        return x2d @ w
    return x2d.to(torch.bfloat16).float() @ w.float()


def _check_operands(x2d, packed, scale, group_size: int, what: str) -> None:
    """The operands every int4 kernel takes (K5 and its variants)."""
    rows, d_in = x2d.shape
    half, d_out = packed.shape
    if x2d.dtype not in _X_DTYPES:
        raise TypeError(f"{what} takes float32/bfloat16 activations, got {x2d.dtype}")
    if d_in != 2 * half:
        raise ValueError(f"{what}: x {tuple(x2d.shape)} does not match packed "
                         f"{tuple(packed.shape)}")
    if packed.dtype != torch.int8 or scale.dtype != torch.bfloat16:
        raise TypeError(f"packed must be int8 and scale bfloat16, got {packed.dtype}, "
                        f"{scale.dtype}")
    if d_out % 16 or d_in % (2 * group_size) or tuple(scale.shape) != (d_in // group_size, d_out):
        raise ValueError(f"{what}: out {d_out} must be a multiple of 16, in {d_in} of "
                         f"2 * group_size, scale [{d_in // group_size}, {d_out}]; got "
                         f"{tuple(scale.shape)}")
    for name, t in (("packed", packed), ("scale", scale)):
        if t.device != x2d.device:
            raise ValueError(f"{name} must be on x's device, got {t.device}")


def _check_kernel_args(x2d, packed, scale, group_size: int) -> None:
    _check_operands(x2d, packed, scale, group_size, "int4 kernel")
    if group_size % K5_UNIT or x2d.shape[0] > MAX_KERNEL_ROWS:
        raise ValueError(f"int4 kernel takes a group size that is a multiple of {K5_UNIT} and "
                         f"at most {MAX_KERNEL_ROWS} rows, got group {group_size}, "
                         f"{x2d.shape[0]} rows")


def kernel_operands(x2d, packed, scale, group_size: int, kernel: str = "K5"):
    """Check what the int4 kernel ``kernel`` (K5, K5v3a or K5v3b) takes and
    return (x2d, packed, scale) as it reads them: contiguous and 16-byte
    aligned, copied only if they are not (a strided or offset view, which
    the JAX functions take)."""
    if kernel == "K5":
        _check_kernel_args(x2d, packed, scale, group_size)
    else:
        _check_operands(x2d, packed, scale, group_size, kernel)
        if x2d.shape[0] > MAX_KERNEL_ROWS or group_size != GROUP_SIZE:
            raise ValueError(f"{kernel} takes at most {MAX_KERNEL_ROWS} rows and group "
                             f"{GROUP_SIZE}, got x {tuple(x2d.shape)}, group {group_size}")
    return cuda_operand(x2d), cuda_operand(packed), cuda_operand(scale)


def _row_tiles(rows: int) -> int:
    """16-row tiles of x K5 is built for (1, 2 or 4)."""
    return 1 if rows <= 16 else 2 if rows <= 32 else 4


def _split_plan(rows: int, d_out: int, pieces: int, chunk: int) -> Tuple[int, int]:
    """(stripe width, cluster size) of a split-K launch of the int4 kernels
    (``csrc/int4_split.cuh``): ``d_out / width`` stripes of output columns,
    each a cluster whose CTAs split ``pieces`` runs of packed rows evenly
    (none empty).  The widest stripe, then the smallest cluster, that gives
    at least ``K5_TARGET_CTAS`` CTAs with at most ``chunk`` pieces a CTA;
    failing that, the most CTAs.  The width times the row tiles stays <= 64
    (the accumulators a thread holds)."""
    tiles = _row_tiles(rows)
    plans = [(nc, cs) for nc in K5_WIDTHS if nc * tiles <= 64
             for cs in K5_CLUSTERS if cs <= pieces]

    def ctas(plan):
        return -(-d_out // plan[0]) * plan[1]

    good = [pl for pl in plans
            if ctas(pl) >= K5_TARGET_CTAS and -(-pieces // pl[1]) <= chunk]
    if good:
        return max(good, key=lambda pl: (pl[0], -pl[1]))
    return max(plans, key=lambda pl: (ctas(pl), pl[0], -pl[1]))


@functools.lru_cache(maxsize=None)
def k5_plan(rows: int, d_in: int, d_out: int) -> Tuple[int, int]:
    """(stripe width, cluster size) of K5's launch: the CTAs of a stripe
    split the in/32 units of 16 packed rows, at most ``K5_CHUNK_UNITS`` a
    CTA (``_split_plan``)."""
    return _split_plan(rows, d_out, d_in // (2 * K5_UNIT), K5_CHUNK_UNITS)


def k5_smem_bytes(rows: int, d_in: int, d_out: int) -> int:
    """Shared memory of one K5 CTA under ``k5_plan`` (stage_bytes, red_bytes
    and recv_bytes of csrc/int4_matmul.cu): the packed rows, scale rows and
    bf16 x columns of one chunk, or the 4 warps' float32 sums over them,
    whichever is larger; then the receive buffer of the cluster's sums."""
    nc, cs = k5_plan(rows, d_in, d_out)
    tiles = _row_tiles(rows)
    units = d_in // (2 * K5_UNIT)
    chunk = min(-(-units // cs), K5_CHUNK_UNITS)
    stride = nc if nc <= 16 else nc + 16
    stage = (chunk * K5_UNIT * stride + 2 * (chunk + 1) * nc * 2
             + 2 * 16 * tiles * (chunk * K5_UNIT + 8) * 2)
    return -(-max(stage, 4 * 16 * tiles * nc * 4) // 16) * 16 + 16 * tiles * nc * 4


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                group_size: int = GROUP_SIZE) -> torch.Tensor:
    """``x [..., in] @ dequantize_int4(packed, scale)`` -> [..., out] in
    x's dtype.  CUDA tensors with at most 64 rows run K5 (counted in
    ``int4_matmul.launches``), which rounds its float32 sums to x's dtype
    in its epilogue; CPU tensors the plain version."""
    d_in = x.shape[-1]
    half, d_out = packed.shape
    if d_in != 2 * half:
        raise ValueError(f"x {tuple(x.shape)} does not match packed {tuple(packed.shape)}")
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cpu or cuda tensors, got {x.device}")
    x2d = x.reshape(-1, d_in)
    rows = x2d.shape[0]
    if rows > MAX_KERNEL_ROWS:
        y = _prefill_matmul(x2d, packed, scale, group_size)
        return y.reshape(*x.shape[:-1], d_out).to(x.dtype)
    x2d, packed, scale = kernel_operands(x2d, packed, scale, group_size)
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    out = torch.empty((rows, d_out), dtype=x.dtype, device=x.device)
    if rows:
        nc, cs = k5_plan(rows, d_in, d_out)
        with torch.cuda.device(x.device):
            err = kernels().mcl_int4_matmul(
                x2d.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                d_in, d_out, group_size, _X_DTYPES[x2d.dtype], _X_DTYPES[out.dtype], nc, cs,
                torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "int4_matmul")
        int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], d_out)


int4_matmul.launches = 0


# K5's two A/B variants (scripts/bench_int4_kernel.py of the JAX package;
# the port's entry point is scripts/bench_int4_kernel.py of this package).
# Off every model path: only the A/B script calls them.  Their split-K takes
# whole groups: runs of 64-row blocks of the packed rows (group b in the low
# nibbles, b + in/128 in the high ones), at most V3_CHUNK_BLOCKS a CTA.
V3_BLOCK = GROUP_SIZE  # packed rows a block: one group of each nibble half
V3_CHUNK_BLOCKS = K5_CHUNK_UNITS * K5_UNIT // V3_BLOCK  # blocks a CTA stages at once


@functools.lru_cache(maxsize=None)
def v3_plan(rows: int, d_in: int, d_out: int) -> Tuple[int, int]:
    """(stripe width, cluster size) of K5v3a's and K5v3b's launch: the CTAs
    of a stripe split the in/128 blocks, whole groups each
    (``_split_plan``)."""
    return _split_plan(rows, d_out, d_in // (2 * V3_BLOCK), V3_CHUNK_BLOCKS)


def v3_smem_bytes(rows: int, d_in: int, d_out: int, variant: str) -> int:
    """Shared memory of one K5v3a (``variant`` "v3a") or K5v3b ("v3b") CTA
    under ``v3_plan`` (csrc/int4_matmul_v3.cu: ``stage_bytes`` /
    ``v3b_stage_bytes``, ``red_bytes``, ``recv_bytes``): the packed rows and
    scale rows of one chunk, then v3a's bf16 x columns, or v3b's raw x
    columns (float32-sized), xq and sx; or the 4 warps' float32 sums over
    them, whichever is larger; then the receive buffer of the cluster's sums."""
    nc, cs = v3_plan(rows, d_in, d_out)
    tiles = _row_tiles(rows)
    blocks = d_in // (2 * V3_BLOCK)
    units = min(-(-blocks // cs), V3_CHUNK_BLOCKS) * (V3_BLOCK // K5_UNIT)
    stride = nc if nc <= 16 else nc + 16
    k, xrows = units * K5_UNIT, 16 * tiles
    stage = units * K5_UNIT * stride + 2 * (units + 1) * nc * 2
    if variant == "v3a":
        stage += 2 * xrows * (k + 8) * 2
    else:
        stage += 2 * xrows * k * 4 + 2 * xrows * (k + 16) + 2 * (k // V3_BLOCK) * xrows * 4
    return -(-max(stage, 4 * xrows * nc * 4) // 16) * 16 + xrows * nc * 4


def s8_slot(p: int) -> int:
    """K5v3b's k-order (``s8_slot`` of csrc/int4_matmul_v3.cu): the slot of
    packed row ``p`` (0..31 of a 32-deep k-step) in the staged x tile, so
    that slot 4t + i of each 16-deep half holds row 2t + (i & 1) + 8 (i >> 1),
    the rows a byte permute of ldmatrix.trans gives lane t."""
    return (p & 16) + 4 * ((p & 7) >> 1) + (p & 1) + 2 * ((p >> 3) & 1)


def _group_view(t: torch.Tensor, group_size: int) -> torch.Tensor:
    """[rows, in] -> [rows, G, group_size]."""
    return t.reshape(t.shape[0], t.shape[1] // group_size, group_size)


def v3a_matmul_reference(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version of K5v3a (the JAX ``_kernel_v3a``): x rounded to bf16;
    per group of ``group_size`` input rows a float32-accumulated product
    of x's group with the UNSCALED codes ([G, rows, out]); then the sum
    over G of each group times its scale, in float32, cast to x's dtype."""
    x2d = x.reshape(-1, x.shape[-1])
    xg = _group_view(x2d.to(torch.bfloat16).float(), group_size)
    codes = unpack_int4(packed).float()
    wg = codes.reshape(xg.shape[1], group_size, codes.shape[1])
    acc = torch.einsum("rgk,gkn->grn", xg, wg)  # bf16 x code products are exact in float32
    out = (acc * scale.float()[:, None, :]).sum(dim=0)
    return out.reshape(*x.shape[:-1], codes.shape[1]).to(x.dtype)


def quantize_activations_int8(x2d: torch.Tensor, group_size: int = GROUP_SIZE
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5v3b's activation quantization (the JAX script's XLA code, outside
    its kernel): per (row, group) ``sx = max(max|x_g|, 1e-8) / 127`` and
    ``xq = clip(round(x_g / sx), -127, 127)`` (round half to even).
    Returns (xq int8 [rows, in], sx float32 [rows, G])."""
    xg = _group_view(x2d.float(), group_size)
    sx = xg.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xg / sx), -127, 127).to(torch.int8)
    return xq.reshape(x2d.shape), sx[..., 0]


def v3b_matmul_reference(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                         group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Plain version of K5v3b (the JAX ``_kernel_v3b``): x quantized to
    int8 per (row, group); per group the integer product of xq with the
    unscaled codes (exact: in float32 every partial sum is an integer below
    2**24); then ``sum_G float32(acc) * sx * scale``, cast to x's dtype."""
    x2d = x.reshape(-1, x.shape[-1])
    xq, sx = quantize_activations_int8(x2d, group_size)
    codes = unpack_int4(packed).float()
    wg = codes.reshape(sx.shape[1], group_size, codes.shape[1])
    acc = torch.einsum("rgk,gkn->grn", _group_view(xq.float(), group_size), wg)
    out = (acc * sx.t()[:, :, None] * scale.float()[:, None, :]).sum(dim=0)
    return out.reshape(*x.shape[:-1], codes.shape[1]).to(x.dtype)


def _v3_matmul(name: str, x: torch.Tensor, packed, scale, group_size: int):
    """Launch ``mcl_int4_matmul_<name>`` (v3a / v3b) on CUDA tensors: one
    clustered launch under ``v3_plan``; (the result in x's dtype, whether
    it launched)."""
    from multimodal_concept_learning_tpu_torch.ops._build import check, kernels

    x2d, packed, scale = kernel_operands(x.reshape(-1, x.shape[-1]), packed, scale, group_size,
                                         f"K5{name}")
    rows, d_in = x2d.shape
    d_out = packed.shape[1]
    out = torch.empty((rows, d_out), dtype=x.dtype, device=x.device)
    if rows:
        nc, cs = v3_plan(rows, d_in, d_out)
        with torch.cuda.device(x.device):
            err = getattr(kernels(), f"mcl_int4_matmul_{name}")(
                x2d.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d_in,
                d_out, group_size, _X_DTYPES[x2d.dtype], nc, cs,
                torch.cuda.current_stream(x.device).cuda_stream)
        check(err, f"K5{name}")
    return out.reshape(*x.shape[:-1], d_out), rows > 0


def v3a_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               group_size: int = GROUP_SIZE) -> torch.Tensor:
    """K5v3a: ``x [..., in]`` (at most 64 rows) against int4 weights with
    the group scales applied after each group's bf16 product -> [..., out]
    in x's dtype.  CUDA tensors launch ``csrc/int4_matmul_v3.cu`` (counted
    in ``v3a_matmul.launches``); CPU tensors run ``v3a_matmul_reference``."""
    if x.device.type == "cpu":
        return v3a_matmul_reference(x, packed, scale, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"v3a_matmul runs on cpu or cuda tensors, got {x.device}")
    out, launched = _v3_matmul("v3a", x, packed, scale, group_size)
    v3a_matmul.launches += launched
    return out


def v3b_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
               group_size: int = GROUP_SIZE) -> torch.Tensor:
    """K5v3b: x quantized to int8 per (row, group) inside the kernel (as
    ``quantize_activations_int8``, bitwise), then the int8 x int4 product
    with both scales applied after each group's integer product -> [...,
    out] in x's dtype.  Lossy in x: a different function from K5, behind
    the A/B entry point only.  CUDA tensors launch
    ``csrc/int4_matmul_v3.cu`` (counted in ``v3b_matmul.launches``); CPU
    tensors run ``v3b_matmul_reference``."""
    if x.device.type == "cpu":
        return v3b_matmul_reference(x, packed, scale, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"v3b_matmul runs on cpu or cuda tensors, got {x.device}")
    out, launched = _v3_matmul("v3b", x, packed, scale, group_size)
    v3b_matmul.launches += launched
    return out


v3a_matmul.launches = 0
v3b_matmul.launches = 0


def _features(features: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (features,) if isinstance(features, int) else tuple(features)


def _prod(dims) -> int:
    n = 1
    for s in dims:
        n *= s
    return n


def _contract(x: torch.Tensor, axis: Tuple[int, ...]) -> torch.Tensor:
    """Move the contraction axes last and flatten them (DenseGeneral)."""
    if axis == (-1,):
        return x
    axes = tuple(a % x.dim() for a in axis)
    keep = [a for a in range(x.dim()) if a not in axes]
    xt = x.permute(*keep, *axes)
    return xt.reshape(*(x.shape[a] for a in keep), -1)


class Int4Linear(nn.Module):
    """Int4 projection: buffers ``packed`` int8 [in/2, F] and ``scale`` bf16
    [in/g, F] (the JAX ``Int4Dense`` params), optional float ``bias``
    shaped like the features.  ``features`` as a tuple and ``axis`` give the
    JAX ``Int4DenseGeneral`` (contract ``axis``, output [..., *features])."""

    def __init__(self, in_features: int, features: Union[int, Sequence[int]],
                 bias: bool = False, axis: Sequence[int] = (-1,),
                 group_size: int = GROUP_SIZE):
        super().__init__()
        self.features = _features(features)
        self.axis = tuple(axis)
        self.group_size = group_size
        out = _prod(self.features)
        self.register_buffer("packed", torch.zeros((in_features // 2, out), dtype=torch.int8))
        self.register_buffer("scale", torch.zeros((in_features // group_size, out),
                                                  dtype=torch.bfloat16))
        self.bias = nn.Parameter(torch.zeros(self.features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_matmul(_contract(x, self.axis), self.packed, self.scale, self.group_size)
        y = y.reshape(*y.shape[:-1], *self.features)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def quantize_linear_int4(weight: torch.Tensor, group_size: int = GROUP_SIZE
                         ) -> Dict[str, torch.Tensor]:
    """An ``nn.Linear.weight`` [out, in] as {"packed", "scale"} in the JAX
    orientation (the quantizer sees its transpose)."""
    packed, scale = quantize_weight_int4(weight.t(), group_size)
    return {"packed": packed, "scale": scale}


# the LM's projections that int4 serving quantizes (JAX lm.py: attention and MLP)
LM_PROJECTIONS = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def quantize_state_dict(state_dict: Dict[str, torch.Tensor], prefixes: Sequence[str],
                        convert) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every ``<prefix>.weight`` (a float [out, in]
    projection) replaced by ``convert(weight)``'s entries under
    ``<prefix>.``; biases and every other entry pass through."""
    out = dict(state_dict)
    for prefix in prefixes:
        weight = out.pop(f"{prefix}.weight")
        for leaf, t in convert(weight).items():
            out[f"{prefix}.{leaf}"] = t
    return out


def lm_projection_prefixes(state_dict, root: str = "model.") -> list:
    """Names of the LM's quantizable projections in ``state_dict`` (keys
    under ``root``, e.g. "language_model.model." inside an MLLM)."""
    return sorted({k[: -len(".weight")] for k in state_dict
                   if k.startswith(root + "layers.") and k.endswith(".weight")
                   and k[: -len(".weight")].endswith(LM_PROJECTIONS)})


def quantize_lm_params_int4(state_dict: Dict[str, torch.Tensor], root: str = "model.",
                            group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """A float ``CausalLM`` state dict -> the ``int4_weights=True`` layout
    (the JAX ``quantize_lm_params_int4``): every attention and MLP
    projection quantized; embedding and norms stay float."""
    return quantize_params_int4(state_dict, lm_projection_prefixes(state_dict, root),
                                group_size)


def quantize_mllm_lm_params_int4(state_dict: Dict[str, torch.Tensor],
                                 group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """An MLLM state dict with its LM tower quantized to int4 (the vision
    tower, projector and any LoRA factors as they are; compose with int8
    vision).  Serving quantizes merged float weights (serve/loader.py)."""
    return quantize_lm_params_int4(state_dict, "language_model.model.", group_size)


def quantize_params_int4(state_dict: Dict[str, torch.Tensor], prefixes: Sequence[str],
                         group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """The JAX ``quantize_params_int4`` over a state dict: the named
    projections quantized, everything else passed through."""
    return quantize_state_dict(state_dict, prefixes,
                               lambda w: quantize_linear_int4(w, group_size))


__all__ = [
    "GROUP_SIZE",
    "Int4Linear",
    "dequantize_int4",
    "int4_matmul",
    "int4_matmul_reference",
    "k5_plan",
    "k5_smem_bytes",
    "s8_slot",
    "quantize_linear_int4",
    "quantize_lm_params_int4",
    "quantize_mllm_lm_params_int4",
    "quantize_params_int4",
    "quantize_activations_int8",
    "quantize_weight_int4",
    "kernel_operands",
    "unpack_int4",
    "v3_plan",
    "v3_smem_bytes",
    "v3a_matmul",
    "v3a_matmul_reference",
    "v3b_matmul",
    "v3b_matmul_reference",
]
