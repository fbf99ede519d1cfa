"""PyTorch port: how K3 and K4 split a row over a thread block cluster (CPU).

On the card each (row, kv head) is split over ``paged_split_plan`` CTAs,
each taking one run of the row's attended tokens (``paged_split_runs``, the
Python mirror of ``csrc/paged_split.cuh``), and their float32 partials
merge in rank order.  These tests hold the plan (a cluster size the
kernels take, from shapes alone), the runs (every attended token in exactly
one run, for K3's chunks and K4's segments) and the merge
(``paged_decode_split_reference``, the algorithm in plain PyTorch, against
the JAX Pallas paged kernel in interpret mode; float32 single op on
unit-scale inputs, <= 1e-5 abs; a row of length 0 exactly 0).
"""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu.ops import paged_kv as jpkv
from multimodal_concept_learning_tpu_torch.ops import paged_attention_kernel as pk
from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as mp

ATOL = 1e-5
LENS = (0, 1, 37, 300)  # empty, shorter than any run, mid-page, ten 32-token chunks


@functools.lru_cache(maxsize=None)
def _case(seed=0):
    rng = np.random.default_rng(seed)
    b, np_, ps, hk, d, g = len(LENS), 40, 8, 2, 64, 4
    p = 1 + b * np_
    pk_ = rng.standard_normal((p, hk, ps, d)).astype(np.float32)
    pv = rng.standard_normal((p, hk, ps, d)).astype(np.float32)
    pt = (rng.permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    q = rng.standard_normal((b, 1, hk * g, d)).astype(np.float32)
    return q, pk_, pv, pt, np.asarray(LENS, np.int32)


@functools.lru_cache(maxsize=None)
def _pallas(window):
    arrays = _case()
    out = jpkv.paged_decode_attention(*(jnp.asarray(a) for a in arrays),
                                      window=jnp.int32(window), use_kernel=True, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("window", [-1, 5, 20])
@pytest.mark.parametrize("splits", [1, 2, 8, 16])
def test_split_merge_matches_pallas_interpret(splits, window):
    """Partials of ``splits`` runs merged in rank order == the JAX kernel's
    one online softmax over the row; the length-0 row is exactly 0."""
    arrays = [torch.from_numpy(a) for a in _case()]
    d = arrays[0].shape[-1]
    out = pk.paged_decode_split_reference(*arrays, scale=d ** -0.5, window=window,
                                          splits=splits)
    np.testing.assert_allclose(out.numpy(), _pallas(window), atol=ATOL, rtol=0)
    assert (out[0] == 0).all() and torch.isfinite(out).all()


def test_split_merge_is_the_plain_version_at_every_split():
    """The split changes only the float32 summation order."""
    arrays = [torch.from_numpy(a) for a in _case(seed=1)]
    want = pk.paged_decode_attention_reference(*arrays, scale=0.125, window=50)
    for splits in (1, 3, 5, 16):
        got = pk.paged_decode_split_reference(*arrays, scale=0.125, window=50, splits=splits)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# (batch, kv heads, page size, table columns): serving (8 rows of ~265
# tokens, 17 pages of 16), the ragged gemma3 decode case, the ~1k-context
# K3-against-K4 case at pages of 16 and 64, a one-row call
SHAPES = [(8, 1, 16, 17), (8, 1, 16, 40), (8, 4, 16, 64), (8, 4, 64, 16), (1, 1, 16, 40)]


@pytest.mark.parametrize("window", [-1, 512, 20])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_gives_a_cluster_the_kernels_take(shape, window):
    b, hk, ps, np_ = shape
    splits = pk.split_for(b, hk, ps, np_, window)
    assert 1 <= splits <= pk.MAX_SPLIT
    max_tokens = min(np_ * ps, window) if window >= 0 else np_ * ps
    assert splits == pk.paged_split_plan(b, hk, max_tokens)
    # never more CTAs than chunks a row can have, nor more than fill the card twice
    assert splits <= -(-max_tokens // pk.SPLIT_UNIT)
    assert b * hk * splits < 2 * pk.NUM_SMS or splits == 1


def test_plan_at_the_main_paths_shapes():
    """gemma3-1b at batch 8 (one kv head): 16 CTAs a row at window 512,
    9 on the serving path's 17 pages of 16 (a run of one chunk each)."""
    assert pk.split_for(8, 1, 16, 40, 512) == 16
    assert pk.split_for(8, 1, 16, 17, 512) == pk.split_for(8, 1, 16, 17, -1) == 9


def test_plan_and_host_side_read_no_lens_value():
    """The plan takes shapes only, and the wrapper's host-side work (operand
    checks and copies, the plan) runs on meta tensors, which hold no values:
    nothing reads lens, so nothing syncs and a CUDA graph can capture it."""
    assert list(inspect.signature(pk.paged_split_plan).parameters) == [
        "batch", "kv_heads", "max_tokens"]
    meta = dict(device="meta")
    q = torch.empty(8, 1, 4, 256, **meta)
    pool = torch.empty(321, 1, 16, 256, **meta)
    pt = torch.empty(8, 40, dtype=torch.int32, **meta)
    lens = torch.empty(8, dtype=torch.int32, **meta)
    q2, pt2, lens2 = pk.kernel_operands(q, pool, pool, pt, lens)
    assert lens2.device.type == "meta" and pk.split_for(8, 1, 16, 40, 512) >= 1


def _covered(lens, window, limit, splits, unit, aligned):
    lo, hi = pk.paged_split_runs(torch.tensor(lens), splits=splits, window=window, limit=limit,
                                 unit=unit, aligned=aligned)
    counts = torch.zeros(len(lens), limit + 1, dtype=torch.int64)
    for r in range(splits):
        for b in range(len(lens)):
            counts[b, lo[r, b]:hi[r, b]] += 1
    return lo, hi, counts


@pytest.mark.parametrize("aligned,unit", [(False, pk.SPLIT_UNIT), (True, 16), (True, 64),
                                          (True, 8)], ids=["k3", "k4-16", "k4-64", "k4-8"])
@pytest.mark.parametrize("window", [-1, 512, 20, 5])
@pytest.mark.parametrize("splits", [1, 4, 9, 16])
def test_runs_cover_each_attended_token_once(splits, window, aligned, unit):
    """Every attended token of every row lies in exactly one rank's run,
    nothing else does; runs are whole units (K3: from the range's start;
    K4: at multiples of the unit); rows of length 0, rows shorter than S
    chunks, windows that start mid-page and rows past the table included."""
    limit = 640
    lens = [0, 1, 15, 16, 17, 261, 530, 640, 700, 33]
    lo, hi, counts = _covered(lens, window, limit, splits, unit, aligned)
    want = torch.from_numpy(np.array(
        jpkv.paged_attention_mask(jnp.asarray(lens, jnp.int32), limit + 1, jnp.int32(window))))
    want[:, limit:] = False  # the table's columns bound the row
    assert torch.equal(counts, want.long())
    for b in range(len(lens)):
        runs = [(int(lo[r, b]), int(hi[r, b])) for r in range(splits)]
        live = [(a, z) for a, z in runs if z > a]
        assert [a for a, _ in live] == sorted(a for a, _ in live)  # in rank order
        start = max(0, lens[b] - window) if window >= 0 else 0
        for a, z in live[:-1]:
            if aligned:
                assert z % unit == 0
            else:
                assert (z - a) % unit == 0 and (a - start) % unit == 0


def test_k4_split_keeps_its_blocks():
    """K4's plain version (the TPU kernel's blocks) is unchanged by the
    split, which lives on the card only: the same result as K3's plain
    version and the split reference."""
    arrays = [torch.from_numpy(a) for a in _case(seed=2)]
    k4 = mp.paged_decode_attention_mp(*arrays, window=20, pages_per_block=3)
    split = pk.paged_decode_split_reference(*arrays, scale=64 ** -0.5, window=20, splits=9)
    torch.testing.assert_close(k4, split, atol=ATOL, rtol=0)
