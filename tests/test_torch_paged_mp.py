"""PyTorch port: K4, the multi-page paged decode, vs the JAX package (CPU).

The plain version (the TPU kernel's blocks of ``pages_per_block`` pages
and float32 online softmax) is held to the JAX Pallas kernel
``paged_decode_attention_mp_kernel`` in interpret mode over the grid of
the JAX package's own test: GQA 1/4, window -1/5, pages_per_block 1/3/8
(3 pads the 4-page table), ragged rows including length 0 (zeros).
Tolerance: float32 single op on unit-scale inputs, <= 1e-5 abs.  Also:
the dispatch rules of ``ops/paged_kv.paged_decode_attention`` and the
card's schedule (``mp_schedule``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu.ops.paged_attention_mp_kernel import (
    paged_decode_attention_mp_kernel,
)
from multimodal_concept_learning_tpu_torch.ops import paged_attention_mp_kernel as tmp
from multimodal_concept_learning_tpu_torch.ops import paged_kv as tpkv

ATOL = 1e-5


def _case(gqa_group, seed=0, lens=(0, 1, 13, 32)):
    rng = np.random.default_rng(seed)
    b, np_, ps, hk, d = len(lens), 4, 8, 2, 64
    p = 1 + b * np_
    pk = rng.standard_normal((p, hk, ps, d)).astype(np.float32)
    pv = rng.standard_normal((p, hk, ps, d)).astype(np.float32)
    pt = (rng.permutation(b * np_) + 1).reshape(b, np_).astype(np.int32)
    q = rng.standard_normal((b, 1, hk * gqa_group, d)).astype(np.float32)
    return q, pk, pv, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("gqa_group", [1, 4])
@pytest.mark.parametrize("window", [-1, 5])
@pytest.mark.parametrize("ppb", [1, 3, 8])
def test_plain_k4_matches_pallas_interpret(gqa_group, window, ppb):
    arrays = _case(gqa_group)
    d = arrays[0].shape[-1]
    ref = paged_decode_attention_mp_kernel(*(jnp.asarray(a) for a in arrays), jnp.int32(window),
                                           scale=d ** -0.5, pages_per_block=ppb, interpret=True)
    out = tmp.paged_decode_attention_mp(*(torch.from_numpy(a) for a in arrays), window=window,
                                        pages_per_block=ppb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert (out[0] == 0).all()  # the length-0 row


def test_blocking_changes_only_the_summation_order():
    """The card clamps pages_per_block; every blocking gives the same result."""
    arrays = [torch.from_numpy(a) for a in _case(4, seed=1, lens=(3, 29, 32))]
    outs = [tmp.paged_decode_attention_mp(*arrays, window=-1, pages_per_block=n)
            for n in (1, 2, 3, 4, 8)]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("env,use_kernel,expect", [
    (None, None, "k3"), ("1", None, "k3"), ("2", None, "mp"), ("0", None, "gather"),
    ("2", True, "k3"), (None, "2", "mp"), (None, "mp", "mp"), ("2", False, "gather"),
])
def test_dispatch(monkeypatch, env, use_kernel, expect):
    """MCL_PAGED_KERNEL is read at each call; an explicit use_kernel wins."""
    calls = []
    monkeypatch.setattr(tpkv, "paged_decode_attention_k3", lambda *a, **k: calls.append("k3"))
    monkeypatch.setattr(tpkv, "paged_decode_attention_mp", lambda *a, **k: calls.append("mp"))
    monkeypatch.setattr(tpkv, "paged_decode_attention_reference",
                        lambda *a, **k: calls.append("gather"))
    if env is None:
        monkeypatch.delenv("MCL_PAGED_KERNEL", raising=False)
    else:
        monkeypatch.setenv("MCL_PAGED_KERNEL", env)
    arrays = [torch.from_numpy(a) for a in _case(1)]
    tpkv.paged_decode_attention(*arrays, use_kernel=use_kernel)
    assert calls == [expect]


def test_cpu_tensors_take_each_kernels_plain_version(monkeypatch):
    arrays = [torch.from_numpy(a) for a in _case(4, seed=2)]
    monkeypatch.setenv("MCL_PAGED_KERNEL", "2")
    mp_out = tpkv.paged_decode_attention(*arrays, window=5)
    monkeypatch.delenv("MCL_PAGED_KERNEL")
    k3_out = tpkv.paged_decode_attention(*arrays, window=5)
    before = (tmp.paged_decode_attention_mp.launches, tpkv.paged_decode_attention_k3.launches)
    torch.testing.assert_close(mp_out, k3_out, atol=ATOL, rtol=0)
    assert before == (tmp.paged_decode_attention_mp.launches,
                      tpkv.paged_decode_attention_k3.launches)  # plain versions launch nothing


def test_gather_path_and_bad_requests_raise_off_the_cpu():
    """The port runs no gather read on the card: use_kernel=False on a
    tensor off the CPU raises (a meta tensor stands in for a CUDA one), as
    does an unknown use_kernel."""
    meta = [torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, device="meta")
            for a in _case(1)]
    with pytest.raises(ValueError, match="CPU tensors only"):
        tpkv.paged_decode_attention(*meta, use_kernel=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tmp.paged_decode_attention_mp(*meta)
    arrays = [torch.from_numpy(a) for a in _case(1)]
    with pytest.raises(ValueError, match="use_kernel"):
        tpkv.paged_decode_attention(*arrays, use_kernel="3")


@pytest.mark.parametrize("ps,dtype,group,ppb,expect", [
    (16, torch.bfloat16, 4, 8, (16, 6)),   # gemma3-1b: 8 pages clamped to 6
    (16, torch.float32, 4, 8, (16, 3)),
    (64, torch.bfloat16, 4, 8, (64, 1)),
    (64, torch.float32, 4, 8, (32, 1)),    # one page does not fit twice: half-page ranges
    (8, torch.float32, 2, 8, (8, 3)),      # never more pages than the table has
    (16, torch.bfloat16, 1, 2, (16, 2)),
])
def test_card_schedule_clamps_to_shared_memory(ps, dtype, group, ppb, expect):
    d = 256 if ps != 8 else 64
    np_ = 3 if ps == 8 else 40
    assert tmp.mp_schedule(ps, d, dtype, group, ppb, np_) == expect
