"""PyTorch port: the multi-tensor AdamW wrappers (``ops/multi_tensor_adamw.py``).

The kernels run on the card only (``chip_smoke.py --adamw`` holds them to
the plain versions there).  Here: the wrappers' dispatch (CPU tensors take
the plain per-tensor path, bitwise the optimizer's per-tensor loop as it
was written before the kernels, and launch nothing), the dtypes the kernels
refuse, and the host-side packing of the kernels' pointer table on fake
pointer lists (empty tensors dropped, null gradients and masters, the
split into launches).
"""

import math

import numpy as np
import pytest
import torch

from multimodal_concept_learning_tpu_torch.ops import _build
from multimodal_concept_learning_tpu_torch.ops import multi_tensor_adamw as mta
from multimodal_concept_learning_tpu_torch.parallel.optimizer import Optimizer

KERNELS = ("multi_tensor_accumulate", "multi_tensor_sq_norm", "multi_tensor_adamw")
SHAPES = [(7, 5), (0,), (13,), (3, 4, 5), (1,)]


class PerTensorAdamW:
    """The optimizer's step as a loop of PyTorch ops a tensor (optax's
    MultiSteps(clip -> AdamW)), as the port ran it before the kernels."""

    def __init__(self, params, lr, wd, max_norm, k, master):
        self.params, self.lr, self.wd, self.max_norm, self.k = params, lr, wd, max_norm, k
        self.master = {n: p.detach().float().clone() for n, p in params.items()} if master else None
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()} if k > 1 else None
        self.mini_step = self.count = 0

    @torch.no_grad()
    def step(self):
        grads = {}
        for n, p in self.params.items():
            grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        if self.k > 1:
            for n, g in grads.items():
                acc = self.acc[n]
                acc.copy_(acc + (g - acc) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return
            self.mini_step = 0
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
        grads = {n: g.float() for n, g in grads.items()}
        if self.max_norm:
            sq = None
            for g in grads.values():
                s = torch.sum(g * g)
                sq = s if sq is None else sq + s
            norm = torch.sqrt(sq)
            keep = norm < self.max_norm
            grads = {n: torch.where(keep, g, (g / norm) * self.max_norm) for n, g in grads.items()}
        self.count += 1
        bc1 = float(1 - torch.tensor(0.9, dtype=torch.float32) ** self.count)
        bc2 = float(1 - torch.tensor(0.999, dtype=torch.float32) ** self.count)
        step_size = -self.lr(self.count - 1)
        for n, g in grads.items():
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1 - 0.9) * g + 0.9 * mu)
            nu.copy_((1 - 0.999) * (g * g) + 0.999 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
            target = self.master[n] if self.master is not None else self.params[n]
            upd = (upd + self.wd * target.float()) * step_size
            target.add_(upd)
            if self.master is not None:
                self.params[n].copy_(target.to(self.params[n].dtype))


def _params(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {f"p{i}": torch.nn.Parameter(torch.randn(s, generator=gen).to(dtype))
            for i, s in enumerate(SHAPES)}


def _run(make, dtype, k, max_norm, master, micro_steps):
    params = _params(dtype)
    opt = make(params, lambda c: 1e-2 * (c + 1), 0.1, max_norm, k, master)
    gen = torch.Generator().manual_seed(1)
    for i in range(micro_steps):
        for j, p in enumerate(params.values()):
            # the third tensor has no gradient on even micro-steps
            p.grad = None if j == 2 and i % 2 == 0 else (
                torch.randn(p.shape, generator=gen) * 3).to(dtype)
        opt.step()
    return params, opt


@pytest.mark.parametrize("max_norm", [None, 1e-3, 1e3], ids=["no-clip", "clipped", "unclipped"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype,master", [(torch.float32, False), (torch.bfloat16, True),
                                          (torch.bfloat16, False)],
                         ids=["float32", "bf16-master", "bf16"])
def test_cpu_tensors_take_the_plain_path(monkeypatch, dtype, master, k, max_norm):
    """On the CPU the optimizer runs the plain versions, bitwise the
    per-tensor loop (parameters, masters, moments, accumulators; a run
    stopped mid-accumulation), and neither builds nor launches a kernel."""

    def no_kernels():
        raise AssertionError("a CPU step reached the CUDA kernels")

    monkeypatch.setattr(_build, "kernels", no_kernels)
    before = {n: getattr(mta, n).launches for n in KERNELS}
    steps = 3 * k + (2 if k > 1 else 0)
    got_p, got = _run(lambda p, lr, wd, c, k_, m: Optimizer(p, lr, wd, c, k_, fp32_master=m),
                      dtype, k, max_norm, master, steps)
    want_p, want = _run(PerTensorAdamW, dtype, k, max_norm, master, steps)
    assert got.count == want.count == 3 and got.mini_step == want.mini_step
    for name in want_p:
        assert torch.equal(got_p[name], want_p[name]), name
        assert torch.equal(got.mu[name], want.mu[name]), name
        assert torch.equal(got.nu[name], want.nu[name]), name
        if master:
            assert torch.equal(got.master[name], want.master[name]), name
        if k > 1:
            assert torch.equal(got.acc[name], want.acc[name]), name
            assert got.acc[name].abs().sum() > 0 or got_p[name].numel() == 0
    assert {n: getattr(mta, n).launches for n in KERNELS} == before


@pytest.mark.parametrize("key", ["mu", "nu", "master", "acc"])
def test_the_tables_tensors_cannot_be_rebound(key, tmp_path):
    """The kernels' table points at the optimizer's own tensors, packed
    once: their mappings refuse a new tensor, ``state_dict`` hands out plain
    dicts of the same tensors (saved and loaded as weights), and
    ``load_state_dict`` copies into them in place."""
    params = _params(torch.bfloat16)
    opt = Optimizer(params, 1e-2, 0.1, 1.0, 2, fp32_master=True)
    mine = getattr(opt, key)
    held = dict(mine)
    with pytest.raises(TypeError):
        mine["p0"] = torch.zeros_like(mine["p0"])
    with pytest.raises(TypeError):
        del mine["p0"]
    state = opt.state_dict()
    assert type(state[key]) is dict and all(state[key][n] is t for n, t in held.items())
    torch.save(state, tmp_path / "opt.pt")
    saved = torch.load(tmp_path / "opt.pt", weights_only=True)
    saved[key] = {n: t + 1 for n, t in saved[key].items()}
    opt.load_state_dict(saved)
    assert all(mine[n] is t and torch.equal(t, saved[key][n]) for n, t in held.items())


def test_tensors_of_another_device_are_refused():
    meta = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="one cpu or cuda device"):
        mta.Tensors([meta], None, [meta], [meta], None)
    assert not mta.Tensors([torch.zeros(3)], None, [torch.zeros(3)], [torch.zeros(3)],
                           None).on_cuda


def _fake(n, dtype=torch.float32, empty=(), master=False, acc=False):
    """pack()'s arguments for n fake tensors: pointers are multiples of 256
    (param i at 1000 + i, mu 2000 + i, nu 3000 + i, master 4000 + i, acc
    5000 + i, all times 256); the indices in ``empty`` have no elements."""
    ptr = lambda base: [(base + i) * 256 for i in range(n)]  # noqa: E731
    return (ptr(1000), ptr(4000) if master else [0] * n, ptr(2000), ptr(3000),
            ptr(5000) if acc else [0] * n, [0 if i in empty else 10 + i for i in range(n)],
            [dtype] * n)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_dtypes_the_kernels_do_not_take_raise(dtype):
    """Only float32 and bfloat16 parameters reach the kernels; any other
    dtype raises while the table is packed (before any launch)."""
    args = list(_fake(3))
    args[-1] = [torch.float32, dtype, torch.bfloat16]
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        mta.pack(*args)


def test_pack_rows_and_dropped_empty_tensors():
    rows, kept = mta.pack(*_fake(6, torch.bfloat16, empty={1, 4}, master=True, acc=True))
    assert kept == [0, 2, 3, 5]
    assert rows.dtype == np.int64 and rows.shape == (4, len(mta.COLUMNS))
    col = {c: rows[:, i].tolist() for i, c in enumerate(mta.COLUMNS)}
    assert col["grad"] == [0] * 4  # until set_column
    assert col["param"] == [(1000 + i) * 256 for i in kept]
    assert col["master"] == [(4000 + i) * 256 for i in kept]
    assert col["mu"] == [(2000 + i) * 256 for i in kept]
    assert col["nu"] == [(3000 + i) * 256 for i in kept]
    assert col["acc"] == [(5000 + i) * 256 for i in kept]
    assert col["numel"] == [10 + i for i in kept]
    assert col["dtype"] == [mta.DTYPE_CODES[torch.bfloat16]] * 4
    # no masters and no accumulators: null pointers
    rows, _ = mta.pack(*_fake(3))
    assert rows[:, mta.COLUMNS.index("master")].tolist() == [0, 0, 0]
    assert rows[:, mta.COLUMNS.index("acc")].tolist() == [0, 0, 0]
    assert rows[:, mta.COLUMNS.index("dtype")].tolist() == [0, 0, 0]
    # every tensor empty, or none at all: no rows, no launch
    for args in (_fake(3, empty={0, 1, 2}), _fake(0)):
        rows, kept = mta.pack(*args)
        assert rows.shape == (0, len(mta.COLUMNS)) and kept == []
        assert mta.chunks(rows) == []


class _FakeTensor:
    def __init__(self, ptr, dtype=torch.float32, contiguous=True):
        self.ptr, self.dtype, self.contiguous = ptr, dtype, contiguous

    def data_ptr(self):
        return self.ptr

    def is_contiguous(self):
        return self.contiguous


def test_null_gradients_and_columns_set_through_chunks():
    """Gradient pointers go into the table in the kept order, 0 for a
    missing gradient, and every chunk (a view) sees them."""
    n = 2 * mta.MAX_TENSORS + 7
    args = _fake(n, empty={5})
    rows, kept = mta.pack(*args)
    parts = mta.chunks(rows)
    grads = [None if i % 3 == 0 else _FakeTensor(9_000_000 + i) for i in range(n)]
    mta.set_column(rows, kept, mta.GRAD, grads, args[-1])
    want = [0 if i % 3 == 0 else 9_000_000 + i for i in kept]
    assert rows[:, mta.GRAD].tolist() == want
    assert np.concatenate(parts)[:, mta.GRAD].tolist() == want
    assert all(np.shares_memory(p, rows) and p.flags.c_contiguous for p in parts)


@pytest.mark.parametrize("bad", [_FakeTensor(256, torch.bfloat16),
                                 _FakeTensor(256, contiguous=False)],
                         ids=["dtype", "strided"])
def test_a_gradient_the_kernels_cannot_read_raises(bad):
    """A gradient of another dtype than its parameter's, or a strided one,
    is refused before its pointer reaches the table."""
    args = _fake(3)
    rows, kept = mta.pack(*args)
    with pytest.raises(ValueError, match="contiguous"):
        mta.set_column(rows, kept, mta.GRAD, [None, bad, None], args[-1])
    assert rows[:, mta.GRAD].tolist() == [0, 0, 0]


@pytest.mark.parametrize("n", [1, 200, 397, mta.MAX_TENSORS, mta.MAX_TENSORS + 1, 1100, 2048])
def test_chunks_split_at_the_launch_limit(n):
    """At most MAX_TENSORS rows a launch, in order, every row once; both
    train cells' tensor lists (397 and 200) fit one launch, and no list of
    up to 2048 tensors needs more than 4."""
    rows, _ = mta.pack(*_fake(n))
    parts = mta.chunks(rows)
    assert len(parts) == math.ceil(n / mta.MAX_TENSORS) <= 4
    assert all(1 <= len(p) <= mta.MAX_TENSORS for p in parts)
    assert np.array_equal(np.concatenate(parts), rows)
    if n in (200, 397):
        assert len(parts) == 1
