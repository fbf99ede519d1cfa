"""PyTorch port: ``data/pipeline.prefetch_to_device`` against JAX's and
``to_device`` (CPU).

- On the CPU every yielded batch is ``to_device``'s, bitwise, with the same
  keys and dtypes (``kv_lens`` decided on the host for a right-padded mask,
  none for another mask).
- The pull order is JAX's: a counting iterator has been pulled as many
  times at each yield as under JAX ``prefetch_to_device``, at every
  ``size`` and length (exhaustion included).
- Closing the generator after 3 batches (a ``break``) closes the loader's
  generator and ends its producer thread.
- The three trainer CLIs read every batch through it: a mid-epoch
  preemption closes the generators it opened, and the resumed run (the
  resume tests' fixture) copies only the batches past the skipped ones and
  ends bitwise where the uninterrupted run ends.
The CUDA path (pinned buffers, a side stream) runs on the card only:
``chip_smoke.py`` phase 42.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from test_torch_resume import (  # noqa: F401 - ``data`` is the resume tests' fixture
    _assert_bitwise,
    _guard_after,
    _main,
    _run,
    _state,
    _yaml,
    data,
)


def _batches(n: int, seed: int = 0) -> list:
    """n collated-looking numpy batches: float images, int32 ids, a
    right-padded mask (every other batch a mask with a hole), bool valid,
    uint8 images with their normalisation constants."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.zeros((3, 7), np.int32)
        for r, length in enumerate((7, 4, 5)):
            mask[r, :length] = 1
        if i % 2:
            mask[1, 0] = 0  # not right-padded: no kv_lens
        out.append({"images": rng.standard_normal((3, 3, 8, 8)).astype(np.float32),
                    "input_ids": rng.integers(0, 50, (3, 7)).astype(np.int32),
                    "attention_mask": mask, "valid": np.array([True, True, False]),
                    "images_u8": rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8),
                    "norm_mean": (0.5, 0.5, 0.5), "norm_std": (0.25, 0.25, 0.25)})
    return out


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].device == t.device, k
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_cpu_batches_are_to_devices(size, n):
    from multimodal_concept_learning_tpu_torch.data.pipeline import prefetch_to_device, to_device

    batches = _batches(n)
    got = list(prefetch_to_device(iter(batches), "cpu", size=size))
    assert len(got) == n
    for g, b in zip(got, batches):
        _same(g, to_device(b, "cpu"))
    if n:
        assert got[0]["kv_lens"].tolist() == [7, 4, 5]
    if n > 1:
        assert "kv_lens" not in got[1]  # its mask has a hole


class _Counting:
    """An iterator over ``n`` batches that counts its ``next`` calls
    (those after exhaustion too)."""

    def __init__(self, n: int):
        self.batches, self.pulls = _batches(n), 0

    def __iter__(self):
        return self

    def __next__(self):
        self.pulls += 1
        if self.pulls > len(self.batches):
            raise StopIteration
        return self.batches[self.pulls - 1]


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 6])
def test_pull_order_matches_jax(size, n):
    from multimodal_concept_learning_tpu.data.pipeline import (
        prefetch_to_device as jax_prefetch,
    )

    from multimodal_concept_learning_tpu_torch.data.pipeline import prefetch_to_device

    def pulls_at_each_yield(fn, **kw):
        it = _Counting(n)
        seen = []
        for _ in fn(it, size=size, **kw):
            seen.append(it.pulls)
        return seen, it.pulls

    want = pulls_at_each_yield(jax_prefetch, sharding=jax.devices("cpu")[0])
    assert pulls_at_each_yield(prefetch_to_device, device="cpu") == want
    assert len(want[0]) == n


class _Squares:
    """A map-style dataset of (image, label) pairs."""

    def __len__(self):
        return 40

    def __getitem__(self, i):
        return np.full((3, 4, 4), i, np.float32), i % 3


def test_closing_stops_the_loader_thread():
    from multimodal_concept_learning_tpu_torch.data.pipeline import (
        BatchLoader,
        prefetch_to_device,
        to_device,
    )

    loader = BatchLoader(_Squares(), batch_size=4, shuffle=True, num_workers=2, seed=1)
    want = [to_device(b, "cpu") for b in loader]
    before = set(threading.enumerate())
    got = []
    for batch in prefetch_to_device(loader, "cpu"):
        got.append(batch)
        if len(got) == 3:
            break  # CPython finalizes the dropped generator here
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in started)
    for g, w in zip(got, want):
        _same(g, w)

    gen = prefetch_to_device(loader, "cpu")
    next(gen)
    inner = [t for t in threading.enumerate() if t not in before]
    assert inner, "the loader's producer thread was not started"
    gen.close()
    for t in inner:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in inner)


@pytest.mark.parametrize("trainer", ["vision", "mllm", "clip"])
def test_resumed_cli_reads_through_prefetch(trainer, data, tmp_path, monkeypatch):
    """Each CLI's batches go through ``prefetch_to_device`` (a spy counts
    the batches each call pulls and yields): the preempted run closes every
    generator it opened, the resumed epoch copies only its last batch, and
    the result is bitwise the uninterrupted run's."""
    module = _main(trainer)
    real = module.prefetch_to_device
    calls = []

    def spy(iterator, device, size=2):
        rec = {"pulled": 0, "yielded": 0, "closed": False}
        calls.append(rec)

        def counted():
            try:
                for batch in iterator:
                    rec["pulled"] += 1
                    yield batch
            finally:
                rec["closed"] = True

        for batch in real(counted(), device, size):
            rec["yielded"] += 1
            yield batch

    monkeypatch.setattr(module, "prefetch_to_device", spy)
    ref, _ = _run(trainer, _yaml(tmp_path / "a.yaml", trainer, data, tmp_path / "a", epochs=2))
    assert calls and all(c["closed"] and c["pulled"] == c["yielded"] for c in calls)
    train = [c["yielded"] for c in calls if c["yielded"] == 4]
    assert len(train) >= 2  # 4 micro-steps an epoch, two epochs

    path = _yaml(tmp_path / "b.yaml", trainer, data, tmp_path / "b", epochs=2)
    calls.clear()
    with monkeypatch.context() as m:
        m.setattr(module, "PreemptionGuard", _guard_after(4 + 3))  # epoch 2, micro-step 3
        out, _ = _run(trainer, path)
    assert out == {"preempted": True}
    assert all(c["closed"] for c in calls)
    assert calls[-1]["yielded"] == 3 and calls[-1]["pulled"] == 4  # 2 ahead, 4 in the epoch

    calls.clear()
    out, text = _run(trainer, path)
    assert "(mid-epoch: skipping 3 batches)" in text
    assert calls[0]["yielded"] == 1 and calls[0]["pulled"] == 1  # the skipped 3 never copied
    _assert_bitwise(_state(trainer, out), _state(trainer, ref))
