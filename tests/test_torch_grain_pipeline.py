"""PyTorch port: ``data/grain_pipeline.GrainLoader`` vs the JAX package's
(CPU).  Unshuffled batches equal the JAX loader's bitwise (each package's
ColorDataset over the same generated images); shuffled epochs are
permutations of the dataset, reproducible for a seed and epoch and
different between epochs (Grain's own shuffle order is not reproduced);
the padded final batch, ``valid``, ``drop_last`` and ``__len__`` as JAX's;
worker processes give the batches of the in-process loader.
"""

import os

import numpy as np
import pytest

COLORS = [[255, 0, 0], [0, 255, 0], [0, 0, 255]]


def _config(root, cls):
    return cls.from_params({"dataset_name": "g", "image_size": 16, "colors": COLORS,
                            "radius_range": [3, 6], "n_images_per_color": 9,
                            "data_dir": str(root), "seed": 0})


class _Cfg:
    train_transforms = val_transforms = ["ToTensor"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX ColorDataset, port ColorDataset) over the same generated train split."""
    from multimodal_concept_learning_tpu.configs import ColorDatasetConfig
    from multimodal_concept_learning_tpu.data import ColorDataset as JDataset
    from multimodal_concept_learning_tpu.data import create_transforms as jtransforms
    from multimodal_concept_learning_tpu.data import generate_color_dataset as jgen
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig as PortConfig,
    )
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        generate_color_dataset as tgen,
    )
    from multimodal_concept_learning_tpu_torch.data.datasets import ColorDataset
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    root = tmp_path_factory.mktemp("grain")
    jdir = jgen(_config(root / "jax", ColorDatasetConfig), verbose=False)
    tdir = tgen(_config(root / "port", PortConfig), verbose=False)
    jds = JDataset(os.path.join(jdir, "train_mapping.csv"), jdir, jtransforms(_Cfg, False),
                   verbose=False)
    jds._native_spec = None  # the Pillow decode, as the port's PNG reader matches
    tds = ColorDataset(os.path.join(tdir, "train_mapping.csv"), tdir,
                       create_transforms(_Cfg, False), verbose=False)
    return jds, tds


@pytest.mark.parametrize("drop_last", [False, True])
def test_unshuffled_batches_match_jax(datasets, drop_last):
    from multimodal_concept_learning_tpu.data.grain_pipeline import GrainLoader as JLoader
    from multimodal_concept_learning_tpu_torch.data.grain_pipeline import GrainLoader

    jds, tds = datasets
    ref = list(JLoader(jds, batch_size=4, drop_last=drop_last))
    loader = GrainLoader(tds, batch_size=4, drop_last=drop_last)
    out = list(loader)
    assert len(out) == len(ref) == len(loader) == len(JLoader(jds, 4, drop_last=drop_last))
    assert len(tds) % 4 != 0  # a padded final batch exists without drop_last
    for rb, ob in zip(ref, out):
        assert sorted(ob) == sorted(rb)
        for k in rb:
            assert ob[k].dtype == rb[k].dtype, k
            np.testing.assert_array_equal(ob[k], rb[k], err_msg=k)
    if not drop_last:
        assert not out[-1]["valid"].all() and out[-1]["valid"].sum() == len(tds) % 4


def _labels(loader):
    return np.concatenate([b["labels"][b["valid"]] for b in loader])


def test_shuffled_epochs(datasets):
    """Each epoch a permutation; the same seed and epoch the same order;
    two epochs, and two seeds, different orders."""
    from multimodal_concept_learning_tpu_torch.data.grain_pipeline import GrainLoader

    _, tds = datasets
    plain = _labels(GrainLoader(tds, batch_size=4))
    a, b = GrainLoader(tds, 4, shuffle=True, seed=3), GrainLoader(tds, 4, shuffle=True, seed=3)
    orders = []
    for epoch in (0, 1):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert sorted(a.order()) == list(range(len(tds)))
        np.testing.assert_array_equal(a.order(), b.order())
        np.testing.assert_array_equal(_labels(a), _labels(b))
        np.testing.assert_array_equal(np.sort(_labels(a)), np.sort(plain))
        orders.append(a.order())
    assert not np.array_equal(orders[0], orders[1])
    assert not np.array_equal(GrainLoader(tds, 4, shuffle=True, seed=4).order(), orders[0])


def test_worker_processes_give_the_same_batches(datasets):
    from multimodal_concept_learning_tpu_torch.data.grain_pipeline import GrainLoader

    _, tds = datasets
    ref = list(GrainLoader(tds, batch_size=4, shuffle=True, seed=1))
    out = list(GrainLoader(tds, batch_size=4, shuffle=True, seed=1, num_workers=2,
                           multiprocessing_context="spawn"))
    assert len(out) == len(ref)
    for rb, ob in zip(ref, out):
        for k in rb:
            np.testing.assert_array_equal(ob[k], rb[k], err_msg=k)
