"""PyTorch port: the Pillow-free input path vs the JAX package (CPU).

Everything here is exact: the collator's arrays, the loader's batches,
the generator's pixels, splits and CSVs, the PNG reader against Pillow, and
the YAML reader against ``yaml.safe_load`` on every file under
``experiments/``.
"""

import csv
import glob
import os
from pathlib import Path

import numpy as np
import pytest
import yaml
from PIL import Image

from multimodal_concept_learning_tpu.configs import ColorDatasetConfig
from multimodal_concept_learning_tpu.tokenizer import load_tokenizer
from multimodal_concept_learning_tpu_torch import miniyaml
from multimodal_concept_learning_tpu_torch.data import png

REPO = Path(__file__).resolve().parents[1]
COLORS = [[255, 0, 0], [0, 255, 0], [255, 32, 0], [0, 255, 32]]
LABELS_MAPPING = {"r255g0b0": "red", "r0g255b0": "green", "r255g32b0": "<ood 1>",
                  "r0g255b32": "<ood 2>"}


def _dataset_config(root, config_cls=ColorDatasetConfig, **kw):
    return config_cls.from_params(dict(
        {"dataset_name": "tiny", "image_size": 32, "colors": COLORS, "radius_range": [4, 10],
         "n_images_per_color": 10, "min_intensity": 0.7, "max_intensity": 1.0,
         "train_val_test_split": [0.6, 0.2, 0.2], "data_dir": str(root), "seed": 3}, **kw))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same settings generated by both packages, each from its own
    config class: (jax dir, port dir)."""
    from multimodal_concept_learning_tpu.data import generate_color_dataset as jgen
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig as PortConfig,
    )
    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        generate_color_dataset as tgen,
    )

    root = tmp_path_factory.mktemp("data")
    jdir = jgen(_dataset_config(root / "jax"), verbose=False)
    tdir = tgen(_dataset_config(root / "port", PortConfig), verbose=False)
    return jdir, tdir


@pytest.mark.parametrize("path", sorted(glob.glob(str(REPO / "experiments" / "datasets" / "color"
                                                      / "*.yaml"))) + [None])
def test_color_dataset_config_matches_jax(path):
    """The port's ColorDatasetConfig reads every color dataset YAML (and an
    empty mapping: the defaults) into the JAX config's values."""
    import dataclasses

    from multimodal_concept_learning_tpu_torch.data.color_generator import (
        ColorDatasetConfig as PortConfig,
    )

    params = {}
    if path is not None:
        with open(path) as f:
            params = yaml.safe_load(f)
    got = dataclasses.asdict(PortConfig.from_params(params))
    want = dataclasses.asdict(ColorDatasetConfig.from_params(params))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, (list, tuple)):
            value = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in value)
        assert got[key] == value and type(got[key]) is type(value), key


def test_color_generator_matches_jax(datasets):
    jdir, tdir = datasets
    for split in ("train", "val", "test"):
        assert (Path(jdir) / f"{split}_mapping.csv").read_text() == \
            (Path(tdir) / f"{split}_mapping.csv").read_text()
    files = sorted(p.relative_to(jdir) for p in Path(jdir).rglob("*.png"))
    assert files == sorted(p.relative_to(tdir) for p in Path(tdir).rglob("*.png"))
    assert len(files) == 40
    for rel in files:
        np.testing.assert_array_equal(np.asarray(Image.open(Path(tdir) / rel)),
                                      np.asarray(Image.open(Path(jdir) / rel)), err_msg=str(rel))


def test_compute_split_counts_matches_jax():
    from multimodal_concept_learning_tpu.data import compute_split_counts as jcounts
    from multimodal_concept_learning_tpu_torch.data.color_generator import compute_split_counts

    for n in (0, 1, 7, 8, 10, 3000):
        for ratios in ([0.8, 0.1, 0.1], [0.7, 0.15, 0.15], [1 / 3] * 3):
            assert compute_split_counts(n, ratios) == jcounts(n, ratios)


@pytest.mark.parametrize("mode,size", [("RGB", (23, 17)), ("RGBA", (16, 9)), ("RGB", (64, 64))])
def test_png_reader_matches_pillow(tmp_path, mode, size):
    """Pillow-written PNGs (its adaptive per-row filters: all five kinds on
    a noisy gradient image) read back exactly; RGBA drops alpha as
    convert("RGB") does."""
    rng = np.random.default_rng(0)
    h, w = size
    base = (np.add.outer(np.arange(h), np.arange(w))[:, :, None] * 7 % 256).astype(np.int64)
    img = (base + rng.integers(0, 3, (h, w, len(mode)))) % 256
    path = tmp_path / "x.png"
    Image.fromarray(img.astype(np.uint8), mode).save(path, optimize=False)
    np.testing.assert_array_equal(png.read_png(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_png_filters_and_writer_round_trip(tmp_path):
    """Every row filter (0-4) by hand, the writer read by Pillow, and the
    variants the reader refuses."""
    import struct
    import zlib

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    path = tmp_path / "w.png"
    png.write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(str(path)), img)

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)

    raw = bytearray()
    rows = img.reshape(5, 18).astype(int)
    for y, kind in enumerate([0, 1, 2, 3, 4]):
        prev = rows[y - 1] if y else np.zeros(18, int)
        out = []
        for x in range(18):
            a = rows[y, x - 3] if x >= 3 else 0
            c = prev[x - 3] if x >= 3 else 0
            pred = [0, a, prev[x], (a + prev[x]) // 2, paeth(a, prev[x], c)][kind]
            out.append((rows[y, x] - pred) % 256)
        raw += bytes([kind] + out)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    head = struct.pack(">IIBBBBB", 6, 5, 8, 2, 0, 0, 0)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
                     + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)

    Image.fromarray(img[:, :, 0]).save(tmp_path / "gray.png")
    with pytest.raises(ValueError, match="8-bit RGB/RGBA"):
        png.read_png(str(tmp_path / "gray.png"))
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(path), img.astype(np.float32))


@pytest.fixture(scope="module")
def tokenizer():
    tok = load_tokenizer("nano")
    tok.add_tokens([v for v in LABELS_MAPPING.values() if v.startswith("<ood")])
    return tok


@pytest.mark.parametrize("with_mapping", [True, False])
def test_collator_matches_jax(tokenizer, with_mapping):
    """Same arrays for the same seed: yes/no coins, <ood> answers, pad_to
    inference, the unfound-span quirk (a label the prompt text lacks)."""
    from multimodal_concept_learning_tpu.data.collator import MultimodalCollator as JCollator
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator

    mapping = dict(LABELS_MAPPING, r9g9b9="<ood 9>") if with_mapping else None
    names = sorted(LABELS_MAPPING)
    kw = dict(num_vision_tokens=5, prompt_template="Is the color of the circle {class_name}?",
              all_class_names=names, labels_mapping=mapping, seed=7)
    jc, tc = JCollator(tokenizer, **kw), MultimodalCollator(tokenizer, **kw)
    assert tc.pad_to == jc.pad_to
    rng = np.random.default_rng(0)
    for _ in range(4):
        keys = [names[i] for i in rng.integers(0, len(names), 6)]
        if with_mapping:
            keys[0] = "r9g9b9"  # an <ood> label the tokenizer splits: the unfound-span quirk
        batch = [(rng.random((3, 4, 4)).astype(np.float32), k) for k in keys]
        ref, out = jc(batch), tc(batch)
        assert sorted(out) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("split,shuffle,drop_last", [("train", True, True), ("val", False, False)])
def test_loader_batches_match_jax(datasets, tokenizer, split, shuffle, drop_last):
    """The port's BatchLoader over the port's ColorDataset == the JAX
    BatchLoader over the JAX ColorDataset: batch order per seed and epoch,
    drop_last, the padded final batch's ``valid``, and every array."""
    from multimodal_concept_learning_tpu.data import BatchLoader as JLoader
    from multimodal_concept_learning_tpu.data import ColorDataset as JDataset
    from multimodal_concept_learning_tpu.data import MultimodalCollator as JCollator
    from multimodal_concept_learning_tpu.data import create_transforms as jtransforms
    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
    from multimodal_concept_learning_tpu_torch.data.datasets import ColorDataset
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    class Cfg:
        train_transforms = val_transforms = ["ToTensor"]

    jdir, tdir = datasets
    csv_path = f"{split}_mapping.csv"
    jds = JDataset(os.path.join(jdir, csv_path), jdir, jtransforms(Cfg, False), True, False)
    # the JAX loader on its Pillow path: its optional C++ decoder (native/)
    # scales by a float32 1/255 and can differ from x / 255 by one ulp
    jds._native_spec = None
    tds = ColorDataset(os.path.join(tdir, csv_path), tdir, create_transforms(Cfg, False), True,
                       False)
    kw = dict(num_vision_tokens=5, prompt_template="Is the color of the circle {class_name}?",
              all_class_names=jds.unique_labels, labels_mapping=LABELS_MAPPING, seed=1)
    loaders = [
        JLoader(jds, batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=2, num_workers=2,
                collate_fn=JCollator(tokenizer, **kw)),
        BatchLoader(tds, batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=2,
                    num_workers=2, collate_fn=MultimodalCollator(tokenizer, **kw)),
    ]
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        ref, out = (list(loader) for loader in loaders)
        assert len(out) == len(ref) == len(loaders[1])
        for rb, ob in zip(ref, out):
            assert sorted(ob) == sorted(rb)
            for k in rb:
                np.testing.assert_array_equal(ob[k], rb[k], err_msg=k)


def test_uint8_loader_path(datasets, tokenizer):
    """device_normalize: uint8 [H, W, 3] images plus the transform's
    mean/std, whose device normalisation equals the float path."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.collator import MultimodalCollator
    from multimodal_concept_learning_tpu_torch.data.datasets import ColorDataset
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader, to_device
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms
    from multimodal_concept_learning_tpu_torch.ops.preprocess import images_from_batch

    class Cfg:
        val_transforms = ["ToTensor", "Normalize"]
        normalize_mean, normalize_std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]

    _, tdir = datasets
    ds = ColorDataset(os.path.join(tdir, "val_mapping.csv"), tdir, create_transforms(Cfg, False),
                      True, False)
    coll = MultimodalCollator(tokenizer, 5, all_class_names=ds.unique_labels, seed=0)
    u8, f32 = (next(iter(BatchLoader(ds, 4, collate_fn=coll, uint8_images=u)))
               for u in (True, False))
    assert u8["images_u8"].dtype == np.uint8 and u8["images_u8"].shape == (4, 32, 32, 3)
    got = images_from_batch(to_device(u8, "cpu")).numpy()
    np.testing.assert_allclose(got, f32["images"], atol=1e-6, rtol=0)
    assert torch.is_tensor(to_device(f32, "cpu")["valid"])


def test_transforms_refuse_unported():
    """Every name of the JAX registry builds (since the ImageNet slice);
    a name outside it is refused as the JAX registry refuses it."""
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    class Cfg:
        train_transforms = ["ToTensor", {"name": "RandomHorizontalFlip"}]

    assert len(create_transforms(Cfg, True).transforms) == 2
    Cfg.train_transforms = ["ToTensor", {"name": "GaussianBlur"}]
    with pytest.raises(ValueError, match="Unknown transform: GaussianBlur"):
        create_transforms(Cfg, True)


EXPERIMENT_YAMLS = sorted(glob.glob(str(REPO / "experiments" / "**" / "*.yaml"), recursive=True))


def test_yaml_reader_matches_pyyaml_on_every_experiment():
    assert len(EXPERIMENT_YAMLS) == 29
    for path in EXPERIMENT_YAMLS:
        with open(path) as f:
            text = f.read()
        assert miniyaml.safe_load(text) == yaml.safe_load(text), path


@pytest.mark.parametrize("text", [
    "a: 5e-4\nb: 5.0e-4\nc: 012\nd: 0x1f\ne: yes\nf: ~\ng: 'it''s'\nh: \"x\\ty\"\n",
    "i: [1, {a: b, 'c d': [2, null]}, \"e\"]\nj: -.inf\nk:\n- - 1\n  - 2\n- - 3\n",
    "x:\n  y:\n  - a: 1  # comment\n    b: [2]\n  z: 3\n# tail\n",
    "- a\n- b: c\n  d: e\n-\n  - f\n",
    "",
])
def test_yaml_reader_matches_pyyaml_on_the_subset(text):
    assert miniyaml.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  text\n", "--- \na: 1\n", "a: 1:30\n",
                                  "a: !!str 1\n", "a: [1,\n  2]\n"])
def test_yaml_reader_refuses_the_rest(text):
    with pytest.raises(ValueError):
        miniyaml.safe_load(text)


def test_color_dataset_reads_the_generated_split(datasets):
    from multimodal_concept_learning_tpu.data import ColorDataset as JDataset
    from multimodal_concept_learning_tpu_torch.data.datasets import (
        ColorDataset,
        ImageNetDataset,
        load_split_datasets,
    )

    _, tdir = datasets
    splits = load_split_datasets(ColorDataset, tdir, tdir, None, None, return_synset=False)
    ref = JDataset(os.path.join(tdir, "train_mapping.csv"), tdir, None, False, False)
    assert splits[0].label_to_idx == ref.label_to_idx and len(splits[0]) == len(ref)
    image, label = splits[0][3]
    np.testing.assert_array_equal(image, np.asarray(ref[3][0]))
    assert label == ref[3][1]
    with open(os.path.join(tdir, "test_mapping.csv")) as f:
        assert len(splits[2]) == sum(1 for _ in csv.DictReader(f))
    with pytest.raises(FileNotFoundError):  # ImageNetDataset is ported: a CSV is read
        ImageNetDataset(os.path.join(tdir, "missing.csv"), tdir)
    with pytest.raises(FileNotFoundError, match="Missing train mapping"):
        load_split_datasets(ColorDataset, str(REPO), tdir, None, None)


def test_right_padding_is_decided_on_the_host():
    """to_device adds kv_lens for a right-padded mask only (left padding and
    holes keep the bias path); the lengths are the rows' sums."""
    import torch

    from multimodal_concept_learning_tpu_torch.data.pipeline import (
        right_padded_lengths,
        to_device,
    )

    right = np.asarray([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(right_padded_lengths(right), [3, 4, 1])
    assert right_padded_lengths(right).dtype == np.int32
    assert right_padded_lengths(right[:, ::-1]) is None  # left padding
    assert right_padded_lengths(np.asarray([[1, 0, 1, 0]], np.int32)) is None  # a hole
    out = to_device({"attention_mask": right}, "cpu")
    assert out["kv_lens"].dtype == torch.int32 and out["kv_lens"].tolist() == [3, 4, 1]
    assert "kv_lens" not in to_device({"attention_mask": right[:, ::-1]}, "cpu")
