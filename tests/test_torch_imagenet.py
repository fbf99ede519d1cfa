"""PyTorch port: ImageNet data on a synthetic ILSVRC2012 tree (CPU).

The tree is chip_smoke's ``write_imagenet_tree`` (JPEG fixtures copied in
turn, a PNG named ``.JPEG`` among them; a devkit with ``words.txt``,
``wordnet.is_a.txt``, a ``meta.mat`` written by ``scipy.io.savemat`` and the
val ground truth).

- ``ImageNetDataset`` items equal the JAX ``__getitem__`` (Pillow's decode
  and transforms), labels as synset indices and as class names.
- The port's ``BatchLoader`` with 4 workers gives the JAX loader's batches
  bitwise on a random train pipeline, epoch after epoch.
- The builder and ``imagenet_configs`` CLIs write the JAX CLIs' CSVs,
  labels JSON and YAML byte for byte, and print the same lines.
- ``miniyaml.dump`` writes PyYAML's ``yaml.dump(..., default_flow_style=
  False, sort_keys=False)`` text, which both readers read back.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import yaml
from PIL import Image

import chip_smoke

WORDS = {"n01000001": "dog, domestic dog, Canis familiaris", "n01000002": "cat, true cat",
         "n02000001": "car, auto", "n02000002": "truck", "n02000003": "bus, 'coach'",
         "n02000004": "true"}
PER_CLASS = {"n01000001": 5, "n01000002": 4, "n02000001": 4, "n02000002": 3,
             "n02000003": 4, "n02000004": 0}
VAL_PIPELINE = [{"name": "Resize", "size": [40, 40]}, "ToTensor", "Normalize"]
TRAIN_PIPELINE = [{"name": "RandomResizedCrop", "size": 32, "scale": [0.3, 1.0]},
                  "RandomHorizontalFlip", {"name": "RandAugment", "num_ops": 2},
                  "ToTensor", "Normalize", {"name": "RandomErasing", "p": 0.5}]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    return chip_smoke.write_imagenet_tree(str(root / "imagenet"), WORDS, PER_CLASS, n_val=10)


def _dataset_yaml(path, tree, out, **over):
    cfg = dict(data_dir=tree, output_dir=out, dataset_name="mini", allow_shortfall=True,
               seed=3, per_class_train=2, per_class_val=1, per_class_test=2,
               target_synsets=["n00000002", "n02000002", "n02000003", "n02000004"])
    cfg.update(over)
    path.write_text(yaml.dump(cfg))
    return str(path)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def mapping(tree, tmp_path_factory):
    """The port's builder CLI over the tree: the mapping dir."""
    from multimodal_concept_learning_tpu_torch.data.imagenet_builder import main

    tmp = tmp_path_factory.mktemp("mapping")
    _run(main, ["--config_path", _dataset_yaml(tmp / "ds.yaml", tree, str(tmp))])
    return str(tmp / "mini")


def test_builder_cli_matches_jax(tree, tmp_path):
    from multimodal_concept_learning_tpu.data.imagenet_builder import main as jmain
    from multimodal_concept_learning_tpu_torch.data.imagenet_builder import main

    texts = {}
    for pkg, fn in (("port", main), ("jax", jmain)):
        out = tmp_path / pkg
        out.mkdir()
        _, texts[pkg] = _run(fn, ["--config_path", _dataset_yaml(out / "ds.yaml", tree,
                                                                  str(out))])
    assert texts["port"].replace(str(tmp_path / "port"), "X") == texts["jax"].replace(
        str(tmp_path / "jax"), "X")
    assert "Warning: No training images found for synset n02000004" in texts["port"]
    for split in ("train", "val", "test"):
        got = (tmp_path / "port" / "mini" / f"{split}_mapping.csv").read_bytes()
        assert got == (tmp_path / "jax" / "mini" / f"{split}_mapping.csv").read_bytes(), split
        assert got.startswith(b"image_path,target_synset,class_name\r\n")
    rows = (tmp_path / "port" / "mini" / "train_mapping.csv").read_text().splitlines()
    assert any(",n00000002,dog" in r or ",n00000002,group one" in r for r in rows)


def test_builder_helpers_match_jax(tree):
    import multimodal_concept_learning_tpu.data.imagenet_builder as J
    import multimodal_concept_learning_tpu_torch.data.imagenet_builder as P

    for name in ("load_wnid_to_name_mapping", "load_ilsvrc_to_wnid_mapping",
                 "load_imagenet1k_wnids", "load_parent_child_relationships"):
        assert getattr(P, name)(tree) == getattr(J, name)(tree), name
    p2c, wnids = P.load_parent_child_relationships(tree), P.load_imagenet1k_wnids(tree)
    assert P.get_all_imagenet1k_descendants("n00000002", p2c, wnids) == [
        "n01000001", "n02000001", "n02000003"]
    import random

    images = {"a": ["x1", "x2"], "b": ["y1"]}
    with pytest.raises(ValueError, match="Not enough images for synset b"):
        P.sample_images(images, 2, False, random.Random(0))
    assert P.sample_images(images, 2, True, random.Random(0)) == J.sample_images(
        images, 2, True, random.Random(0))


def test_imagenet_configs_cli_matches_jax(tree, tmp_path):
    from multimodal_concept_learning_tpu.data.imagenet_configs import main as jmain
    from multimodal_concept_learning_tpu_torch.data.imagenet_configs import main

    outs = {}
    for pkg, fn in (("port", main), ("jax", jmain)):
        root = tmp_path / pkg
        paths, text = _run(fn, ["--data_dir", tree, "--dataset_name", "mini1k", "--num_ood",
                                "2", "--per_class_train", "3", "--output_root", str(root)])
        outs[pkg] = [open(p, "rb").read() for p in paths], text.replace(str(root), "X")
    assert outs["port"] == outs["jax"]
    (config_text, labels), _ = outs["port"]
    assert yaml.safe_load(config_text)["target_synsets"] == sorted(WORDS)
    from multimodal_concept_learning_tpu_torch import miniyaml

    assert miniyaml.safe_load(config_text.decode()) == yaml.safe_load(config_text)
    mapping = json.loads(labels)
    assert sum(v.startswith("<ood_") for v in mapping.values()) == 2
    assert mapping["n01000002"] in ("cat", "<ood_cat>")


@pytest.mark.parametrize("return_synset", [False, True])
def test_dataset_items_match_jax(mapping, tree, return_synset):
    from multimodal_concept_learning_tpu.configs import VisionTrainingConfig as JConfig
    from multimodal_concept_learning_tpu.data import ImageNetDataset as JDataset
    from multimodal_concept_learning_tpu.data.transforms import create_transforms as jcreate
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    params = dict(dataset_name="imagenet100", val_transforms=VAL_PIPELINE)
    csv_path = os.path.join(mapping, "train_mapping.csv")
    port = ImageNetDataset(csv_path, tree, create_transforms(
        VisionTrainingConfig.from_params(params), False, 0), return_synset, verbose=False)
    ref = JDataset(csv_path, tree, jcreate(JConfig.from_params(params), False, 0),
                   return_synset, verbose=False)
    assert len(port) == len(ref) > 5 and port.label_to_idx == ref.label_to_idx
    assert port.num_classes == ref.num_classes
    for i in range(len(ref)):
        (got, label), (want, want_label) = port[i], ref[i]
        assert label == want_label
        np.testing.assert_array_equal(got, want)
        image, _ = port.load_uint8(i)
        with Image.open(ref.dataset[i][0]) as im:
            np.testing.assert_array_equal(image, np.asarray(im.convert("RGB")))


def test_loader_batches_match_jax(mapping, tree):
    """A random train pipeline through 4 loader workers: the JAX loader's
    batches (it transforms sample by sample), two epochs, bitwise."""
    from multimodal_concept_learning_tpu.configs import VisionTrainingConfig as JConfig
    from multimodal_concept_learning_tpu.data import BatchLoader as JLoader
    from multimodal_concept_learning_tpu.data import ImageNetDataset as JDataset
    from multimodal_concept_learning_tpu.data.transforms import create_transforms as jcreate
    from multimodal_concept_learning_tpu_torch.configs import VisionTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.pipeline import BatchLoader
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    params = dict(dataset_name="imagenet100", train_transforms=TRAIN_PIPELINE)
    csv_path = os.path.join(mapping, "train_mapping.csv")
    port = ImageNetDataset(csv_path, tree, create_transforms(
        VisionTrainingConfig.from_params(params), True, 5), verbose=False)
    ref = JDataset(csv_path, tree, jcreate(JConfig.from_params(params), True, 5),
                   verbose=False)
    ref._native_spec = None  # the JAX package's Pillow path
    loaders = (BatchLoader(port, 3, shuffle=True, drop_last=True, seed=5, num_workers=4),
               JLoader(ref, 3, shuffle=True, drop_last=True, seed=5, num_workers=4))
    for epoch in range(2):
        for loader in loaders:
            loader.set_epoch(epoch)
        got, want = (list(loader) for loader in loaders)
        assert len(got) == len(want) >= 2
        for a, b in zip(got, want):
            assert a["images"].shape == (3, 3, 32, 32)
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["labels"], b["labels"])


def _config_dict(**over):
    from multimodal_concept_learning_tpu_torch.configs import ImageNetDatasetConfig

    return dict(dataclasses.asdict(ImageNetDatasetConfig()), **over)


@pytest.mark.parametrize("data", [
    _config_dict(),
    _config_dict(target_synsets=["n01440764", "n01443537"], allow_shortfall=True,
                 output_dir="data/multimodal_concept_learning/imagenet1k"),
    {"a": "true", "b": "123", "c": "a: b", "d": "", "e": "- x", "f": "#x", "g": "2001-12-14",
     "h": "it's", "i": None, "j": False, "k": 0, "l": "5e-4", "m": "1.5", "n": "~",
     "o": "yes", "p": "x:", "q": "<ood_stingray>", "r": "a b", "s": ["null", "x y", "'q'"],
     "t": [], "u": "data dir/with space", "v": "-1", "w": ":x", "x": "?y", "y": "@z"},
])
def test_yaml_writer_matches_pyyaml(data):
    from multimodal_concept_learning_tpu_torch import miniyaml

    text = miniyaml.dump(data)
    assert text == yaml.dump(data, default_flow_style=False, sort_keys=False)
    assert yaml.safe_load(text) == data
    assert miniyaml.safe_load(text) == data
    buf = io.StringIO()
    assert miniyaml.dump(data, buf) is None and buf.getvalue() == text


@pytest.mark.parametrize("value", ["word " * 20, "café", "tab\there", {"nested": 1}])
def test_yaml_writer_refuses_what_pyyaml_would_fold_or_escape(value):
    from multimodal_concept_learning_tpu_torch import miniyaml

    with pytest.raises(ValueError):
        miniyaml.dump({"key": value})
    if isinstance(value, str) and value.startswith("word"):
        assert "\n  " in yaml.dump({"key": value}, default_flow_style=False)  # folded


def test_native_loader_resize_is_not_pillows(tmp_path):
    """Queue C, "the native loader's resize": with ``libfastimage.so``
    loaded, the JAX ``get_batch`` takes imagenet1k_vit's val pipeline
    (Resize 224 + ToTensor + Normalize) through ``native/fastimage.cc``'s
    bilinear resize without antialiasing.  The port follows Pillow
    (``__getitem__``) bitwise; against the native batch a 500x375 or
    375x500 downscale differs by up to tens of levels on most values, an
    upscale (97x131) by at most one level."""
    from multimodal_concept_learning_tpu.configs import MultimodalTrainingConfig as JConfig
    from multimodal_concept_learning_tpu.data import ImageNetDataset as JDataset
    from multimodal_concept_learning_tpu.data import native_loader
    from multimodal_concept_learning_tpu.data.transforms import create_transforms as jcreate
    from multimodal_concept_learning_tpu_torch.configs import MultimodalTrainingConfig
    from multimodal_concept_learning_tpu_torch.data.datasets import ImageNetDataset
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    assert native_loader.available()
    names = ["q75_420_500x375.jpg", "q95_420_375x500.jpg", "q90_422_333x500.jpg",
             "q90_444_97x131.jpg"]
    csv_path = tmp_path / "m.csv"
    csv_path.write_text("image_path,target_synset,class_name\n"
                        + "".join(f"{n},n0000000{i},c{i}\n" for i, n in enumerate(names)))
    rel = "experiments/multimodal/imagenet/imagenet1k_vit.yaml"
    with open(os.path.join(chip_smoke.REPO, rel)) as f:
        params = yaml.safe_load(f)
    fixtures = chip_smoke.JPEG_FIXTURES
    port = ImageNetDataset(str(csv_path), fixtures, create_transforms(
        MultimodalTrainingConfig.from_params(params), False, 0), verbose=False)
    ref = JDataset(str(csv_path), fixtures, jcreate(JConfig.from_params(params), False, 0),
                   verbose=False)
    native = ref.get_batch(list(range(len(names))))
    assert ref._native_spec is not None  # the C++ path served the batch
    std = np.float32([0.229, 0.224, 0.225])[:, None, None]
    for i, name in enumerate(names):
        got = port[i][0]
        np.testing.assert_array_equal(got, ref[i][0])  # Pillow's resize, bitwise
        levels = np.abs(got - native[i][0]) * std * 255  # in 0-255 levels
        if "97x131" in name:
            assert levels.max() < 1.01, name
        else:
            assert levels.max() > 30 and (levels > 0.5).mean() > 0.6, (name, levels.max())
