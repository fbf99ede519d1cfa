"""PyTorch port: the image transforms without Pillow (``data/transforms.py``).

Every transform of the JAX registry, on uint8 arrays, against the JAX
class on the same image through Pillow, with the same PCG64 seed:

- each transform (defaults and other parameters) on images of several
  sizes over several seeds: the outputs bitwise equal, and the generators
  in the same state afterwards (the same draws, in the same order);
- each of RandAugment's 14 ops forced, at magnitudes 0, 10 and 30 and both
  signs: bitwise;
- the train and val pipelines of the four ImageNet configs over JPEG
  fixtures decoded by the port, several seeds: bitwise, float32 after
  ``Normalize``; and the port's outputs equal the JAX digests recorded in
  ``tests/data/jpeg/digests.json``, which the card's machine checks.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import multimodal_concept_learning_tpu.data.transforms as J
import multimodal_concept_learning_tpu_torch.data.transforms as P
from chip_smoke import IMAGENET_CONFIGS as PIPELINE_CONFIGS
from make_jpeg_fixtures import load_config, scene

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SEEDS = (0, 1, 7)


def _images():
    from multimodal_concept_learning_tpu_torch.data.jpeg import read_image

    return [scene(97, 131, 3), scene(200, 150, 4), scene(64, 64, 5),
            read_image(str(FIXTURES / "q75_420_500x375.jpg"))]


def _rng(seed):
    return np.random.Generator(np.random.PCG64(seed))


def _same(got, want, what):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got, want), (what, int(np.abs(got.astype(float) - want).max()))


CASES = [
    ("Resize", dict(size=224)),
    ("Resize", dict(size=(100, 80))),
    ("Resize", dict(size=40)),
    ("RandomResizedCrop", dict(size=224)),
    ("RandomResizedCrop", dict(size=(48, 64), scale=(0.8, 1.0))),
    ("RandomResizedCrop", dict(size=32, scale=(0.9, 1.0), ratio=(2.5, 3.0))),
    ("RandomHorizontalFlip", dict()),
    ("ColorJitter", dict()),
    ("ColorJitter", dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1)),
    ("ColorJitter", dict(brightness=0, contrast=0, saturation=0, hue=0.5)),
    ("RandomRotation", dict()),
    ("RandomRotation", dict(degrees=(85.0, 95.0))),
    ("RandomAffine", dict()),
    ("RandomAffine", dict(degrees=20, translate=(0.2, 0.1), scale=(0.7, 1.3), shear=10)),
    ("RandomPerspective", dict(p=1.0)),
    ("RandomPerspective", dict(distortion_scale=0.5, p=0.5)),
    ("RandomErasing", dict(p=1.0)),
    ("RandAugment", dict()),
    ("RandAugment", dict(num_ops=3, magnitude=10)),
    ("RandAugment", dict(num_ops=4, magnitude=30)),
]


@pytest.mark.parametrize("name,params", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_transform_matches_jax(name, params):
    for i, img in enumerate(_images()):
        for seed in SEEDS:
            port, ref = getattr(P, name)(**params), getattr(J, name)(**params)
            rp, rj = _rng(seed), _rng(seed)
            if name == "RandomErasing":  # tensor space: after ToTensor
                x = P.ToTensor()(img, None)
                got, want = port(x, rp), ref(J.ToTensor()(Image.fromarray(img), None), rj)
            else:
                got, want = port(img, rp), ref(Image.fromarray(img), rj)
            _same(got, want, (name, params, i, seed))
            assert rp.bit_generator.state == rj.bit_generator.state, (name, i, seed)


@pytest.mark.parametrize("op", P.RAND_AUGMENT_OPS)
def test_rand_augment_op_matches_jax(op):
    assert tuple(P.RAND_AUGMENT_OPS) == (
        "Identity", "AutoContrast", "Equalize", "Rotate", "Solarize", "Color", "Posterize",
        "Contrast", "Brightness", "Sharpness", "ShearX", "ShearY", "TranslateX", "TranslateY")
    for img in _images()[:3]:
        for magnitude in (0, 10, 30):
            for sign in (-1.0, 1.0):
                port = P.RandAugment(magnitude=magnitude)
                ref = J.RandAugment(magnitude=magnitude)
                got = port._apply(img, op, sign)
                want = ref._apply(Image.fromarray(img), op, sign, _rng(0))
                _same(got, want, (op, magnitude, sign))


def _fixture_images(n=None):
    from multimodal_concept_learning_tpu_torch.data.jpeg import read_image

    names = sorted(p.name for p in FIXTURES.iterdir() if p.name != "digests.json")
    return [read_image(str(FIXTURES / name)) for name in names[:n]]


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("kind,rel", PIPELINE_CONFIGS, ids=[Path(r).stem for _, r in PIPELINE_CONFIGS])
def test_imagenet_pipelines_match_jax(kind, rel, split):
    from multimodal_concept_learning_tpu.data.transforms import create_transforms as jcreate
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    pconfig = load_config(kind, rel, "multimodal_concept_learning_tpu_torch")
    jconfig = load_config(kind, rel, "multimodal_concept_learning_tpu")
    images = _fixture_images()[::3]
    for seed in (0, 3):
        port = create_transforms(pconfig, is_train=split == "train", seed=seed)
        ref = jcreate(jconfig, is_train=split == "train", seed=seed)
        assert [type(t).__name__ for t in port.transforms] == [
            type(t).__name__ for t in ref.transforms]
        for i, img in enumerate(images):
            got = port(img)
            _same(got, np.asarray(ref(Image.fromarray(img)), np.float32), (rel, split, seed, i))
            assert got.dtype == np.float32 and got.shape == (3, 224, 224)
        assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_recorded_jax_digests_match_the_port():
    """The first six fixtures through every recorded pipeline: the port's
    outputs have the JAX digests that digests.json holds."""
    from multimodal_concept_learning_tpu_torch.data.transforms import create_transforms

    recorded = json.loads((FIXTURES / "digests.json").read_text())
    images = _fixture_images(6)
    assert sorted(recorded["pipelines"]) == sorted(rel for _, rel in PIPELINE_CONFIGS)
    for kind, rel in PIPELINE_CONFIGS:
        config = load_config(kind, rel, "multimodal_concept_learning_tpu_torch")
        for split, by_seed in recorded["pipelines"][rel].items():
            for seed, want in by_seed.items():
                t = create_transforms(config, is_train=split == "train", seed=int(seed))
                got = [hashlib.sha256(t(img).tobytes()).hexdigest() for img in images]
                assert got == want[:6], (rel, split, seed)


def test_registry_defaults_and_uint8_spec():
    class Cfg:
        dataset_name = "imagenet100"
        image_size = 96
        train_transforms = ["Resize", "RandomResizedCrop", "ToTensor", "Normalize"]
        val_transforms = ["ToTensor", {"name": "Normalize", "mean": [0.1, 0.2, 0.3]}]
        transform_params = {"RandomResizedCrop": {"scale": [0.5, 1.0]}}

    port = P.create_transforms(Cfg, True, 0)
    ref = J.create_transforms(Cfg, True, 0)
    assert port.transforms[0].size == ref.transforms[0].size == 96
    assert port.transforms[1].size == ref.transforms[1].size == (96, 96)
    assert port.transforms[1].scale == ref.transforms[1].scale == (0.5, 1.0)
    np.testing.assert_array_equal(port.transforms[3].mean, ref.transforms[3].mean)
    assert port.uint8_spec() is None
    # mean given without std: both statistics come from the dataset table
    val = P.create_transforms(Cfg, False, 0)
    np.testing.assert_array_equal(val.transforms[1].mean.ravel(),
                                  np.float32([0.485, 0.456, 0.406]))
    mean, std = val.uint8_spec()
    np.testing.assert_array_equal(std, np.float32([0.229, 0.224, 0.225]))
    with pytest.raises(TypeError, match="after ToTensor"):
        P.Normalize([0.5] * 3, [0.5] * 3)(scene(8, 8, 0), None)
    with pytest.raises(TypeError, match="after ToTensor"):
        P.RandomErasing(p=1.0)(scene(8, 8, 0), _rng(0))
