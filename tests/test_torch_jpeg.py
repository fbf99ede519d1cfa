"""PyTorch port: the JPEG decoder (``data/jpeg.py``, ``csrc/jpeg_decode.cpp``).

- It builds here with the host C++ compiler, into ``_build/`` under a name
  hashed from its source; concurrent first builds all load one library; a
  missing compiler is an error, never another decoder.
- Every fixture of ``tests/data/jpeg`` (written by
  ``tests/make_jpeg_fixtures.py``) decodes bitwise to Pillow's
  ``Image.open(p).convert("RGB")``, and to the sha256 recorded in
  ``digests.json`` (which the card's machine, without Pillow, checks).
- Seeded random images in every variant Pillow writes (sizes 1-200 px,
  quality 1-100, grayscale, CMYK, 4:4:4 / 4:2:2 / 4:2:0, progressive,
  optimized tables, restart intervals) decode bitwise too.
- Arithmetic-coded, lossless, 12-bit, h1v2 and truncated files raise
  ``ValueError`` naming the file; a ``.JPEG`` holding a PNG decodes through
  ``read_png``.
"""

import hashlib
import io
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from make_jpeg_fixtures import scene

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
NAMES = sorted(n for n in os.listdir(FIXTURES) if n != "digests.json")


def _pillow(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_decoder_builds_with_the_host_compiler():
    from multimodal_concept_learning_tpu_torch.data import jpeg

    lib = jpeg.build()
    assert lib == jpeg.library_path() and lib.exists()
    assert lib.parent.name == "_build" and lib.name.startswith("libmcl_jpeg_")
    assert jpeg.build() == lib  # reused, not rebuilt


def test_fixture_set_covers_the_variants():
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert sorted(digests["decode"]) == NAMES and len(NAMES) >= 20
    total = sum((FIXTURES / n).stat().st_size for n in os.listdir(FIXTURES))
    assert total < 1_000_000
    for part in ("q75_420_500x375", "q95_420_500x375", "q75_420_375x500", "q95_420_375x500",
                 "422", "444", "gray", "progressive", "restart", "optimized", "cmyk",
                 "97x131", "333x500", "png_named.JPEG"):
        assert any(part in n for n in NAMES), part


@pytest.mark.parametrize("name", NAMES)
def test_fixture_decodes_bitwise_pillow(name):
    from multimodal_concept_learning_tpu_torch.data.jpeg import read_image

    got = read_image(str(FIXTURES / name))
    want = _pillow(FIXTURES / name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    recorded = json.loads((FIXTURES / "digests.json").read_text())["decode"][name]
    assert list(got.shape) == recorded["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == recorded["sha256"]


def _random_jpeg(rng, i):
    w, h = int(rng.integers(1, 200)), int(rng.integers(1, 200))
    arr = scene(w, h, seed=i)
    if rng.random() < 0.3:
        arr = np.clip(rng.normal(128, 80, arr.shape), 0, 255).astype(np.uint8)
    mode = str(rng.choice(["RGB", "RGB", "L", "CMYK"]))
    kw = dict(quality=int(rng.integers(1, 101)))
    if mode == "RGB":
        kw["subsampling"] = int(rng.integers(0, 3))
    if rng.random() < 0.4:
        kw["progressive"] = True
    if rng.random() < 0.3:
        kw["optimize"] = True
    if rng.random() < 0.3:
        kw["restart_marker_blocks"] = int(rng.integers(1, 7))
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue(), (w, h, mode, kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_variants_decode_bitwise_pillow(seed):
    from multimodal_concept_learning_tpu_torch.data.jpeg import decode_jpeg

    rng = np.random.default_rng(seed)
    for i in range(25):
        try:
            data, what = _random_jpeg(rng, 100 * seed + i)
        except OSError:  # Pillow refuses a few progressive + optimize buffers
            continue
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_jpeg(data)
        assert got.shape == want.shape and np.array_equal(got, want), what


def _patched(name: str, offset_of, value: bytes) -> bytes:
    data = bytearray((FIXTURES / name).read_bytes())
    at = offset_of(data)
    data[at:at + len(value)] = value
    return bytes(data)


def _sof(data: bytearray) -> int:
    return data.index(b"\xff\xc0")


@pytest.mark.parametrize("case,match", [
    ("arithmetic", "arithmetic-coded"),
    ("lossless", "lossless"),
    ("12-bit", "12-bit"),
    ("h1v2", "h1v2"),
    ("truncated", "truncated"),
    ("not a jpeg", "not a JPEG"),
])
def test_unsupported_files_raise(tmp_path, case, match):
    from multimodal_concept_learning_tpu_torch.data.jpeg import read_image

    name = "q90_444_97x131.jpg"
    if case == "arithmetic":
        data = _patched(name, _sof, b"\xff\xc9")
    elif case == "lossless":
        data = _patched(name, _sof, b"\xff\xc3")
    elif case == "12-bit":
        data = _patched(name, lambda d: _sof(d) + 4, b"\x0c")
    elif case == "h1v2":  # luma 1x2 over 1x1 chroma: 4:4:0
        data = _patched(name, lambda d: _sof(d) + 11, b"\x12")
    elif case == "truncated":
        data = (FIXTURES / name).read_bytes()[:1500]
    else:
        data = b"GIF89a" + bytes(100)
    path = tmp_path / f"{case}.JPEG"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        read_image(str(path))
    assert str(path) in str(err.value)


def test_png_named_jpeg_goes_to_read_png():
    from multimodal_concept_learning_tpu_torch.data.jpeg import read_image
    from multimodal_concept_learning_tpu_torch.data.png import read_png

    path = str(FIXTURES / "png_named.JPEG")
    assert (FIXTURES / "png_named.JPEG").read_bytes().startswith(b"\x89PNG\r\n\x1a\n")
    np.testing.assert_array_equal(read_image(path), read_png(path))
    np.testing.assert_array_equal(read_image(path), _pillow(path))


def test_concurrent_first_builds_load_one_library(tmp_path, monkeypatch):
    """Three threads build into an empty directory at once: each writes a
    temporary file and renames it into place, so all three load the same
    complete library and no temporary file is left."""
    from multimodal_concept_learning_tpu_torch.data import jpeg

    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(jpeg.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [paths[0].name]
    import ctypes

    assert ctypes.CDLL(str(paths[0])).mcl_jpeg_decode


def test_build_without_a_compiler_raises(tmp_path, monkeypatch):
    import shutil

    from multimodal_concept_learning_tpu_torch.data import jpeg

    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        jpeg.build()
