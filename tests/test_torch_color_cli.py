"""PyTorch port: the color generator's CLI (``data/color_generator.py``
``main``) against the JAX package's.

Both CLIs run as subprocesses, each in its own temporary working directory,
on one small dataset YAML whose ``data_dir`` is relative (as in every
``experiments/datasets/color/*.yaml``).  The port's runs with ``yaml`` and
``PIL`` unimportable (the card's machine has neither).  The CSVs must be
equal as text, the PNGs' pixels bitwise, and the printed lines equal once
each run's working directory is replaced by one placeholder.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
CONFIG = """dataset_name: tiny_cli
image_size: 32
colors:
- - 255
  - 0
  - 0
- - 0
  - 255
  - 0
- - 255
  - 128
  - 0
radius_range:
- 4
- 12
n_images_per_color: 5
min_intensity: 0.6
max_intensity: 1.0
train_val_test_split:
- 0.6
- 0.2
- 0.2
seed: 7
data_dir: data/color
"""
# ``python -m`` of the port's CLI, with yaml and PIL made unimportable
PORT_CLI = ("import runpy, sys; sys.modules['yaml'] = None; sys.modules['PIL'] = None; "
            "sys.argv[0] = 'color_generator'; "
            "runpy.run_module('multimodal_concept_learning_tpu_torch.data.color_generator', "
            "run_name='__main__', alter_sys=True)")


def _run(cwd: Path, args: list) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.replace(str(cwd), "<ROOT>").splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax" | "port": (working directory, printed lines)}."""
    done = {}
    for name, args in (("jax", ["-m", "multimodal_concept_learning_tpu.data.color_generator"]),
                       ("port", ["-c", PORT_CLI])):
        cwd = tmp_path_factory.mktemp(name).resolve()
        (cwd / "cfg.yaml").write_text(CONFIG)
        done[name] = (cwd, _run(cwd, [*args, "--config_path", "cfg.yaml"]))
    return done


def test_cli_prints_the_jax_lines(runs):
    jax_lines, port_lines = runs["jax"][1], runs["port"][1]
    assert port_lines == jax_lines
    assert port_lines[0] == "Generated 5 images for each of 3 colors."
    assert port_lines[-2] == "Dataset saved to: <ROOT>/data/color/tiny_cli"
    assert port_lines[-1] == "Dataset generation completed. Output: data/color/tiny_cli"


def test_cli_writes_the_jax_files(runs):
    jdir = runs["jax"][0] / "data" / "color" / "tiny_cli"
    tdir = runs["port"][0] / "data" / "color" / "tiny_cli"
    for split in ("train", "val", "test"):
        assert (tdir / f"{split}_mapping.csv").read_text() == \
            (jdir / f"{split}_mapping.csv").read_text()
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*.png"))
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*.png"))
    assert len(files) == 15
    for rel in files:
        np.testing.assert_array_equal(np.asarray(Image.open(tdir / rel)),
                                      np.asarray(Image.open(jdir / rel)), err_msg=str(rel))


def test_cli_needs_its_config_path(tmp_path):
    """No ``--config_path``: argparse's usage error, as in JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m",
                          "multimodal_concept_learning_tpu_torch.data.color_generator"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "--config_path" in out.stderr
