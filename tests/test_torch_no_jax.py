"""PyTorch port: import hygiene and the device policy.

The port's main path must run where only torch, numpy and the CUDA
toolkit are installed: importing it pulls in no jax, flax, optax, Pillow or
PyYAML.  A CUDA device that is asked for and absent is an error, never a
silent CPU run; so is a kernel build without nvcc.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
MAIN_PATH = [
    "multimodal_concept_learning_tpu_torch.serve.server",
    "multimodal_concept_learning_tpu_torch.serve.continuous",
    "multimodal_concept_learning_tpu_torch.serve.paged",
    "multimodal_concept_learning_tpu_torch.serve.loader",
    "multimodal_concept_learning_tpu_torch.models.mllm",
    "multimodal_concept_learning_tpu_torch.checkpoint",
    "multimodal_concept_learning_tpu_torch.ops.flash_attention",
    "multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel",
    "multimodal_concept_learning_tpu_torch.ops._build",
    "multimodal_concept_learning_tpu_torch.ops.losses",
    "multimodal_concept_learning_tpu_torch.ops.preprocess",
    "multimodal_concept_learning_tpu_torch.parallel.optimizer",
    "multimodal_concept_learning_tpu_torch.parallel.train_step",
    "multimodal_concept_learning_tpu_torch.data.collator",
    "multimodal_concept_learning_tpu_torch.data.color_generator",
    "multimodal_concept_learning_tpu_torch.data.datasets",
    "multimodal_concept_learning_tpu_torch.data.pipeline",
    "multimodal_concept_learning_tpu_torch.data.png",
    "multimodal_concept_learning_tpu_torch.data.transforms",
    "multimodal_concept_learning_tpu_torch.miniyaml",
    "multimodal_concept_learning_tpu_torch.train.multimodal_training",
    "chip_smoke",
]


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    """chip_smoke.py's own imports (also those inside its phases) name only
    the port, torch and the standard library."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    roots = {n.split(".")[0] for n in names}
    assert "multimodal_concept_learning_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "multimodal_concept_learning_tpu"}, roots


def _without_cuda_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_main_path_imports_no_jax_pil_or_yaml():
    code = (
        "import importlib, sys\n"
        f"for m in {MAIN_PATH!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in ('jax', 'flax', 'optax', 'PIL', 'yaml') if m in sys.modules)\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_without_cuda_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"main path imported {out.stdout.strip()}"


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    from multimodal_concept_learning_tpu_torch.device import resolve_device
    from multimodal_concept_learning_tpu_torch.serve.server import make_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        make_server(str(tmp_path), paged=True)  # the server's default device is cuda
    with pytest.raises(ValueError, match="explicit device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from multimodal_concept_learning_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib" / "kernels.so")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "lib").exists()  # nothing is created before nvcc is found


def test_trainer_cli_refuses_cuda_without_cuda(tmp_path):
    """The trainer's --device cuda never falls back to the CPU."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("dataset_name: color_multimodal\n")
    code = ("from multimodal_concept_learning_tpu_torch.train.multimodal_training import main\n"
            f"main(['--config_path', {str(cfg)!r}, '--device', 'cuda'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_without_cuda_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "is_available" in out.stderr


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_without_cuda_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_without_cuda_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
