"""PyTorch port: import hygiene and the device policy.

The port's main path must run where only torch, numpy and the CUDA
toolkit are installed: importing it pulls in no jax, flax, optax, Pillow,
PyYAML, scikit-learn, matplotlib or module of the JAX package.  A CUDA device that is asked for and
absent is an error, never a silent CPU run; so is a kernel build without
nvcc.
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
    "multimodal_concept_learning_tpu_torch.serve.chunked",
    "multimodal_concept_learning_tpu_torch.serve.engine",
    "multimodal_concept_learning_tpu_torch.models.beam",
    "multimodal_concept_learning_tpu_torch.models.speculative",
    "multimodal_concept_learning_tpu_torch.serve.paged",
    "multimodal_concept_learning_tpu_torch.serve.loader",
    "multimodal_concept_learning_tpu_torch.models.mllm",
    "multimodal_concept_learning_tpu_torch.checkpoint",
    "multimodal_concept_learning_tpu_torch.ops.flash_attention",
    "multimodal_concept_learning_tpu_torch.ops.paged_attention_kernel",
    "multimodal_concept_learning_tpu_torch.ops.paged_attention_mp_kernel",
    "multimodal_concept_learning_tpu_torch.ops.paged_kv",
    "multimodal_concept_learning_tpu_torch.ops.int4",
    "multimodal_concept_learning_tpu_torch.ops.quant",
    "multimodal_concept_learning_tpu_torch.ops.lora",
    "multimodal_concept_learning_tpu_torch.ops.multi_lora",
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
    "multimodal_concept_learning_tpu_torch.train.contrastive_training",
    "multimodal_concept_learning_tpu_torch.models.clip",
    "multimodal_concept_learning_tpu_torch.ops.attention_core",
    "multimodal_concept_learning_tpu_torch.ops.fused_attention_block",
    "multimodal_concept_learning_tpu_torch.models.vit",
    "multimodal_concept_learning_tpu_torch.data.clip_collator",
    "multimodal_concept_learning_tpu_torch.configs",
    "multimodal_concept_learning_tpu_torch.tokenizer",
    "multimodal_concept_learning_tpu_torch.utils.logging",
    "multimodal_concept_learning_tpu_torch.train.generate_answers",
    "multimodal_concept_learning_tpu_torch.scripts.bench_int4_kernel",
    "multimodal_concept_learning_tpu_torch.scripts.bench_multi_lora",
    "multimodal_concept_learning_tpu_torch.train.vision_training",
    "multimodal_concept_learning_tpu_torch.analysis.projection",
    "multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis",
    "multimodal_concept_learning_tpu_torch.analysis.multi_token_embedding",
    "multimodal_concept_learning_tpu_torch.scripts.science_table",
    "multimodal_concept_learning_tpu_torch.ops.sparse_embed",
    "multimodal_concept_learning_tpu_torch.checkpoint_io",
    "multimodal_concept_learning_tpu_torch.train.common",
    "multimodal_concept_learning_tpu_torch.vocab_remap",
    "multimodal_concept_learning_tpu_torch.data.jpeg",
    "multimodal_concept_learning_tpu_torch.data.imagenet_builder",
    "multimodal_concept_learning_tpu_torch.data.imagenet_configs",
    "multimodal_concept_learning_tpu_torch.analysis.token_embedding_analysis_imagenet",
    "multimodal_concept_learning_tpu_torch.ops.moe",
    "multimodal_concept_learning_tpu_torch.parallel",
    "multimodal_concept_learning_tpu_torch.parallel.multihost",
    "multimodal_concept_learning_tpu_torch.parallel.mesh",
    "multimodal_concept_learning_tpu_torch.data.grain_pipeline",
    "multimodal_concept_learning_tpu_torch.utils.profiling",
    "multimodal_concept_learning_tpu_torch.utils.debugging",
    "multimodal_concept_learning_tpu_torch.utils.seeding",
    "multimodal_concept_learning_tpu_torch.scripts.bench_mllm",
    "multimodal_concept_learning_tpu_torch.parallel.collectives",
    "multimodal_concept_learning_tpu_torch.parallel.sharding_rules",
    "multimodal_concept_learning_tpu_torch.parallel.serving",
    "multimodal_concept_learning_tpu_torch.parallel.pipeline",
    "multimodal_concept_learning_tpu_torch.parallel.ring_attention",
    "chip_smoke",
]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_concept_learning_tpu"}


def _import_roots(path: Path) -> set:
    """The top-level names of every import statement in ``path``, those
    inside functions too."""
    import ast

    tree = ast.parse(path.read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module and not node.level]
    return {n.split(".")[0] for n in names}


def test_chip_smoke_imports_nothing_of_jax_or_the_jax_package():
    """chip_smoke.py's own imports (also those inside its phases) name only
    the port, torch and the standard library."""
    roots = _import_roots(REPO / "chip_smoke.py")
    assert "multimodal_concept_learning_tpu_torch" in roots
    assert not roots & FORBIDDEN, roots


def test_no_port_module_imports_jax_or_the_jax_package():
    """No module of the port names jax, flax, optax or the JAX package in
    any import, at top level or inside a function."""
    files = sorted((REPO / "multimodal_concept_learning_tpu_torch").rglob("*.py"))
    assert len(files) > 30
    port = REPO / "multimodal_concept_learning_tpu_torch"
    for new in ("ops/sparse_embed.py", "checkpoint_io.py", "train/common.py", "vocab_remap.py",
                "data/jpeg.py", "data/imagenet_builder.py", "data/imagenet_configs.py",
                "analysis/token_embedding_analysis_imagenet.py", "ops/moe.py",
                "parallel/multihost.py", "parallel/mesh.py", "data/grain_pipeline.py",
                "utils/profiling.py", "utils/debugging.py", "utils/seeding.py",
                "scripts/bench_mllm.py", "parallel/collectives.py", "parallel/sharding_rules.py",
                "parallel/serving.py", "parallel/pipeline.py", "parallel/ring_attention.py"):
        assert port / new in files, new
    bad = {str(f.relative_to(REPO)): sorted(_import_roots(f) & FORBIDDEN) for f in files}
    assert not {f: r for f, r in bad.items() if r}


def _without_cuda_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_main_path_imports_no_jax_pil_or_yaml():
    code = (
        "import importlib, sys\n"
        f"for m in {MAIN_PATH!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in ('jax', 'flax', 'optax', 'PIL', 'yaml', 'sklearn',\n"
        "                          'matplotlib', 'multimodal_concept_learning_tpu')\n"
        "             if m in sys.modules)\n"
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


def test_contrastive_cli_refuses_cuda_without_cuda(tmp_path):
    """The contrastive trainer's default --device cuda never falls back."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("dataset_name: color_contrastive\n")
    for extra in ([], ["--device", "cuda"]):
        code = ("from multimodal_concept_learning_tpu_torch.train.contrastive_training import main\n"
                f"main(['--config_path', {str(cfg)!r}] + {extra!r})\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_without_cuda_env(),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "is_available" in out.stderr, out.stderr


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


@pytest.mark.parametrize("module,args", [
    ("multimodal_concept_learning_tpu_torch.train.generate_answers", ["--results_dir", "x"]),
    ("multimodal_concept_learning_tpu_torch.scripts.bench_int4_kernel", ["--variants", "v3a"]),
    ("multimodal_concept_learning_tpu_torch.train.vision_training", ["--config_path", "x"]),
    ("multimodal_concept_learning_tpu_torch.scripts.bench_multi_lora", ["--tiny"]),
])
def test_answer_cli_and_ab_script_refuse_cuda_without_cuda(module, args):
    """The answer CLI's, the A/B entry points' and the vision trainer's
    default --device cuda never falls back to the CPU."""
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                         env=_without_cuda_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "is_available" in out.stderr, out.stderr
