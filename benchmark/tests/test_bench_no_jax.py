"""Nothing of the benchmark imports JAX or the JAX package (compared by
whole top-level module names: the port's name begins with the JAX
package's)."""

import ast
import os

from benchmark import harness


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    found = []
    for folder, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(folder, f)
                found += [(path, m) for m in _imports(path)
                          if m.split(".", 1)[0] in harness.FORBIDDEN]
    assert not found


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(harness.HERE, "reference")
    for f in os.listdir(folder):
        if f.endswith(".py"):
            for m in _imports(os.path.join(folder, f)):
                assert not m.startswith("multimodal_concept_learning"), (f, m)


def test_forbidden_names_are_whole_top_level_names():
    import sys

    assert "multimodal_concept_learning_tpu_torch" not in harness.FORBIDDEN
    before = set(sys.modules)
    from multimodal_concept_learning_tpu_torch.parallel import train_step  # noqa: F401

    assert not [n for n in set(sys.modules) - before if n.split(".")[0] in harness.FORBIDDEN]
