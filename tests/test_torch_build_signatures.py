"""PyTorch port: the ctypes bindings of ``ops/_build.py`` against the C sources.

The CUDA kernels are bound with ctypes from ``_SIGNATURES``; a binding that
miscounts or mistypes an entry point's parameters passes garbage on the card
without an error.  These tests parse ``csrc/*.cu`` (no compiler needed) and
hold every binding to the ``extern "C"`` definition it names: the same
number of parameters, each of the same kind (pointer, int, long long,
float), and every ``extern "C" int mcl_*`` entry point bound.
"""

import ctypes
import re

import pytest

from multimodal_concept_learning_tpu_torch.ops import _build

_DEF = re.compile(r'extern\s+"C"\s+(int|const\s+char\s*\*)\s+(mcl_\w+)\s*\(([^)]*)\)\s*\{',
                  re.S)


def _definitions() -> dict:
    """{name: (return type, [parameter declarations])} of every extern "C"
    function defined in csrc/*.cu."""
    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for ret, name, params in _DEF.findall(text):
            assert name not in found, f"{name} is defined twice"
            decls = [p.strip() for p in params.split(",") if p.strip()]
            found[name] = (" ".join(ret.split()), decls)
    return found


def _kind(decl: str):
    """The ctypes type a C parameter declaration must be bound with."""
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()[:-1]  # the type, without the parameter's name
    if words == ["long", "long"]:
        return ctypes.c_longlong
    if words == ["float"]:
        return ctypes.c_float
    if words == ["int"]:
        return ctypes.c_int
    raise AssertionError(f"unexpected parameter type in {decl!r}")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_definition(name):
    defs = _definitions()
    assert name in defs, f"{name} is bound but no csrc/*.cu defines it"
    ret, decls = defs[name]
    assert ret == "int", f"{name} returns {ret}; the bindings expect a cudaError_t as int"
    bound = list(_build._SIGNATURES[name])
    assert len(bound) == len(decls), (
        f"{name}: {len(bound)} bound parameters, {len(decls)} in its definition")
    for i, (argtype, decl) in enumerate(zip(bound, decls)):
        assert argtype is _kind(decl), f"{name} parameter {i} ({decl!r}) bound as {argtype}"


def test_every_entry_point_is_bound():
    defs = _definitions()
    entry_points = {n for n, (ret, _) in defs.items() if ret == "int"}
    assert entry_points == set(_build._SIGNATURES), (
        f"unbound: {sorted(entry_points - set(_build._SIGNATURES))}, "
        f"bound but undefined: {sorted(set(_build._SIGNATURES) - entry_points)}")
    # the error-string helper is the one other export, bound by kernels()
    assert defs["mcl_cuda_error_string"] == ("const char*", ["int err"])


def test_sources_and_headers_exist():
    """Every file the build compiles or hashes is in csrc/, and every
    source there is compiled."""
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file(), name
    assert {p.name for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == set(_build.HEADERS)
