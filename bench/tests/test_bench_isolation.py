"""No module under ``bench/`` imports JAX, Flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is the port,
not ``repro``); the plain references import nothing of the program."""

import ast

import pytest

from bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(spec.BENCH.rglob("*.py"))


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(spec.BENCH)) for p in MODULES])
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


PLAIN = {"__future__", "math", "numpy", "torch"}


@pytest.mark.parametrize(
    "path", sorted((spec.BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    """A reference imports plain libraries and its own folder's helpers,
    nothing of ``repro_torch`` (not even its ``kernels/ref.py``)."""
    assert set(_top_level_imports(path)) <= PLAIN
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1 and node.module == "_plain"


def test_the_run_compares_whole_top_level_names(monkeypatch):
    """What a run checks in ``sys.modules`` after its window."""
    import sys

    from bench import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert run.forbidden_modules() == ["repro"]
