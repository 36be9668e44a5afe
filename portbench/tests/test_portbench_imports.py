"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the program, and
nothing reads the old benchmarks' folder."""

from __future__ import annotations

import ast
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "_cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_anywhere(path):
    bad = {"jax", "jaxlib", "flax", "source_tpu"}
    assert not set(_imports(path)) & bad


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "source_tpu_torch" not in set(_imports(path))
    for mod in _imports(path):
        if mod == "portbench":  # only the reference's own modules
            text = path.read_text()
            assert "from portbench." not in text.replace(
                "from portbench.reference", "")


RUN = [p for p in FILES if "tests" not in p.relative_to(harness.HERE).parts]


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_nothing_reads_the_old_benchmarks(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""])
            assert not any(m.split(".", 1)[0] == "benchmarks" for m in mods)


def test_guard_compares_whole_top_level_names(monkeypatch):
    import source_tpu_torch  # noqa: F401  (its name begins with source_tpu)
    monkeypatch.setitem(sys.modules, "source_tpu_x.y", object())
    assert "source_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()
