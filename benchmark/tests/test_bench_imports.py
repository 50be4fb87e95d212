"""No module of the benchmark imports JAX or the JAX package, the
reference imports nothing of the program, and nothing reads the
repository's older bench or tools."""
import ast
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "optax", "obia_tpu", "obia"}
PROGRAM = {"obia_tpu_torch", "obia_torch"}


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


def test_no_jax_anywhere():
    for path in _sources():
        bad = set(_tops(path)) & NEVER
        assert not bad, (path, bad)


def test_whole_names_compared():
    # the port's name begins with the JAX package's: it is not a match
    assert "obia_tpu_torch" not in NEVER
    assert "obia_tpu_torch".split(".", 1)[0] != "obia_tpu"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        bad = set(_tops(path)) & PROGRAM
        assert not bad, (path, bad)


def test_no_older_bench_or_tools():
    for path in _sources():
        bad = set(_tops(path)) & {"bench", "chip_smoke", "tools"}
        assert not bad, (path, bad)
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", "") == "open":
                arg = ast.unparse(node.args[0]) if node.args else ""
                assert "tools" not in arg and "bench.py" not in arg, path


def test_run_guard_reads_whole_top_level_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "obia_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= NEVER
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert set(harness.forbidden_modules()) == before | {"jaxlib"}


@pytest.mark.parametrize("name", sorted(NEVER))
def test_guard_names_each(name):
    from benchmark import harness
    assert name in harness.FORBIDDEN
