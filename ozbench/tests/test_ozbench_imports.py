"""What the benchmark's files import, read from their syntax trees: nothing
under ozbench/ loads JAX or the JAX package, and the reference loads
nothing of the program.  Each module is compared by its top-level name,
whole, since ``ozimmu_tpu_torch`` begins with ``ozimmu_tpu``."""

import ast
import os

import pytest

from conftest import BENCH_DIR

import run


def _py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).partition(".")[0])
    return names


ALL = sorted(_py_files(BENCH_DIR))


@pytest.mark.parametrize("path", ALL, ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "ozimmu_tpu"}


@pytest.mark.parametrize("path", sorted(_py_files(os.path.join(BENCH_DIR, "reference"))),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert "ozimmu_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "typing", "numpy", "torch"}


def test_the_names_are_compared_whole():
    assert _top_level_imports(os.path.join(BENCH_DIR, "run.py")) >= {"time", "json"}
    assert run.forbidden_modules(["ozimmu_tpu_torch", "ozimmu_tpu_torch.core"]) == []
    assert run.forbidden_modules(["ozimmu_tpu.core.gemm", "jaxlib.xla_client", "numpy"]) == \
        ["jaxlib", "ozimmu_tpu"]
    assert run.forbidden_modules(["jax_fake", "flaxen"]) == []
