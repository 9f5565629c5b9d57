"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os

import pytest

from bench_lib import cells, guard

FORBIDDEN = {"jax", "jaxlib", "flax", "bayesian_yolov3_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(cells.ROOT, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, cells.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert "bayesian_yolov3_torch" not in set(_imports(path))


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["bayesian_yolov3_torch.ops", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert guard.forbidden_loaded(["bayesian_yolov3_tpu.ops.nms", "jaxlib"]) == [
        "bayesian_yolov3_tpu", "jaxlib"]
