"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program. Names are compared as
whole top-level names: the program's own name, `dgcnn_tpu_torch`, begins
with the JAX package's."""

import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "dgcnn_tpu"}


def modules():
    for root, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names |= {a.value.split(".")[0] for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return names


@pytest.mark.parametrize("path", list(modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in modules() if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "dgcnn_tpu_torch" not in names and not names & FORBIDDEN
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert node.module not in ("benchmark.drive", "benchmark.harness"), node.module


def test_whole_name_comparison():
    from benchmark.run import forbidden_modules

    sys.modules.setdefault("dgcnn_tpu_torch_probe_name", sys)
    try:
        assert "dgcnn_tpu" not in forbidden_modules()
    finally:
        del sys.modules["dgcnn_tpu_torch_probe_name"]
    sys.modules["dgcnn_tpu"] = sys
    try:
        assert forbidden_modules() == ["dgcnn_tpu"]
    finally:
        del sys.modules["dgcnn_tpu"]
