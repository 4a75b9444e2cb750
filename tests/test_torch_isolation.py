"""The port stands alone: no module of dgcnn_tpu_torch, nor chip_smoke.py,
imports jax, optax or anything of the dgcnn_tpu package."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "dgcnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "dgcnn_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden_imports(src):
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            # top-level package only: "dgcnn_tpu_torch" is not "dgcnn_tpu"
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{node.lineno}: {name}")
    return bad


def test_forbidden_import_scan_catches_what_it_should():
    src = ("import dgcnn_tpu_torch.config\nfrom dgcnn_tpu.data import folds\n"
           "import optax as o\nfrom . import loop\nimport jax.numpy\n")
    assert _forbidden_imports(src) == ["2: dgcnn_tpu.data", "3: optax", "5: jax.numpy"]


def test_the_scan_covers_the_probe_and_measurement_modules():
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    assert {"dgcnn_tpu_torch/tools/probe_kernel_anatomy.py",
            "dgcnn_tpu_torch/tools/__init__.py",
            "dgcnn_tpu_torch/utils/profiling.py", "chip_smoke.py",
            "dgcnn_tpu_torch/infer.py", "dgcnn_tpu_torch/train/plots.py",
            "dgcnn_tpu_torch/train/tensorboard.py",
            "dgcnn_tpu_torch/utils/checkpoint.py", "dgcnn_tpu_torch/native/__init__.py",
            "dgcnn_tpu_torch/parity/harness.py", "dgcnn_tpu_torch/parity/torch_oracle.py",
            "dgcnn_tpu_torch/graft_entry.py",
            "dgcnn_tpu_torch/tools/probe_epoch_seconds.py",
            "dgcnn_tpu_torch/tools/cpu_pin.py", "dgcnn_tpu_torch/parallel/mesh.py",
            "dgcnn_tpu_torch/parallel/shard.py",
            "dgcnn_tpu_torch/parallel/train_dp.py", "dgcnn_tpu_torch/parallel/halo.py",
            "dgcnn_tpu_torch/batching/shard_pack.py",
            "dgcnn_tpu_torch/tools/probe_collab_drift.py"} <= scanned
    assert {f"dgcnn_tpu_torch/tools/{m}.py" for m in TOOLS} <= scanned


# the ports of tools/ (the port keeps its own copy of each, even of those
# that import no JAX)
TOOLS = ("release_validation", "release_report", "diff_runs", "export_tensorboard",
         "summarize_trace", "pinned_trajectory", "fetch_datasets", "dress_rehearsal")


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_import_nothing_of_the_reference_tools(tool):
    src = (PORT / "tools" / f"{tool}.py").read_text()
    bad = [n for n in ast.walk(ast.parse(src)) if isinstance(n, (ast.Import, ast.ImportFrom))
           and any(name.split(".")[0] == "tools" for name in (
               [a.name for a in n.names] if isinstance(n, ast.Import) else [n.module or ""]))]
    assert bad == [] and "sys.path" not in src


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_reference(path):
    assert _forbidden_imports(path.read_text()) == []


def test_importing_every_port_module_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
