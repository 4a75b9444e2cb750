"""The edge-stream SpMM kernels' cost-split probe (dgcnn_tpu_torch/tools/
probe_spmm_anatomy.py): each variant's copy of csrc/spmm_rows.cu or
csrc/spmm_edge_block.cu takes out exactly the costs it names (the patches
find their lines in the current kernels, so a changed kernel fails here
and not on the card), and the probe refuses to run without CUDA. It times
kernels on the card only."""

import json
import os
import subprocess
import sys

import pytest

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.tools import probe_spmm_anatomy as anat
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = [(k, v) for k, vs in anat.PATCHES.items() for v in vs]


def _src(kname):
    with open(os.path.join(_build.CSRC, kname + ".cu")) as f:
        return f.read()


@pytest.mark.parametrize("kname,name", VARIANTS)
def test_variants_take_out_what_they_name(kname, name):
    src = _src(kname)
    out = anat.variant_source(kname, name, src)
    assert (out == src) == (name == "base")
    for old, new in anat.PATCHES[kname][name]:
        assert old not in out and new in out


def test_floor_takes_out_every_edge_block_cost():
    floor = set(anat.PATCHES["spmm_edge_block"]["floor"])
    for name in ("no_gather", "no_finish", "no_zero"):
        assert set(anat.PATCHES["spmm_edge_block"][name]) <= floor
    assert floor < set(anat.PATCHES["spmm_edge_block"]["runs_only"])


def test_a_kernel_without_the_lines_is_refused():
    with pytest.raises(ValueError, match="spmm_edge_block.cu"):
        anat.variant_source("spmm_edge_block", "no_finish", "nothing to patch")


def test_probe_without_cuda_exits_1_with_an_error_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.tools.probe_spmm_anatomy"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and "error" in json.loads(lines[0])
