"""The block kernels' cost-split probe (dgcnn_tpu_torch/tools/
probe_block_anatomy.py): each variant's copy of csrc/block_tile.cuh takes
out exactly the costs it names (the patches find their lines in the
current item walk, so a changed walk fails here and not on the card), and
the probe refuses to run without CUDA. It times kernels on the card only."""

import json
import os
import subprocess
import sys

import pytest

from dgcnn_tpu_torch.kernels import _build
from dgcnn_tpu_torch.tools import probe_block_anatomy as anat
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tile():
    with open(os.path.join(_build.CSRC, "block_tile.cuh")) as f:
        return f.read()


@pytest.mark.parametrize("name,macs,reloads", [
    ("base", 1, 0), ("no_mac", 0, 0), ("no_reload", 1, 1), ("neither", 0, 1)])
def test_variants_take_out_what_they_name(name, macs, reloads):
    src = anat.variant_source(name, _tile())
    assert src.count(anat._MAC) == macs
    assert src.count(anat._RELOAD[1]) == reloads
    assert (src == _tile()) == (name == "base")


def test_a_walk_without_the_lines_is_refused():
    with pytest.raises(ValueError, match="walk_items"):
        anat.variant_source("no_reload", "nothing to patch")


def test_probe_without_cuda_exits_1_with_an_error_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.tools.probe_block_anatomy"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and "error" in json.loads(lines[0])
