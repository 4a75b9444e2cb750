"""The command line: without a card it exits non-zero with one error line
and prints no result; on a card (marker `card`) a small run of a cell
proves correct and reports every end-to-end metric."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CMD = [sys.executable, "-m", "benchmark.run", "--workload", "nci1-lockstep",
       "--seed", "2147483659", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert len(out.stderr.strip().splitlines()) == 1, out.stderr
    assert "CUDA is not available" in out.stderr


def test_unknown_cell_refused():
    out = subprocess.run(CMD[:4] + ["no-such-cell"] + CMD[5:], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell,num_graphs", [("nci1-lockstep", 400), ("dd-coo", 300)])
def test_card_small_run_correct(card, cell, num_graphs):
    from benchmark import control, harness

    r = control.readings(cell, 12345, True, card, num_graphs=num_graphs)
    limits = json.load(open(os.path.join(ROOT, "benchmark", "limits", cell + ".json")))
    assert all(r["program"][k] <= v for k, v in limits.items()), r["program"]
    # the control, the reference with TF32 on in the program's place, fails
    assert any(r["tf32"][k] > v for k, v in limits.items()), r["tf32"]
    assert harness.workload(cell)["chips"] == 1
