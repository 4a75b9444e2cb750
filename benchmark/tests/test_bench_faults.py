"""The harness with the timed path broken underneath: on the CPU, at a
small size, each fault a cell can have makes `correct` come out false,
and the unbroken program makes it true."""

import multiprocessing
import os

import pytest

from benchmark.inputs import make_inputs
from benchmark.tests import faults

ONE_CARD = [("nci1-lockstep", f) for f in ("none", "unchanged", "half", "train_half",
                                            "answer")]
ONE_CARD += [(c, f) for c in ("nci1-folds", "collab-folds")
             for f in ("none", "unchanged", "half", "answer", "stale_test")]
ONE_CARD += [("collab-folds", "train_half")]
ONE_CARD += [("dd-coo", f) for f in ("none", "unchanged", "half", "train_half", "answer",
                                     "stale_test")]


@pytest.mark.parametrize("cell,fault", ONE_CARD)
def test_one_card(cell, fault):
    from benchmark import harness

    out = faults.run(cell, fault)
    assert out["correct"] is (fault == "none"), out["checks"]
    assert list(out)[-1] == "checks"
    # the cell's end-to-end metrics by BENCHMARK.json, and no others
    assert set(out["metrics"]) == {m["name"] for m in harness.end_to_end_metrics(cell)}


@pytest.mark.parametrize("fault", ["none", "train_half"])
def test_nci1_folds_at_its_own_size(fault):
    """nci1-folds catches training on half of each batch by the weights'
    change over epoch 1 in its best fold (`change_best`), whose limit is
    set from the cell's 74-step epochs: at N_GRAPHS an epoch has four
    steps, so this runs the cell's own 4,110 graphs (about 90 s here)."""
    out = faults.run("nci1-folds", fault, num_graphs=0)
    assert out["correct"] is (fault == "none"), out["checks"]


def test_collab_folds_runs_its_own_path_here():
    """The CPU runs above keep collab-folds on the multi-tile layout, one
    fold after another, and check folds after the window."""
    from benchmark import drive, harness

    with faults.traffic_of("collab-folds"):
        w = harness.workload("collab-folds")
        cfg = harness.load_json("configs", w["config"] + ".json")
        traffic = harness.load_json("traffic", w["traffic"] + ".json")
    inp = make_inputs(cfg, 31, "cpu", faults.N_GRAPHS)
    prog = drive.Program(inp, traffic, "cpu")
    assert (prog.layout, prog.lockstep) == ("multi", False)
    prog.close()


@pytest.mark.parametrize("fault", ["none", "exchange", "train_half"])
def test_four_ranks(fault, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(tmp_path, "store")
    procs = [ctx.Process(target=faults.rank_main,
                         args=("nci1-lockstep-4card", fault, r, 4, store, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=600)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0, 0, 0]
    assert out["correct"] is (fault == "none"), out["checks"]
    assert out["device"]["count"] == 4
