"""A dropout-row map for every engine `make_engine` builds on one card: on
the CPU, at a small size, the harness runs the sound program on each
layout and fold schedule of `harness.ROW_MAPS` (and on both COO engines) and
`correct` comes out true. Dense and multi-tile run on NCI1 and COLLAB,
block-sparse and COO on D&D (`faults.GRAPHS`, `faults.TRAIN`)."""

import dataclasses

import pytest

from benchmark import drive, harness
from benchmark.tests import faults

ONE_CARD = {"mesh": [1, 1]}
# (layout, lockstep, engine) → (cell, traffic[, further Config fields])
CASES = {
    ("dense", False, "DenseEngine"): ("nci1-folds", None),
    ("dense", True, "DenseEngine"): ("nci1-lockstep", None),
    ("multi", False, "MultiDenseEngine"): ("collab-folds", None),
    # NCI1 on tiles from 16: each lockstep chunk grows the slot floors over
    # every fold's batches, where one fold's would leave them (30 of 30
    # fold-epochs differ at seed 31), so the sequential map fails
    ("multi", True, "MultiDenseEngine"): (
        "nci1-lockstep", {"cv_parallel": "folds", "layout": "multi", **ONE_CARD},
        {"multi_dense_min_tile": 16}),
    ("block", False, "BlockSparseEngine"): (
        "dd-coo", {"cv_parallel": "sequential", "layout": "block", **ONE_CARD}),
    ("block", True, "BlockSparseEngine"): (
        "dd-coo", {"cv_parallel": "folds", "layout": "block", **ONE_CARD}),
    ("coo", False, "DeviceCooEngine"): ("dd-coo", None),
    ("coo", False, "CooEngine"): ("dd-coo", None, {"coo_assembly": "host"}),
}


def test_every_map_has_a_case():
    assert {(layout, lockstep) for layout, lockstep, _ in CASES} == set(harness.ROW_MAPS)


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: f"{c[0]}-{c[2]}-"
                         + ("lockstep" if c[1] else "sequential"))
def test_correct_on_every_layout(case, monkeypatch):
    cell, traffic, *fields = CASES[case]
    seen = []
    rows_maps, program_config = harness.rows_maps, drive.program_config

    def spy(prog, inp, sus):
        seen.append((prog.layout, prog.lockstep, type(prog.engine).__name__))
        return rows_maps(prog, inp, sus)

    def config(*args):
        return dataclasses.replace(program_config(*args), **(fields[0] if fields else {}))

    monkeypatch.setattr(harness, "rows_maps", spy)
    monkeypatch.setattr(drive, "program_config", config)
    out = faults.run(cell, "none", traffic=traffic)
    assert seen == [case]
    assert out["correct"] is True, out["checks"]
