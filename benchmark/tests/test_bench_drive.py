"""`drive.py` makes the calls `run_cross_validation` makes: on the CPU, at
a small size and a short protocol, the engine calls of the program's own
loop and of the benchmark's driver are recorded and compared. Fold 1's
set-up is the one deliberate difference: the driver runs its epochs 1-3
as three one-epoch chunks, then goes on at the loop's chunk lengths."""

import dataclasses

import pytest

from benchmark import drive
from benchmark.inputs import load_json, make_inputs
from benchmark.tests import faults

EPOCHS, FUSED, FOLDS = 6, 2, 3


def _recorded(monkeypatch):
    from dgcnn_tpu_torch.train import cv, cv_vmap

    calls = []
    for engine in (cv.DenseEngine, cv.MultiDenseEngine):
        for name in ("begin_fold", "run_epochs", "end_fold"):
            def wrapped(self, *args, _name=name, _call=getattr(engine, name)):
                k = len(args[3]) if _name == "run_epochs" else None
                calls.append((_name, k) if k is not None else (_name,))
                return _call(self, *args)

            monkeypatch.setattr(engine, name, wrapped)
    chunk = cv_vmap.lockstep_chunk

    def lockstep_chunk(engine, net_f, adam_f, gens, ids_k, *rest):
        calls.append(("lockstep_chunk", len(ids_k)))
        return chunk(engine, net_f, adam_f, gens, ids_k, *rest)

    monkeypatch.setattr(cv_vmap, "lockstep_chunk", lockstep_chunk)
    monkeypatch.setattr(drive, "lockstep_chunk", lockstep_chunk)
    return calls


def _small(cell):
    from benchmark import harness

    with faults.traffic_of(cell):
        w = harness.workload(cell)
        cfg = load_json("configs", w["config"] + ".json")
        traffic = harness.load_json("traffic", w["traffic"] + ".json")
    cfg = {**cfg, "train": {**cfg["train"], "num_epochs": EPOCHS,
                            "max_fused_epochs": FUSED, "num_folds": FOLDS}}
    return make_inputs(cfg, 7, "cpu", faults.N_GRAPHS), traffic


def _loop_calls(inp, traffic, tmp_path, monkeypatch):
    from dgcnn_tpu_torch.train import cv

    calls = _recorded(monkeypatch)
    pcfg = dataclasses.replace(
        drive.program_config(inp.cfg, traffic, inp.seed), statistics_dir=str(tmp_path / "s"),
        epochs_dir=str(tmp_path / "e"), fold_index_dir=str(tmp_path / "f"),
        data_root=str(tmp_path / "d"))
    cv.run_cross_validation(pcfg, dataset=drive.graph_set(inp), device="cpu")
    return list(calls)


def _drive_calls(inp, traffic, monkeypatch):
    calls = _recorded(monkeypatch)
    prog = drive.Program(inp, traffic, "cpu")
    d = prog.driver
    drive.set_up(prog)
    if isinstance(d, drive.Sequential):
        while not (d.fold == FOLDS - 1 and d.at_boundary()):
            d.next_chunk()
    else:
        while d.epoch <= EPOCHS:
            d.next_chunk()
    prog.close()
    return list(calls), prog.lockstep


@pytest.mark.parametrize("cell", ["nci1-lockstep", "nci1-folds", "collab-folds"])
def test_drive_makes_the_loops_calls(cell, tmp_path, monkeypatch):
    inp, traffic = _small(cell)
    with monkeypatch.context() as m:
        loop = _loop_calls(inp, traffic, tmp_path, m)
    ours, lockstep = _drive_calls(inp, traffic, monkeypatch)
    first = [("lockstep_chunk" if lockstep else "run_epochs", 1)] * 3
    if lockstep:
        # the loop: one chunk of FUSED epochs after another; the driver:
        # three one-epoch chunks, then the loop's lengths from epoch 4
        assert loop == [("lockstep_chunk", FUSED)] * (EPOCHS // FUSED) + [("end_fold",)]
        assert ours == first + [("lockstep_chunk", 2), ("lockstep_chunk", 1), ("end_fold",)]
        return
    fold = [("begin_fold",)] + [("run_epochs", FUSED)] * (EPOCHS // FUSED) + [("end_fold",)]
    assert loop == fold * FOLDS
    assert ours == ([("begin_fold",)] + first + [("run_epochs", 2), ("run_epochs", 1),
                                                   ("end_fold",)] + fold * (FOLDS - 1))
