"""The accepted cells read what they read before the harness took a model
family and a dropout-row map for every layout: at a small size on the
CPU, each cell's inputs (graphs, folds, weights, dropout seeds), the row
map of every fold it checks and the work count of every fold are pinned
to digests taken with the harness as it stood before (its `_rows_for`,
`work.fold_epoch`, `inputs.make_inputs`). A sequential cell's maps are
taken after a fixed log of chunks, as a window would leave it."""

import hashlib
import types

import numpy as np
import pytest
import torch

from benchmark import drive, family, harness, inputs
from benchmark.inputs import make_inputs
from benchmark.tests import faults

SEED = 2147483777
# digests of (inputs, row maps, fold-epoch work) and the (layout, lockstep)
# each cell resolves to at faults.N_GRAPHS graphs
PINNED = {
    "nci1-lockstep": ("dense", True, "51f91e6bd7eea6d6", "e45b4fac4b4b8114",
                      "9331223d88012c24"),
    "collab-folds": ("multi", False, "c8e567237beaeccd", "b312e68913848024",
                     "4a2b2f597e9b6025"),
    "nci1-lockstep-4card": ("dense", True, "51f91e6bd7eea6d6", "e45b4fac4b4b8114",
                            "9331223d88012c24"),
    "nci1-folds": ("dense", False, "51f91e6bd7eea6d6", "3d7a65614affcfd0",
                   "9331223d88012c24"),
}
# the chunks a sequential window ran, as drive.Sequential.log holds them
LOG = [(0, 0), (0, 1), (0, 1), (0, 1), (0, 25), (0, 25), (0, 25), (0, 22),
       (1, 0), (1, 25), (1, 25), (1, 25), (1, 25)]


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, torch.Tensor):
            p = p.detach().cpu().numpy()
        if isinstance(p, np.ndarray):
            h.update(str(p.dtype).encode() + str(p.shape).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:16]


def checked_folds(lockstep: bool, num_folds: int) -> list:
    """(su, fold) of every fold the cell checks: in lockstep every fold's
    set-up; in sequence fold 1's and three more after LOG's switches."""
    if lockstep:
        return [({"before": [], "folds": list(range(num_folds))}, f)
                for f in range(num_folds)]
    out, log = [({"before": [(0, 0)], "folds": [0]}, 0)], list(LOG)
    for f in (2, 3, 4):
        log = log + [(f, 0)]
        out.append(({"before": list(log), "folds": [f]}, f))
        log = log + [(f, 1)] * 3
    return out


@pytest.mark.parametrize("cell", list(PINNED))
def test_cell_reads_what_it_read(cell):
    layout, lockstep, d_inputs, d_rows, d_work = PINNED[cell]
    with faults.traffic_of(cell):
        cfg, traffic = harness.cell_files(cell)
    inp = make_inputs(cfg, SEED, "cpu", faults.N_GRAPHS)
    g = inp.graphs
    assert digest(*(g[k] for k in ("x", "node_ptr", "edge_src", "edge_dst", "edge_ptr", "y")),
                  g["num_classes"], *(a for tr, te in inp.folds for a in (tr, te)),
                  *(p[n] for p in inp.params for n in p), inp.dropout_seeds) == d_inputs

    from dgcnn_tpu_torch.train import cv

    pcfg = drive.program_config(cfg, traffic, SEED)
    ds = drive.graph_set(inp)
    prog = types.SimpleNamespace(pcfg=pcfg, layout=cv.choose_layout(pcfg, ds))
    prog.lockstep = cv.lockstep_engages(pcfg, ds, prog.layout)
    assert (prog.layout, prog.lockstep) == (layout, lockstep)
    maps = []
    for su, f in checked_folds(lockstep, pcfg.num_folds):
        rows = harness._rows_for(prog, inp, su, f)
        got = []
        for e, ids in enumerate(inp.epoch_ids(f, 3)):
            for s in range(0, len(ids), pcfg.batch_size):
                r, total = rows(e, ids[s:s + pcfg.batch_size])
                got.append((np.asarray(r).tolist(), int(total)))
        maps.append(digest(got))
    assert digest(maps) == d_rows

    work = family.of(cfg).work
    counts = [work.fold_epoch(g, cfg["model"], tr, te) for tr, te in inp.folds]
    assert digest([[c[k] for k in ("trunk_ops", "trunk_bytes", "model_flops")]
                   for c in counts]) == d_work


def test_unknown_family_fails_at_load(monkeypatch):
    load = inputs.load_json

    def load_json(*parts):
        cfg = load(*parts)
        return {**cfg, "model": {**cfg["model"], "family": "no_such_family"}}

    monkeypatch.setattr(inputs, "load_json", load_json)
    with pytest.raises(ValueError, match=r"benchmark\.reference\.no_such_family"):
        inputs.load_config("dgcnn-nci1")
