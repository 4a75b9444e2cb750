"""The mesh engines' fused runners (parallel/train_dp.py
`graphed_dp_run`, `make_staged_dp_run`; train/cv.py's five mesh engines)
on the CPU: whether a runner captures, chosen from the grid's backend
and device (`ProcessGrid.graphed`), on stand-in grids; the runner's
check of a chunk's orders; and every engine through `run_cross_validation` on 2 `gloo` CPU
ranks (subprocesses of tests/torch_mesh_worker.py), eagerly and on a
stand-in card (the worker's `stand_in_card`: the runners built as under
nccl on the card, each later epoch a replay that runs the captured
body): rows and parameters bitwise equal, one graph a fold replayed
every epoch after the warm-up, the dropout generator registered, and
`run_start` saying `graphs: true`. The four-card tool
(`python -m dgcnn_tpu_torch.tools.mesh_cards`) without CUDA exits non-zero
with one line."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.batching.dense import build_dense_dataset, dense_tile, order_matrix_dp
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.parallel.mesh import ProcessGrid
from dgcnn_tpu_torch.parallel import train_dp
from dgcnn_tpu_torch.parallel.train_dp import make_dense_dp_run
from dgcnn_tpu_torch.train.loop import FusedRun, make_optimizer
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

DATA = dict(data="MUTAG", graphs=48, seed=5)
BLOCK_DATA = dict(data="DD", graphs=24, seed=5)
RUNS = {  # name: (mesh, cfg overrides, data, engine)
    "dense": ((2, 1), dict(layout="dense", cv_parallel="sequential"), DATA,
              "MeshDenseEngine"),
    "block": ((1, 2), dict(data_type="DD", layout="block"), BLOCK_DATA,
              "MeshBlockEngine"),
    "device_coo": ((1, 2), dict(layout="coo"), DATA, "MeshDeviceCooEngine"),
    "host_coo": ((2, 1), dict(layout="coo", coo_assembly="host"), DATA,
                 "MeshCooEngine"),
    "halo": ((1, 2), dict(layout="halo"), DATA, "MeshHaloEngine"),
}
FOLDS, EPOCHS, CHUNK = 2, 4, 2


def _cfg(root, name, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=EPOCHS,
                num_folds=FOLDS, max_fused_epochs=CHUNK, data_root=str(root / "data"),
                epochs_dir=str(root / name / "epochs"),
                statistics_dir=str(root / name / "statistics"), node_pad_multiple=64,
                edge_pad_multiple=128, graph_pad_multiple=4)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{run name: [each rank's results]}, every run on one grid of 2
    processes."""
    root = tmp_path_factory.mktemp("graphed")
    jobs = [{"name": name, "kind": "graphed_cv", **data,
             "cfg": _cfg(root, name, mesh_shape=list(mesh), **over)}
            for name, (mesh, over, data, _) in RUNS.items()]
    jobs.append({"name": "replicas", "kind": "replicas", "mesh": [2, 1]})
    results = torch_mesh_worker.spawn(tmp_path_factory.mktemp("world2"), 2, jobs)
    return {job["name"]: [{k[len(job["name"]) + 1:]: v for k, v in r.items()
                           if k.startswith(job["name"] + "/")} for r in results]
            for job in jobs}


@pytest.mark.parametrize("name", list(RUNS))
def test_graphed_mesh_rows_are_the_eager_runs_bits(grids, name):
    engine = RUNS[name][3]
    for r, res in enumerate(grids[name]):
        for f in range(1, FOLDS + 1):
            assert str(res[f"graphed/fold{f}/engine"]) == engine
            np.testing.assert_array_equal(res[f"graphed/fold{f}/rows"],
                                          res[f"eager/fold{f}/rows"],
                                          err_msg=f"rank {r} fold {f} rows")
            keys = [k for k in res if k.startswith(f"eager/fold{f}/param/")]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(res[k.replace("eager/", "graphed/", 1)],
                                              res[k], err_msg=f"rank {r} {k}")
        # one graph a fold, replayed every epoch after its warm-up, with the
        # rank's dropout generator registered; none in the eager run
        assert res["graphed/replays"].tolist() == [EPOCHS - 1] * FOLDS
        assert res["graphed/dropout_gens"].tolist() == [1] * FOLDS
        assert res["eager/replays"].size == 0
    r0 = grids[name][0]
    assert str(r0["graphed/engine"]) == str(r0["eager/engine"]) == engine
    assert bool(r0["graphed/graphs"]) and not bool(r0["eager/graphs"])


def test_replicas_are_checked_bitwise(grids):
    """`ProcessGrid.check_replicas`, which ends every mesh fold, passes on
    equal tensors and raises on every rank when one rank's bits differ,
    one bit of one element or two elements swapped."""
    for res in grids["replicas"]:
        assert (res["same"], res["one_bit"], res["swapped"]) == (0, 1, 1)


def _grid(device, backend):
    return ProcessGrid((1, 1), 0, torch.device(device), backend=backend)


def _dense_net(gs):
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    return DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model))


@pytest.mark.parametrize("device,backend,graphed", [
    ("cuda", "nccl", True), ("cuda", None, True), ("cuda", "gloo", False),
    ("cpu", "gloo", False), ("cpu", None, False)])
def test_the_runner_is_chosen_by_backend_and_device(monkeypatch, device, backend,
                                                    graphed):
    """A stand-in grid's `graphed` (nccl, or no group, on a CUDA device),
    and the runner the dense DP factory builds on it: a `FusedRun` over
    the static order buffer [steps, n_data, slots], asked to capture where
    the grid is graphed and never when `graphs=False` asks for eager
    epochs."""
    asked = []

    class Recorded(FusedRun):
        def __init__(self, *a, **k):
            asked.append(a[5])
            super().__init__(*a, **k)

    monkeypatch.setattr(train_dp, "FusedRun", Recorded)
    grid = _grid(device, backend)
    assert grid.graphed is graphed
    gs = synthesize_tu_dataset("MUTAG", num_graphs=16, seed=0)
    data = build_dense_dataset(gs, dense_tile(gs), "cpu")
    net = _dense_net(gs)
    test = order_matrix_dp(np.arange(8), 8, 1, 8)
    run = make_dense_dp_run(net, make_optimizer(net), data, grid, test,
                            torch.Generator(), steps=2)
    assert type(run) is Recorded and tuple(run.order.shape) == (2, 1, 8)
    make_dense_dp_run(net, make_optimizer(net), data, grid, test, torch.Generator(),
                      steps=2, graphs=False)
    assert asked == [graphed, False]


def test_a_mesh_runner_checks_each_epochs_orders():
    """The mesh runner takes a chunk's orders [k, steps, n_data, slots]: a
    step is real when any data rank's row holds a graph, every epoch must
    have the runner's real steps, and orders of another shape raise."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=16, seed=0)
    data = build_dense_dataset(gs, dense_tile(gs), "cpu")
    net = _dense_net(gs)
    grid = _grid("cpu", None)
    run = make_dense_dp_run(net, make_optimizer(net), data, grid,
                            order_matrix_dp(np.arange(8), 8, 1, 8), torch.Generator(),
                            steps=2)
    orders = order_matrix_dp(np.arange(16), 8, 1, 8)[None]
    ragged = orders.copy()
    ragged[0, 1, 0, 1:] = -1  # one graph left in step 2: still a real step
    assert np.isfinite(run.run_epochs(ragged)).all()
    empty = orders.copy()
    empty[0, 1] = -1
    with pytest.raises(ValueError, match="real steps"):
        run.run_epochs(empty)
    with pytest.raises(ValueError, match="do not fit"):
        run.run_epochs(orders[:, :1])


def test_mesh_cards_without_cuda_exits_non_zero_with_one_line():
    proc = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.tools.mesh_cards"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0], lines
