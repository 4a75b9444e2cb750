"""The four mesh engines through `run_cross_validation` on CPU process
grids (ranks as `gloo` subprocesses, tests/torch_mesh_worker.py):
dense (2, 1) with the folds one after another, block (1, 2), device COO
(2, 2) and host COO (2, 1), 2 folds x 2 epochs each. Every run's results
are finite, rank 0 alone writes, the replicas' parameters are bitwise
equal, and with dropout 0 the rows are the port's single-process run's
within rtol 3e-4 / atol 2e-6; a crash and `--resume` at (2, 1) gives the
uninterrupted run's bits. (The halo engine's runs are in
tests/test_torch_halo.py, fold-sharded lockstep's in
tests/test_torch_fold_shard.py.) Mirrors tests/test_mesh_engines.py."""

import copy
import dataclasses
import json

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.train import cv
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

DATA = dict(data="MUTAG", graphs=48, seed=5)
BLOCK_DATA = dict(data="DD", graphs=24, seed=5)
RUNS = {  # name: (world, mesh, cfg overrides, data, engine)
    "dense": (2, (2, 1), dict(layout="dense", cv_parallel="sequential",
                              dropout_rate=0.0), DATA, "MeshDenseEngine"),
    "block": (2, (1, 2), dict(data_type="DD", layout="block", dropout_rate=0.0),
              BLOCK_DATA, "MeshBlockEngine"),
    "host_coo": (2, (2, 1), dict(layout="coo", coo_assembly="host", dropout_rate=0.0),
                 DATA, "MeshCooEngine"),
    "device_coo": (4, (2, 2), dict(layout="coo", dropout_rate=0.0), DATA,
                   "MeshDeviceCooEngine"),
    # dropout on: every graph rank of a data group must draw its data rank's masks
    "device_coo_dropout": (4, (2, 2), dict(layout="coo"), DATA, "MeshDeviceCooEngine"),
    "dense_ckpt": (2, (2, 1), dict(layout="dense", cv_parallel="sequential",
                                   max_fused_epochs=1, checkpoint_every=1), DATA,
                   "MeshDenseEngine"),
}
CRASH = dict(world=2, mesh=(2, 1), cfg=RUNS["dense_ckpt"][2], crash_at=2)


def _cfg(root, name, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=2, num_folds=2,
                data_root=str(root / "data"), epochs_dir=str(root / name / "epochs"),
                statistics_dir=str(root / name / "statistics"), node_pad_multiple=64,
                edge_pad_multiple=128, graph_pad_multiple=4)
    base.update(kw)
    return base


def _job(root, name, mesh, over, data, **extra):
    cfg = _cfg(root, name, mesh_shape=list(mesh), **over)
    return {"name": name, "kind": "cv", **data, "cfg": cfg, **extra}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{run name: [each rank's results]}; the runs of one world size share
    one grid of processes."""
    root = tmp_path_factory.mktemp("mesh_cv")
    out = {"root": root}
    for world in (2, 4):
        jobs = [_job(root, name, mesh, over, data)
                for name, (w, mesh, over, data, _) in RUNS.items() if w == world]
        if world == 2:
            jobs.append(_job(root, "crash", CRASH["mesh"], CRASH["cfg"], DATA,
                             crash_at=CRASH["crash_at"]))
            jobs.append({"name": "mismatch", "kind": "mismatch", "mesh": [1, 4]})
        results = torch_mesh_worker.spawn(tmp_path_factory.mktemp(f"world{world}"),
                                          world, jobs)
        for job in jobs:
            name = job["name"]
            out[name] = [{k[len(name) + 1:]: v for k, v in r.items()
                          if k.startswith(name + "/")} for r in results]
    return out


def _single(root, name, over, data):
    """The same run on one process, the port's single-device engine."""
    kw = {k: v for k, v in _cfg(root, "single_" + name, **over).items()}
    gs = synthesize_tu_dataset(data["data"], num_graphs=data["graphs"], seed=data["seed"])
    rows = {}
    orig = cv.run_fold

    def run_fold(*a, **k):
        m = orig(*a, **k)
        rows[a[3]] = np.stack([m.rows[c] for c in ("train_loss", "test_loss")], axis=1)
        return m

    cv.run_fold = run_fold
    try:
        res = cv.run_cross_validation(Config(**kw), dataset=gs, device="cpu")
    finally:
        cv.run_fold = orig
    return res, rows


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_run_is_finite_through_its_engine(grids, name):
    world, mesh, _, _, engine = RUNS[name]
    ranks = grids[name]
    assert len(ranks) == world
    for res in ranks:
        assert res["test_accuracies"].shape == (2,)
        assert np.isfinite(res["test_accuracies"]).all()
        for fold in (1, 2):
            assert str(res[f"fold{fold}/engine"]) == engine
            assert np.isfinite(res[f"fold{fold}/rows"]).all()


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_0_alone_writes(grids, name):
    ranks = grids[name]
    assert int(ranks[0]["writes"]) > 0
    assert [int(r["writes"]) for r in ranks[1:]] == [0] * (len(ranks) - 1)
    stats = grids["root"] / name / "statistics"
    assert (stats / "MUTAG_results_overall.csv").exists() or (
        stats / "DD_results_overall.csv").exists()
    events = next(stats.glob("*_events.jsonl")).read_text().splitlines()
    start = json.loads(events[0])
    assert start["kind"] == "run_start" and start["graphs"] is False
    assert start["mesh_shape"] == list(RUNS[name][1])


@pytest.mark.parametrize("name", list(RUNS))
def test_replicas_are_bitwise_equal(grids, name):
    ranks = grids[name]
    for fold in (1, 2):
        keys = [k for k in ranks[0] if k.startswith(f"fold{fold}/param/")]
        assert keys
        for res in ranks[1:]:
            for k in keys:
                np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)
            np.testing.assert_array_equal(res[f"fold{fold}/rows"],
                                          ranks[0][f"fold{fold}/rows"])


@pytest.mark.parametrize("name", ["dense", "block", "host_coo", "device_coo"])
def test_dropout_0_rows_match_the_single_process_run(grids, tmp_path, name):
    _, _, over, data, _ = RUNS[name]
    over = {**over, "cv_parallel": "sequential"}
    res, rows = _single(tmp_path, name, over, data)
    mesh = grids[name][0]
    np.testing.assert_array_equal(mesh["test_accuracies"], res["test_accuracies"])
    np.testing.assert_array_equal(mesh["train_accuracies"], res["train_accuracies"])
    for fold in (1, 2):
        got = mesh[f"fold{fold}/rows"][:, :2]  # the last chunk: both epochs
        np.testing.assert_allclose(got, rows[fold][-len(got):], rtol=3e-4, atol=2e-6,
                                   err_msg=f"{name} fold {fold}")


def test_crash_and_resume_give_the_uninterrupted_runs_bits(grids):
    root = grids["root"]
    crashed, whole = grids["crash"], grids["dense_ckpt"]
    for r, (a, b) in enumerate(zip(crashed, whole)):
        assert int(a["crashed"]) == 1
        for k in [k for k in b if k.startswith("fold") or k.endswith("accuracies")]:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r} {k}")
    for fold in (1, 2):
        assert ((root / "crash" / "statistics" / f"MUTAG_results_{fold}.csv").read_text()
                == (root / "dense_ckpt" / "statistics" /
                    f"MUTAG_results_{fold}.csv").read_text())
    assert not list((root / "crash" / "epochs").glob("*inflight*"))


def test_a_grid_of_another_size_than_the_world_raises(grids):
    for res in grids["mismatch"]:
        assert "needs exactly 4 ranks, the process group has 2" in str(res["error"])


# -- refusals, in process -----------------------------------------------------


def _cpu_cfg(tmp_path, **kw):
    return Config(**_cfg(tmp_path, "refused", **kw))


def test_multi_tile_with_a_mesh_is_a_value_error(tmp_path):
    gs = synthesize_tu_dataset("MUTAG", num_graphs=24, seed=1)
    cfg = _cpu_cfg(tmp_path, mesh_shape=(1, 2), layout="multi", cv_parallel="sequential")
    with pytest.raises(ValueError, match="single-chip only"):
        cv.make_engine(cfg, gs, torch.device("cpu"), "multi", grid=object())


def test_a_mesh_without_a_process_group_says_how_to_launch(tmp_path):
    gs = synthesize_tu_dataset("MUTAG", num_graphs=24, seed=1)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node"):
        cv.run_cross_validation(_cpu_cfg(tmp_path, mesh_shape=(1, 2), layout="coo"),
                                dataset=gs, device="cpu")


@pytest.mark.parametrize("layout,assembly,want", [
    ("dense", "device", "MeshDenseEngine"), ("block", "device", "MeshBlockEngine"),
    ("coo", "device", "MeshDeviceCooEngine"), ("coo", "host", "MeshCooEngine")])
def test_make_engine_picks_the_references_mesh_engine(tmp_path, layout, assembly, want):
    """With a one-rank grid standing in (no process group: nothing to sum)."""
    from dgcnn_tpu_torch.parallel.mesh import ProcessGrid

    gs = synthesize_tu_dataset("DD" if layout == "block" else "MUTAG", num_graphs=12,
                               seed=1)
    cfg = dataclasses.replace(_cpu_cfg(tmp_path, mesh_shape=(1, 2), layout=layout,
                                       coo_assembly=assembly, spmm_impl="pallas"))
    grid = ProcessGrid((1, 2), 0, torch.device("cpu"))
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), layout, grid=grid)
    assert type(engine).__name__ == want and engine.slots == 16
    assert engine.grid is grid


def _smoke_ranks(kernel="gcn_trunk"):
    """Two ranks' results of one chip_smoke phase 4j run, as its children
    write them, every check passing."""
    launches = {k: [0, 0, 0, 0] for k in ("gcn_trunk", "block_csr", "spmm_rows")}
    launches[kernel] = [332, 296, 0, 0]
    run = {"folds": {"1": ["aa", [[0.7, 0.6, 30.0, 5.0]]],
                     "2": ["bb", [[0.6, 0.6, 31.0, 4.0]]]},
           "launches": launches, "wall_s": 2.0}
    out = []
    for r in range(2):
        res = {"engine": "MeshDenseEngine", "slots": 25, "det": {"mesh": [0.6905, 27.0]},
               "want_launches": [332, 296, 0, 0], "grad": {"digest": "dd"},
               "epoch": {"mesh": [0.69, 0.68, 1800.0, 200.0], "digest": "cc"},
               "runs": [dict(copy.deepcopy(run), epoch_s=[[1, 1, 0.7]] if r == 0 else None),
                        dict(copy.deepcopy(run), epoch_s=None)]}
        if r == 0:
            res["det"]["single"] = [0.6905000001, 27.0]
            res["epoch"].update(single=[0.69, 0.68, 1800.0, 200.0], params_worst_rel=1e-6)
            res["grad"].update(worst_rel=3e-6, beyond=[])
        out.append({"rank": r, "runs": {"NCI1 dense": res}})
    return out


@pytest.mark.parametrize("fault", [None, "loss", "correct", "epoch", "params", "grad",
                                   "grad_replica", "replica", "rerun", "no_launch",
                                   "extra_launch", "other_kernel"])
def test_chip_smokes_mesh_checks_catch_what_they_should(fault):
    """chip_smoke.py phase 4j's checks (`check_mesh_run`) on results that
    pass, and on each fault it is there to catch."""
    import chip_smoke as cs

    ranks = _smoke_ranks()
    r0, r1 = (r["runs"]["NCI1 dense"] for r in ranks)
    if fault == "loss":
        r0["det"]["single"][0] = 0.6905 * (1 + 2e-5)
    elif fault == "correct":
        r0["det"]["single"][1] = 26.0
    elif fault == "epoch":
        r0["epoch"]["single"][0] = 0.69 * (1 + 1e-3)
    elif fault == "params":  # the rows agree, the parameters do not
        r0["epoch"]["params_worst_rel"] = 4e-4
    elif fault == "grad":
        r0["grad"]["beyond"] = ["gcn.0.w"]
    elif fault == "grad_replica":
        r1["grad"]["digest"] = "de"
    elif fault == "replica":
        r1["runs"][0]["folds"]["2"][0] = "bd"
    elif fault == "rerun":
        for r in (r0, r1):
            r["runs"][1]["folds"]["1"] = ["ab", r["runs"][1]["folds"]["1"][1]]
    elif fault == "no_launch":
        for r in (r0, r1):
            r["runs"][0]["launches"]["gcn_trunk"][1] = 0
    elif fault == "extra_launch":
        for r in (r0, r1):
            r["runs"][0]["launches"]["gcn_trunk"][0] = 333
    elif fault == "other_kernel":
        for r in (r0, r1):
            r["runs"][0]["launches"]["spmm_rows"][0] = 4
    if fault is None:
        got = cs.check_mesh_run("NCI1 dense", (2, 1), "gcn_trunk", ranks)
        assert got["launches_per_rank"] == [[332, 296, 0, 0]] * 2
        assert got["epoch_s"] == [0.7]
    else:
        with pytest.raises(AssertionError):
            cs.check_mesh_run("NCI1 dense", (2, 1), "gcn_trunk", ranks)


def _smoke_4k_ranks():
    """Two ranks' results of chip_smoke phase 4k's halo and fold-sharded
    runs, as its children write them, every check passing."""
    zero = [0, 0, 0, 0]
    out = []
    for r in range(2):
        halo = {"engine": "MeshHaloEngine", "spmm_impl": "xla", "bucket": [64, 512, 8, 64],
                "shard": {}, "want_launches": [96, 64, 24, 16],
                "det": {"mesh": [0.69, 30.0]}, "grad": {"digest": "aa"},
                "run": {"folds": {"1": ["p1", [[0.7]]], "2": ["p2", [[0.6]]]},
                        "launches": {"spmm_rows": [96, 64, 24, 16],
                                     "gcn_trunk": zero, "block_csr": zero},
                        "epoch_s": [[1, 1, 0.5], [1, 2, 0.4]] if r == 0 else None}}
        folds = {"mesh": {"test": [70.0, 80.0], "launches": {
            "gcn_trunk": [40, 30, 0, 0], "block_csr": zero, "spmm_rows": zero}}}
        if r == 0:
            halo["det"]["single"] = [0.69000001, 30.0]
            halo["grad"].update(worst_rel=1e-6, beyond=[])
            folds.update(lockstep=True, fold_shards=2, layout="dense",
                         engine="DenseEngine", rows=[[[0.7, 0.6, 50.0, 70.0, 1.0]]] * 2,
                         one_rows=[[[0.7, 0.6, 50.0, 70.0, 1.0]]] * 2,
                         epoch_s=[[1, 1, 0.2], [1, 2, 0.01]],
                         one_epoch_s=[[1, 1, 0.3], [1, 2, 0.02]],
                         one={"test": [70.0, 80.0], "launches": {
                             "gcn_trunk": [40, 30, 0, 0], "block_csr": zero,
                             "spmm_rows": zero}})
        out.append({"rank": r, "halo": {"DD halo": halo}, "folds": {"NCI1 fs": folds}})
    return out


@pytest.mark.parametrize("fault", [None, "loss", "grad", "grad_replica", "replica",
                                   "halo_launch", "other_kernel", "rows", "accuracy",
                                   "fold_launch", "not_sharded"])
def test_chip_smokes_halo_and_fold_checks_catch_what_they_should(fault):
    """chip_smoke.py phase 4k's checks (`check_halo_run`, `check_fold_run`)
    on results that pass, and on each fault they are there to catch."""
    import chip_smoke as cs

    ranks = _smoke_4k_ranks()
    h0, h1 = (r["halo"]["DD halo"] for r in ranks)
    f0, f1 = (r["folds"]["NCI1 fs"] for r in ranks)
    if fault == "loss":
        h0["det"]["single"][0] = 0.69 * (1 + 3e-4)
    elif fault == "grad":
        h0["grad"]["beyond"] = ["gcn.0.w"]
    elif fault == "grad_replica":
        h1["grad"]["digest"] = "ab"
    elif fault == "replica":
        h1["run"]["folds"]["2"][0] = "p3"
    elif fault == "halo_launch":
        for h in (h0, h1):
            h["run"]["launches"]["spmm_rows"][1] = 63
    elif fault == "other_kernel":
        h1["run"]["launches"]["block_csr"][0] = 1
    elif fault == "rows":
        f0["rows"] = [[[0.7 * (1 + 2e-3), 0.6, 50.0, 70.0, 1.0]]] * 2
    elif fault == "accuracy":
        f1["mesh"]["test"] = [70.0, 90.0]
    elif fault == "fold_launch":
        f1["mesh"]["launches"]["gcn_trunk"][0] = 39
    elif fault == "not_sharded":
        f0["lockstep"] = False
    halo = lambda: cs.check_halo_run("DD halo", (1, 2), "spmm_rows", ranks)  # noqa: E731
    fold = lambda: cs.check_fold_run("NCI1 fs", (2, 1), "gcn_trunk", ranks)  # noqa: E731
    if fault is None:
        assert halo()["launches_per_rank"] == [[96, 64, 24, 16]] * 2
        got = fold()
        assert got["launches_per_rank"] == [[40, 30, 0, 0]] * 2 and got["bitwise"]
    else:
        with pytest.raises(AssertionError):
            halo()
            fold()
