"""Fold-sharded lockstep of the port (train/cv_vmap.py `fold_block`,
`gather_folds`, `run_cv_folds_lockstep(grid=...)`) on CPU process grids
(ranks as `gloo` subprocesses, tests/torch_mesh_worker.py): each rank of
a (D, 1) grid trains its contiguous block of the padded fold axis in
lockstep, and rank 0 writes every real fold's artifacts. With dropout 0
and the JAX package's initial weights, the rows match JAX's fold-sharded
`run_cross_validation` on conftest's virtual CPU mesh (dense and block on
(2, 1), 3 folds on (2, 1)); every run matches the port's own one-device
lockstep (rows within 5e-4, accuracies equal); D ∤ K leaves no pad-fold
rows or files; a rank with no fold joins the collectives; `auto` runs
dense, block and multi-tile lockstep over the grid; crash and resume
give the uninterrupted run's bits; and the reference's ValueErrors.
Mirrors tests/test_cv_vmap.py's sharded cases."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JConfig
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jinit
from dgcnn_tpu.train.cv import run_cross_validation as jrun_cv
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.parallel.mesh import ProcessGrid
from dgcnn_tpu_torch.parity.convert import params_from_jax
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.cv_vmap import fold_block
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

DATA = dict(data="MUTAG", graphs=48, seed=5)
DD = dict(data="DD", graphs=20, seed=5)
RUNS = {  # name: (world, mesh, cfg overrides, data, JAX init)
    "dense": (2, (2, 1), dict(cv_parallel="folds", layout="dense", dropout_rate=0.0),
              DATA, True),
    "block": (2, (2, 1), dict(cv_parallel="folds", layout="block", dropout_rate=0.0),
              DATA, True),
    "padded": (2, (2, 1), dict(cv_parallel="folds", layout="dense", num_folds=3,
                               dropout_rate=0.0), DATA, True),
    "auto_dense": (2, (2, 1), dict(), DATA, False),
    "auto_block": (2, (2, 1), dict(data_type="DD", layout="block", batch_size=8), DD,
                   False),
    "auto_multi": (2, (2, 1), dict(layout="multi", multi_dense_min_tile=16), DATA, False),
    "idle": (4, (4, 1), dict(cv_parallel="folds", layout="dense", num_folds=3), DATA,
             False),
    "ckpt": (2, (2, 1), dict(max_fused_epochs=1, checkpoint_every=1, num_folds=3), DATA,
             False),
}
JAX_RUNS = ("dense", "block", "padded")
CRASH = dict(world=2, cfg=RUNS["ckpt"][2], crash_at=2)


@functools.lru_cache(maxsize=None)
def _gs(data, graphs, seed):
    return synthesize_tu_dataset(data, num_graphs=graphs, seed=seed)


def _cfg(root, name, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=2, num_folds=2,
                data_root=str(root / "data"), epochs_dir=str(root / name / "epochs"),
                statistics_dir=str(root / name / "statistics"), graph_pad_multiple=4)
    base.update(kw)
    return base


def _jax_init(spec, cfg):
    """The JAX lockstep driver's initial weights of folds 1..K as port
    states stacked on a fold axis (cv_vmap `_init_all`)."""
    gs = _gs(**spec)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    per_fold = []
    for f in range(1, cfg["num_folds"] + 1):
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(cfg.get("seed", 324)),
                                                  f))[0]
        per_fold.append({k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray, jinit(key, jm))).items()})
    return {k: np.stack([p[k] for p in per_fold]) for k in per_fold[0]}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    root = tmp_path_factory.mktemp("fold_shard")
    jobs = {2: [], 4: []}
    for name, (world, mesh, over, data, jinit_) in RUNS.items():
        cfg = _cfg(root, name, mesh_shape=list(mesh), **over)
        job = {"name": name, "kind": "cv", **data, "cfg": cfg}
        if jinit_:
            path = root / f"{name}_init.npz"
            np.savez(path, **_jax_init(data, cfg))
            job["init"] = str(path)
        jobs[world].append(job)
    jobs[2].append({"name": "crash", "kind": "cv", **DATA, "crash_at": CRASH["crash_at"],
                    "cfg": _cfg(root, "crash", mesh_shape=[2, 1], **CRASH["cfg"])})
    jobs[2].append({"name": "cli", "kind": "cli", "argv": [
        "--data_type", "NCI1", "--synthetic", "--mesh", "2,1", "--platform", "cpu",
        "--num_folds", "2", "--num_epochs", "1", "--data_root", str(root / "data"),
        "--out_root", str(root / "cli")]})
    out = {"root": root}
    for world, js in jobs.items():
        results = torch_mesh_worker.spawn(tmp_path_factory.mktemp(f"world{world}"), world,
                                          js, timeout=600.0)
        for job in js:
            name = job["name"]
            out[name] = [{k[len(name) + 1:]: v for k, v in r.items()
                          if k.startswith(name + "/")} for r in results]
    return out


def _rows(stats, data_type, fold):
    return np.loadtxt(stats / f"{data_type}_results_{fold}.csv", delimiter=",",
                      skiprows=1, ndmin=2)


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


def _one_device(tmp_path, name, monkeypatch):
    """The same run on one process, the port's single-device lockstep (from
    the JAX initial weights where the grid run took them)."""
    from dgcnn_tpu_torch.parity.convert import state_to_params
    from dgcnn_tpu_torch.train import cv_vmap

    _, _, over, data, jinit_ = RUNS[name]
    kw = _cfg(tmp_path, "one_" + name, **over)
    if jinit_:
        stacked = {k: torch.from_numpy(v) for k, v in _jax_init(data, kw).items()}
        by_seed = {cv._stream_seed(324, f + 1, 1): f for f in range(kw["num_folds"])}
        real = cv_vmap.init_params
        monkeypatch.setattr(cv_vmap, "init_params", lambda gen, model, device="cpu": (
            state_to_params({k: v[by_seed[gen.initial_seed()]] for k, v in stacked.items()})
            if gen.initial_seed() in by_seed else real(gen, model, device)))
    res = cv.run_cross_validation(Config(**kw), dataset=_gs(**data), device="cpu")
    return res, tmp_path / ("one_" + name) / "statistics"


def test_fold_block_pads_the_fold_axis_as_the_reference():
    def blocks(k, d):
        return [fold_block(k, ProcessGrid((d, 1), r, torch.device("cpu")))
                for r in range(d)]

    assert blocks(10, 2) == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    assert blocks(3, 2) == [[0, 1], [2]]
    assert blocks(10, 8) == [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [], [], []]
    assert blocks(10, 4) == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert fold_block(4) == [0, 1, 2, 3]


@pytest.mark.parametrize("name", list(RUNS))
def test_fold_sharded_run_is_finite_and_rank_0_alone_writes(grids, name):
    world, mesh, over, data, _ = RUNS[name]
    ranks = grids[name]
    k = over.get("num_folds", 2)
    for res in ranks:  # every rank holds every fold's gathered result
        assert res["test_accuracies"].shape == (k,)
        assert np.isfinite(res["test_accuracies"]).all()
        np.testing.assert_array_equal(res["test_accuracies"], ranks[0]["test_accuracies"])
    assert int(ranks[0]["writes"]) > 0
    assert [int(r["writes"]) for r in ranks[1:]] == [0] * (world - 1)
    stats = grids["root"] / name / "statistics"
    ds = over.get("data_type", "MUTAG")
    events = [json.loads(ln) for ln in
              (stats / f"{ds}_events.jsonl").read_text().splitlines()]
    start = events[0]
    assert start["mesh_shape"] == list(mesh) and start["fold_shards"] == mesh[0]
    assert start["engine"] in ("DenseEngine", "BlockSparseEngine", "MultiDenseEngine")
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert sorted({e["fold"] for e in epochs}) == list(range(1, k + 1))
    assert all(e["folds_in_lockstep"] == k for e in epochs)
    for f in range(1, k + 1):  # global fold ids, no pad fold
        assert _rows(stats, ds, f).shape == (2, 5)
        assert (grids["root"] / name / "epochs" / f"{ds}_{f}.npz").exists()
    assert not (stats / f"{ds}_results_{k + 1}.csv").exists()
    assert not list((grids["root"] / name / "epochs").glob("*inflight*"))


@pytest.mark.parametrize("name", ["dense", "block", "padded", "auto_dense",
                                  "auto_block", "auto_multi", "idle"])
def test_fold_sharded_rows_match_one_device_lockstep(grids, tmp_path, monkeypatch, name):
    """Each fold's rows within the lockstep contract (5e-4) of the port's
    one-device lockstep run, the accuracies equal."""
    res, stats = _one_device(tmp_path, name, monkeypatch)
    mesh = grids[name][0]
    np.testing.assert_array_equal(mesh["test_accuracies"], res["test_accuracies"])
    np.testing.assert_array_equal(mesh["train_accuracies"], res["train_accuracies"])
    ds = RUNS[name][2].get("data_type", "MUTAG")
    for f in range(1, len(res["test_accuracies"]) + 1):
        np.testing.assert_allclose(_rows(grids["root"] / name / "statistics", ds, f),
                                   _rows(stats, ds, f), rtol=5e-4, atol=5e-4,
                                   err_msg=f"{name} fold {f}")


@pytest.mark.parametrize("name", JAX_RUNS)
def test_fold_sharded_rows_match_jax(grids, tmp_path, name):
    """At dropout 0 from the same initial weights, each fold's rows within
    5e-4 of the JAX package's fold-sharded run on the same (2, 1) mesh (3
    folds: the reference pads a masked fold, the port drops it)."""
    _, mesh, over, data, _ = RUNS[name]
    kw = _cfg(tmp_path, "jax_" + name, mesh_shape=tuple(mesh), **over)
    want = jrun_cv(JConfig(**kw), dataset=_jset(_gs(**data)))
    got = grids[name][0]
    np.testing.assert_allclose(got["test_accuracies"], want["test_accuracies"])
    for f in range(1, kw["num_folds"] + 1):
        np.testing.assert_allclose(
            _rows(grids["root"] / name / "statistics", "MUTAG", f),
            _rows(tmp_path / ("jax_" + name) / "statistics", "MUTAG", f),
            rtol=5e-4, atol=5e-4, err_msg=f"{name} fold {f}")


def test_fold_sharded_crash_and_resume_give_the_uninterrupted_runs_bits(grids):
    from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint

    root = grids["root"]
    for r, (a, b) in enumerate(zip(grids["crash"], grids["ckpt"])):
        assert int(a["crashed"]) == 1
        for k in ("test_accuracies", "train_accuracies"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r} {k}")
    for fold in (1, 2, 3):
        assert ((root / "crash" / "statistics" / f"MUTAG_results_{fold}.csv").read_text()
                == (root / "ckpt" / "statistics" / f"MUTAG_results_{fold}.csv").read_text())
        a = load_checkpoint(str(root / "crash" / "epochs" / f"MUTAG_{fold}"))
        b = load_checkpoint(str(root / "ckpt" / "epochs" / f"MUTAG_{fold}"))
        for k, v in b["params"].items():
            np.testing.assert_array_equal(a["params"][k], v, err_msg=f"fold {fold} {k}")
    assert not list((root / "crash" / "epochs").glob("*inflight*"))


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_shape=(1, 2), cv_parallel="folds"), "mesh_shape"),
    (dict(mesh_shape=(2, 1), cv_parallel="folds", layout="coo"), "layout='coo'"),
    (dict(mesh_shape=(2, 1), cv_parallel="folds", layout="halo"), "layout='halo'"),
], ids=["folds_1x2", "folds_coo", "folds_halo"])
def test_fold_sharded_requests_lockstep_cannot_serve_raise_the_references_error(
        tmp_path, kw, match):
    gs = _gs("MUTAG", 24, 1)
    with pytest.raises(ValueError, match=f"cv_parallel='folds' is incompatible with: .*{match}"):
        cv.run_cross_validation(Config(**_cfg(tmp_path, "refused", **kw)), dataset=gs,
                                device="cpu")


def test_fold_sharded_lockstep_through_the_cli(grids):
    """`--mesh 2,1` under `auto` on synthetic NCI1 (the whole profile):
    dense lockstep, one fold a rank, rank 0's artifacts for both folds."""
    stats = grids["root"] / "cli" / "statistics"
    events = [json.loads(ln) for ln in (stats / "NCI1_events.jsonl").read_text().splitlines()]
    assert events[0]["layout"] == "dense" and events[0]["fold_shards"] == 2
    assert {e["fold"] for e in events if e["kind"] == "epoch"} == {1, 2}
    for r in grids["cli"]:
        np.testing.assert_array_equal(r["test_accuracies"], grids["cli"][0]["test_accuracies"])
        assert np.isfinite(r["test_accuracies"]).all()
