"""The halo layout of the port (batching/shard_pack.py, parallel/halo.py,
train/cv.py `MeshHaloEngine`) against the JAX package's
(dgcnn_tpu/batching/shard_pack.py, dgcnn_tpu/parallel/halo.py) on
conftest's 8-device virtual CPU mesh, and against the port's own
single-device COO forward. The packer byte for byte, every field and
every error, and the per-rank pack against its row of the full pack; the
halo log-probs, loss and gradients of ranks that run as `gloo`
subprocesses (tests/torch_mesh_worker.py) at (1, 2) and (2, 2) against
JAX's `make_halo_loss`, and at G = 2 and 4 against `apply_coo`; the
gradient sum over all D·G ranks (a sum over the data group alone is
caught); and `--layout halo` through `run_cross_validation` and the CLI:
finite, rank 0 alone writes, replicas bitwise, dropout-0 rows as one
process's COO run, crash and resume bitwise. Mirrors tests/test_halo.py.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dgcnn_tpu.batching import shard_pack as jsp
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jinit
from dgcnn_tpu.parallel import make_mesh as jmake_mesh
from dgcnn_tpu.parallel.halo import _halo_pspecs, apply_halo as japply_halo
from dgcnn_tpu.parallel.halo import make_halo_loss as jhalo_loss
from dgcnn_tpu_torch.batching import shard_pack as sp
from dgcnn_tpu_torch.batching.packer import batch_to_device, compute_bucket, pack_batch
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet
from dgcnn_tpu_torch.parallel.mesh import ProcessGrid
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

LOSS = {  # name: (data spec, mesh, global batch size)
    "mutag_1x2": (dict(data="MUTAG", graphs=16, seed=3), (1, 2), 16),
    "mutag_2x2": (dict(data="MUTAG", graphs=16, seed=3), (2, 2), 16),
    "mutag_1x4": (dict(data="MUTAG", graphs=16, seed=3), (1, 4), 16),
    "dd_1x2": (dict(data="DD", graphs=8, seed=9), (1, 2), 8),
}
BF16 = {"mutag_2x2_bf16": "mutag_2x2"}  # bf16 compute
JAX_MESHES = ("mutag_1x2", "mutag_2x2")
DATA = dict(data="MUTAG", graphs=48, seed=5)
CV = {  # name: (mesh, cfg overrides, data)
    "cv_1x2": ((1, 2), dict(dropout_rate=0.0), DATA),
    "cv_2x2": ((2, 2), dict(), DATA),
    "nci1_1x2": ((1, 2), dict(data_type="NCI1"), dict(data="NCI1", graphs=40, seed=2)),
    "dd_2x1": ((2, 1), dict(data_type="DD", batch_size=8),
               dict(data="DD", graphs=16, seed=2)),
    "ckpt_1x2": ((1, 2), dict(max_fused_epochs=1, checkpoint_every=1), DATA),
}
CRASH = dict(mesh=(1, 2), cfg=CV["ckpt_1x2"][1], crash_at=2)


@functools.lru_cache(maxsize=None)
def _gs(data, graphs, seed):
    return synthesize_tu_dataset(data, num_graphs=graphs, seed=seed)


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


@functools.lru_cache(maxsize=None)
def _jparams(data, graphs, seed):
    gs = _gs(data, graphs, seed)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    return jm, jinit(jax.random.PRNGKey(5), jm)


def _state(spec):
    _, jp = _jparams(spec["data"], spec["graphs"], spec["seed"])
    return {k: v.numpy() for k, v in
            params_from_jax(jax.tree_util.tree_map(np.asarray, jp)).items()}


def _bucket(spec, mesh, bs):
    return sp.halo_bucket(_gs(**spec), bs, *mesh)


def _cfg(root, name, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=2, num_folds=2,
                layout="halo", data_root=str(root / "data"),
                epochs_dir=str(root / name / "epochs"),
                statistics_dir=str(root / name / "statistics"), node_pad_multiple=64,
                edge_pad_multiple=128, graph_pad_multiple=4)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{job name: [each rank's results]}; the jobs of one world size share
    one grid of processes."""
    root = tmp_path_factory.mktemp("halo")
    jobs = {2: [], 4: []}
    for name, base in [(n, n) for n in LOSS] + list(BF16.items()):
        spec, mesh, bs = LOSS[base]
        path = root / f"{name}_params.npz"
        np.savez(path, **_state(spec))
        b = _bucket(spec, mesh, bs)
        jobs[mesh[0] * mesh[1]].append(
            {"name": name, "kind": "halo_loss", **spec, "mesh": list(mesh),
             "params": str(path), "idx": list(range(spec["graphs"])),
             "bucket": [b.shard_nodes, b.shard_edges, b.shard_graphs, b.halo],
             **({"dtype": "bfloat16"} if name in BF16 else {})})
    for name, (mesh, over, data) in CV.items():
        jobs[mesh[0] * mesh[1]].append(
            {"name": name, "kind": "cv", **data,
             "cfg": _cfg(root, name, mesh_shape=list(mesh), **over)})
    jobs[2].append({"name": "crash", "kind": "cv", **DATA, "crash_at": CRASH["crash_at"],
                    "cfg": _cfg(root, "crash", mesh_shape=list(CRASH["mesh"]),
                                **CRASH["cfg"])})
    jobs[2].append({"name": "cli", "kind": "cli", "argv": [
        "--data_type", "MUTAG", "--synthetic", "--layout", "halo", "--mesh", "1,2",
        "--platform", "cpu", "--num_folds", "2", "--num_epochs", "1",
        "--data_root", str(root / "data"), "--out_root", str(root / "cli")]})
    out = {"root": root}
    for world, js in jobs.items():
        results = torch_mesh_worker.spawn(tmp_path_factory.mktemp(f"world{world}"), world,
                                          js, timeout=600.0)
        for job in js:
            name = job["name"]
            out[name] = [{k[len(name) + 1:]: v for k, v in r.items()
                          if k.startswith(name + "/")} for r in results]
    return out


# -- the packer ----------------------------------------------------------------


def _same(a, b, what):
    for f in sp.FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert x.tobytes() == y.tobytes(), (what, f)
    assert a.halo == b.halo


@pytest.mark.parametrize("data,graphs,mesh,bs", [
    ("MUTAG", 40, (2, 4), 16), ("DD", 30, (2, 2), 12), ("DD", 17, (1, 3), 17)])
def test_pack_epoch_is_byte_equal_to_the_references(data, graphs, mesh, bs):
    gs = _gs(data, graphs, 3)
    jb, tb = jsp.halo_bucket(_jset(gs), bs, *mesh), sp.halo_bucket(gs, bs, *mesh)
    assert (jb.shard_nodes, jb.shard_edges, jb.shard_graphs, jb.halo) == (
        tb.shard_nodes, tb.shard_edges, tb.shard_graphs, tb.halo)
    assert jsp.halo_width(_jset(gs), 64) == sp.halo_width(gs, 64)
    order = np.random.default_rng(1).permutation(graphs)
    want = jsp.pack_epoch_halo(_jset(gs), order, bs, *mesh, jb)
    got = sp.pack_epoch_halo(gs, order, bs, *mesh, tb)
    _same(got, want, "epoch")
    np.testing.assert_array_equal(sp.halo_owned_order(got),
                                  jsp.halo_owned_order(want))
    # each rank's own pack is its row of the full pack
    for d in range(mesh[0]):
        for g in range(mesh[1]):
            mine = sp.pack_epoch_halo(gs, order, bs, *mesh, tb, rank=(d, g))
            _same(mine, want.__class__(**{f: getattr(want, f)[:, d * mesh[1] + g]
                                          for f in sp.FIELDS}, halo=want.halo),
                  f"rank {(d, g)}")


def _error(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("case", ["halo", "budget", "slots", "edges"])
def test_pack_errors_are_the_references(case):
    """Every reachable error, message for message. (The window error needs
    a graph of more than H nodes, which the halo check refuses first: a
    graph starting in shard o ends before (o + 1)·S + H.)"""
    gs = _gs("DD", 30, 3)
    h = sp.halo_width(gs)
    idx = np.arange(12)
    args = {  # (shards, S, E_s, B_s, H)
        "halo": (2, 4096, 1 << 16, 16, 64),
        "budget": (2, 256, 1 << 16, 16, h),
        "slots": (2, 4096, 1 << 16, 2, h),
        "edges": (2, 4096, 64, 16, h),
    }[case]
    want = _error(jsp.pack_batch_halo, _jset(gs), idx, *args)
    got = _error(sp.pack_batch_halo, gs, idx, *args)
    assert got == want
    assert {"halo": "exceeds halo", "budget": "shard budget", "slots": "slots",
            "edges": "> budget"}[case] in got


# -- the forward, the loss and the gradients -------------------------------------


def _jax_halo(name):
    """JAX's log-probs in (rank, slot) order [D·G·B_s, C], its loss, correct
    count and gradients (as port state keys) at the job's mesh."""
    from functools import partial

    spec, mesh, bs = LOSS[name]
    gs = _gs(**spec)
    jm, jp = _jparams(spec["data"], spec["graphs"], spec["seed"])
    b = jsp.halo_bucket(_jset(gs), bs, *mesh)
    batch = jsp.pack_step_halo(_jset(gs), np.arange(spec["graphs"]), *mesh, b.shard_nodes,
                               b.shard_edges, b.shard_graphs, b.halo)
    jmesh = jmake_mesh(mesh)

    @partial(jax.shard_map, mesh=jmesh, in_specs=(P(), _halo_pspecs(b.halo)),
             out_specs=P(("data", "graph")))
    def lp_fn(params, batch):
        local = jax.tree_util.tree_map(lambda a: a[0], batch)
        return japply_halo(params, jm, local)[None]

    lp = np.asarray(jax.jit(lp_fn)(jp, batch)).reshape(-1, gs.num_classes)
    loss_fn = jhalo_loss(jm, jmesh, b.halo, deterministic=True)
    (loss, correct), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, jax.random.PRNGKey(0)), has_aux=True))(jp)
    grads = {k: v.numpy() for k, v in
             params_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items()}
    return lp, float(loss), float(correct), grads


def _port(grids, name):
    ranks = grids[name]
    lp = np.concatenate([r["lp"] for r in ranks])
    mask = np.concatenate([r["graph_mask"] for r in ranks]) > 0
    return ranks, lp, mask


@pytest.mark.parametrize("name", JAX_MESHES)
def test_halo_matches_jax(grids, name):
    ranks, lp, mask = _port(grids, name)
    want_lp, want_loss, want_correct, want_grads = _jax_halo(name)
    np.testing.assert_allclose(lp[mask], want_lp[mask], rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=1e-5, atol=1e-6)
        assert float(r["correct"]) == want_correct
        for k, g in want_grads.items():
            np.testing.assert_allclose(r[f"grad/{k}"], g, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {k}")


def _jax_coo_bf16(name):
    """JAX's bf16 `apply_coo` over the job's sub-batches: the real graphs'
    log-probs in order, the global-batch loss and its gradients."""
    import dataclasses

    from dgcnn_tpu.batching import packer as jpk
    from dgcnn_tpu.models.dgcnn import apply_coo as japply_coo
    from dgcnn_tpu.parallel.train_dp import _loss_terms as jterms

    spec, mesh, _ = LOSS[name]
    gs = _gs(**spec)
    jm, jp = _jparams(spec["data"], spec["graphs"], spec["seed"])
    jm = dataclasses.replace(jm, compute_dtype="bfloat16")
    parts = np.array_split(np.arange(spec["graphs"]), mesh[0])
    batches = [jpk.pack_batch(_jset(gs), part, jpk.compute_bucket(_jset(gs), len(part)))
               for part in parts]

    def loss(p):
        total, lps = 0.0, []
        for part, b in zip(parts, batches):
            lp = japply_coo(p, jm, b)
            total = total + jterms(lp, b.y, b.graph_mask)[0]
            lps.append(lp[: len(part)])
        return total / spec["graphs"], jax.numpy.concatenate(lps)

    (total, lp), grads = jax.value_and_grad(loss, has_aux=True)(jp)
    return np.asarray(lp), float(total), {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)).items()}


@pytest.mark.parametrize("name", list(BF16))
def test_halo_bf16_casts_where_the_reference_casts(grids, name):
    """bf16 compute (x, each W_i and each layer's output in bf16; the
    exchange and the aggregation fp32) against the reference's bf16
    `apply_coo` on the same sub-batches, at the bf16 tolerances of
    tests/test_torch_coo_bf16.py: log-probs within 5e-3; the whole
    gradient within 1e-2 of its largest element, element by element, and
    of its norm. (Not against JAX's bf16 halo: it aggregates with `take`
    and `segment_sum` where its `apply_coo` runs its SpMM, another
    summation order, and on this batch its head's gradient (lin1.b)
    leaves its own `apply_coo`'s by 19 % of the largest element, a bf16
    rounding flipped upstream; the port's halo runs the SpMM kernels as
    its `apply_coo` does, which meets the reference's.)"""
    ranks, lp, mask = _port(grids, name)
    want_lp, want_loss, want_grads = _jax_coo_bf16(BF16[name])
    np.testing.assert_allclose(lp[mask], want_lp, rtol=0, atol=5e-3)
    w = np.concatenate([g.ravel() for g in want_grads.values()])
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=0, atol=5e-3)
        g = np.concatenate([r[f"grad/{k}"].ravel() for k in want_grads])
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()
        assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


def _one_device(name):
    """The port's single-process COO forward over the same sub-batches:
    the log-probs of the real graphs in order, the global-batch loss and
    its gradients."""
    spec, mesh, _ = LOSS[name]
    gs = _gs(**spec)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    net = DGCNNNet(model, state_to_params({k: torch.from_numpy(v)
                                           for k, v in _state(spec).items()}))
    lps, total, correct = [], 0.0, 0.0
    for part in np.array_split(np.arange(spec["graphs"]), mesh[0]):
        b = batch_to_device(pack_batch(gs, part, compute_bucket(gs, len(part))), "cpu")
        lp = net(b)
        loss, c = nll_loss_and_correct(lp, b.y, b.graph_mask)
        total = total + loss * len(part)
        correct += float(c)
        lps.append(lp[: len(part)].detach().numpy())
    (total / spec["graphs"]).backward()
    return (np.concatenate(lps), float(total.detach()) / spec["graphs"], correct,
            {n: p.grad.numpy() for n, p in net.named_parameters()})


@pytest.mark.parametrize("name", list(LOSS))
def test_halo_is_partition_invariant(grids, name):
    """The owned graphs' log-probs, the loss and the gradients after the
    sum over all D·G ranks equal one device's `apply_coo` (DD: graphs
    straddle the shard boundary)."""
    ranks, lp, mask = _port(grids, name)
    want_lp, want_loss, want_correct, want_grads = _one_device(name)
    rtol, atol = (2e-4, 1e-5) if LOSS[name][0]["data"] == "DD" else (1e-5, 1e-6)
    np.testing.assert_allclose(lp[mask], want_lp, rtol=rtol, atol=atol)
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=1e-5)
        assert float(r["correct"]) == want_correct
        for k, g in want_grads.items():
            np.testing.assert_allclose(r[f"grad/{k}"], g, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_a_sum_over_the_data_group_alone_is_caught(grids):
    """At (2, 2) each graph rank holds another share of the gradient: the
    data group's sum alone leaves one device's gradients, the sum over all
    D·G ranks meets them, and every rank holds the same bits."""
    ranks = grids["mutag_2x2"]
    want = _one_device("mutag_2x2")[3]
    far = [k for k, g in want.items()
           if not np.allclose(ranks[0][f"data_only/{k}"], g, rtol=1e-4, atol=1e-6)]
    assert far, "the data group's sum alone met one device's gradients"
    for r in ranks[1:]:
        for k in want:
            np.testing.assert_array_equal(r[f"grad/{k}"], ranks[0][f"grad/{k}"])


# -- the engine through the driver ---------------------------------------------------


@pytest.mark.parametrize("name", list(CV))
def test_halo_run_is_finite_and_rank_0_alone_writes(grids, name):
    ranks = grids[name]
    for res in ranks:
        assert res["test_accuracies"].shape == (2,)
        assert np.isfinite(res["test_accuracies"]).all()
        for fold in (1, 2):
            assert str(res[f"fold{fold}/engine"]) == "MeshHaloEngine"
            assert np.isfinite(res[f"fold{fold}/rows"]).all()
    assert int(ranks[0]["writes"]) > 0
    assert [int(r["writes"]) for r in ranks[1:]] == [0] * (len(ranks) - 1)
    stats = grids["root"] / name / "statistics"
    start = json.loads(next(stats.glob("*_events.jsonl")).read_text().splitlines()[0])
    assert start["layout"] == "halo" and start["engine"] == "MeshHaloEngine"
    assert start["mesh_shape"] == list(CV[name][0]) and start["graphs"] is False


@pytest.mark.parametrize("name", list(CV))
def test_halo_replicas_are_bitwise_equal(grids, name):
    ranks = grids[name]
    for fold in (1, 2):
        keys = [k for k in ranks[0] if k.startswith(f"fold{fold}/param/")]
        assert keys
        for res in ranks[1:]:
            for k in keys + [f"fold{fold}/rows"]:
                np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)


def test_halo_dropout_0_rows_match_one_process_coo(grids, tmp_path):
    mesh, over, data = CV["cv_1x2"]
    cfg = Config(**_cfg(tmp_path, "single", **{**over, "layout": "coo"}))
    gs = _gs(data["data"], data["graphs"], data["seed"])
    rows = {}
    orig = cv.run_fold

    def run_fold(*a, **k):
        m = orig(*a, **k)
        rows[a[3]] = np.stack([m.rows[c] for c in ("train_loss", "test_loss")], axis=1)
        return m

    cv.run_fold = run_fold
    try:
        res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    finally:
        cv.run_fold = orig
    halo = grids["cv_1x2"][0]
    np.testing.assert_array_equal(halo["test_accuracies"], res["test_accuracies"])
    for fold in (1, 2):
        got = halo[f"fold{fold}/rows"][:, :2]
        np.testing.assert_allclose(got, rows[fold][-len(got):], rtol=3e-4, atol=2e-6)


def test_halo_crash_and_resume_give_the_uninterrupted_runs_bits(grids):
    root = grids["root"]
    for r, (a, b) in enumerate(zip(grids["crash"], grids["ckpt_1x2"])):
        assert int(a["crashed"]) == 1
        for k in [k for k in b if k.startswith("fold") or k.endswith("accuracies")]:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"rank {r} {k}")
    for fold in (1, 2):
        assert ((root / "crash" / "statistics" / f"MUTAG_results_{fold}.csv").read_text()
                == (root / "ckpt_1x2" / "statistics" /
                    f"MUTAG_results_{fold}.csv").read_text())
    assert not list((root / "crash" / "epochs").glob("*inflight*"))


def test_halo_through_the_cli(grids):
    stats = grids["root"] / "cli" / "statistics"
    assert (stats / "MUTAG_results_overall.csv").exists()
    start = json.loads((stats / "MUTAG_events.jsonl").read_text().splitlines()[0])
    assert start["layout"] == "halo" and start["mesh_shape"] == [1, 2]
    for r in grids["cli"]:
        assert np.isfinite(r["test_accuracies"]).all()


def test_halo_on_one_device_is_the_references_value_error(tmp_path):
    gs = _gs("MUTAG", 24, 1)
    cfg = Config(**_cfg(tmp_path, "one"))
    with pytest.raises(ValueError, match="halo"):
        cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    assert cv.choose_layout(Config(**_cfg(tmp_path, "a", layout="auto",
                                          mesh_shape=(1, 2))), gs) != "halo"


def test_make_engine_picks_the_halo_engine(tmp_path):
    gs = _gs("MUTAG", 24, 1)
    cfg = Config(**_cfg(tmp_path, "e", mesh_shape=(2, 2), spmm_impl="pallas"))
    grid = ProcessGrid((2, 2), 3, torch.device("cpu"))
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "halo", grid=grid)
    assert type(engine).__name__ == "MeshHaloEngine" and engine.grid is grid
    assert (engine.dropout_rank, engine.dropout_ranks) == (3, 4)
    assert engine.bucket == sp.halo_bucket(gs, 16, 2, 2, 64, 128, 4)
