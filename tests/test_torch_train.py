"""Training end to end on the CPU: the port's Adam steps against the JAX
step on the same weights and batches, the sequential CV driver's
artifacts, and the options this slice rejects."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from dgcnn_tpu.batching.dense import pack_dense_batch as jax_pack
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_dense as jax_apply_dense
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu.train.metrics import FoldMetrics as JFoldMetrics
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.batching.dense import batch_to_device, dense_tile, pack_dense_batch
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, leaves
from dgcnn_tpu_torch.parity.convert import params_from_jax, params_to_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import make_optimizer, nll_loss_and_correct, train_step
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_five_adam_steps_match_jax():
    gs = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=2)
    n_tile = dense_tile(gs)
    order = np.random.default_rng(0).permutation(40)
    batches = [order[i * 8 : i * 8 + 7] for i in range(5)]  # 7 of 8 slots used
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0)
    jp = jax_init(jax.random.PRNGKey(5), jm)
    net = DGCNNNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))))

    opt = optax.adam(1e-3)
    opt_state = opt.init(jp)

    @jax.jit
    def jstep(p, s, b, key):
        def loss_fn(p):
            lp = jax_apply_dense(p, jm, b, deterministic=False, dropout_rng=key)
            return jax_nll(lp, b.y, b.graph_mask)[0]

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    optimizer = make_optimizer(net)
    gen = torch.Generator().manual_seed(0)
    for i, idx in enumerate(batches):
        jb = jax.device_put(jax_pack(gs, idx, n_tile, 8))
        jp, opt_state, jloss = jstep(jp, opt_state, jb, jax.random.PRNGKey(i))
        tb = batch_to_device(pack_dense_batch(gs, idx, n_tile, 8), "cpu")
        loss, _ = train_step(net, optimizer, tb, gen)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    for a, b in zip(leaves(net.params()), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_nll_loss_and_correct_matches_jax():
    rng = np.random.default_rng(1)
    lp = np.log(rng.dirichlet(np.ones(3), size=10)).astype(np.float32)
    lp[2] = lp[2, [0, 0, 2]]  # a tie: argmax takes the first index
    y = rng.integers(0, 3, 10).astype(np.int32)
    gm = (np.arange(10) < 8).astype(np.float32)
    got = nll_loss_and_correct(torch.from_numpy(lp), torch.from_numpy(y),
                               torch.from_numpy(gm))
    want = jax_nll(lp, y, gm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6)


def _cfg(tmp_path, **kw):
    base = dict(
        data_type="MUTAG", num_folds=2, num_epochs=2, layout="dense",
        data_root=str(tmp_path / "data"),
        statistics_dir=str(tmp_path / "statistics"),
        epochs_dir=str(tmp_path / "epochs"),
    )
    return Config(**{**base, **kw})


def test_cv_run_writes_reference_artifacts(tmp_path):
    res = cv.run_cross_validation(_cfg(tmp_path), allow_synthetic=True, device="cpu")
    assert len(res["test_accuracies"]) == 2
    stats = tmp_path / "statistics"
    for fold in (1, 2):
        lines = (stats / f"MUTAG_results_{fold}.csv").read_text().splitlines()
        assert lines[0] == "epoch," + ",".join(JFoldMetrics.COLUMNS)
        rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
        assert rows.shape == (2, 5) and np.isfinite(rows).all()
        bundle = load_checkpoint(str(tmp_path / "epochs" / f"MUTAG_{fold}"))
        assert set(bundle) == {"params", "opt_state"}
        assert set(bundle["opt_state"]) == {"step", "exp_avg", "exp_avg_sq"}
        tree = params_to_jax({k: torch.from_numpy(v) for k, v in bundle["params"].items()})
        assert tree["lin1"]["w"].shape == (352, 128)
        assert float(bundle["opt_state"]["step"]["0"]) == 2 * 4  # 2 epochs x 4 steps
    overall = (stats / "MUTAG_results_overall.csv").read_text().splitlines()
    assert overall[0] == "fold,train_accuracy,test_accuracy" and len(overall) == 3
    events = [json.loads(ln) for ln in (stats / "MUTAG_events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["run_start"] + ["epoch"] * 4 + ["run_end"]
    assert events[0]["layout"] == "dense" and events[0]["num_params"] == 52035

    # same seed, same run: the CPU path is deterministic
    again = cv.run_cross_validation(
        _cfg(tmp_path, statistics_dir=str(tmp_path / "s2"),
             epochs_dir=str(tmp_path / "e2")),
        allow_synthetic=True, device="cpu",
    )
    assert again["test_accuracies"] == res["test_accuracies"]
    assert (tmp_path / "s2" / "MUTAG_results_1.csv").read_text() == (
        stats / "MUTAG_results_1.csv").read_text()


@pytest.mark.parametrize("kw", [
    {"mesh_shape": (2, 1)},
], ids=lambda kw: next(iter(kw)))
def test_unserved_options_raise(tmp_path, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cv.run_cross_validation(_cfg(tmp_path, **kw), allow_synthetic=True,
                                device="cpu")


@pytest.mark.parametrize("layout", ["multi", "halo"])
def test_unported_layouts_raise(tmp_path, layout):
    """halo is not ported and raises, naming its ROADMAP item; multi is
    ported: one fold x 1 epoch on the CPU through its engine (two tile
    classes) writes the fold's CSV and its `epochs/` bundle."""
    if layout == "halo":
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            cv.run_cross_validation(_cfg(tmp_path, layout=layout),
                                    allow_synthetic=True, device="cpu")
        return
    cfg = _cfg(tmp_path, layout=layout, num_epochs=1, multi_dense_min_tile=16)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=2)
    train, test = cv.get_folds(gs.y, "", 2, cfg.seed, data_type="MUTAG")[0]
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), layout)
    assert isinstance(engine, cv.MultiDenseEngine) and len(engine.tiles) == 2
    model = cv._model_from_config(cfg, gs.num_features, gs.num_classes)
    cv.run_fold(cfg, gs, model, 1, train, test, engine,
                cv.EventLog(str(tmp_path / "events.jsonl")))
    rows = np.loadtxt(tmp_path / "statistics" / "MUTAG_results_1.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    assert rows.shape == (1, 5) and np.isfinite(rows).all()
    assert (tmp_path / "epochs" / "MUTAG_1.npz").exists()


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cv.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--data_type", "MUTAG", "--synthetic",
                  "--out_root", str(tmp_path)])
    with pytest.raises(NotImplementedError):
        cli.main(["--data_type", "MUTAG", "--platform", "probe"])
    assert cv.resolve_device("cpu").type == "cpu"


def test_cli_cpu_run(tmp_path):
    res = cli.main(["--data_type", "PTC_MR", "--synthetic", "--platform", "cpu",
                    "--num_folds", "2", "--num_epochs", "1", "--layout", "dense",
                    "--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path)])
    assert len(res["train_accuracies"]) == 2
    assert os.path.exists(tmp_path / "epochs" / "PTC_MR_2.npz")
