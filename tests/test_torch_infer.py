"""Inference on the CPU (dgcnn_tpu_torch/infer.py): `predict_dataset`
against the reference's `dgcnn_tpu.infer.predict_dataset` on the same
weights, `load_fold_params` on every bundle kind the drivers write, and
the CLI's CSV."""

import numpy as np
import pytest
import torch

import jax

from dgcnn_tpu.infer import predict_dataset as jax_predict
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu_torch import infer
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
import torch_threads  # noqa: F401  (torch on one CPU thread)

GS = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=5)


@pytest.fixture(autouse=True)
def _no_curves(monkeypatch):
    """The training runs here skip the run tail's curve PNG (tested in
    test_torch_run_tail.py)."""
    from dgcnn_tpu_torch.train import plots

    monkeypatch.setattr(plots, "render_curves", lambda *a, **k: "")


def _model():
    return DGCNN(num_features=GS.num_features, num_classes=GS.num_classes)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX weights and the reference's predictions over GS in batches of
    16 (the last one partial)."""
    jm = JDGCNN(num_features=GS.num_features, num_classes=GS.num_classes)
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(3), jm))
    return jp, jax_predict(jp, jm, GS, batch_size=16)


@pytest.mark.parametrize("spmm_impl", ["xla", "onehot"])
def test_predict_dataset_matches_jax(jax_reference, spmm_impl):
    jp, (want_lp, want_labels) = jax_reference
    params = state_to_params(params_from_jax(jp))
    lp, labels = infer.predict_dataset(params, _model(), GS, batch_size=16,
                                       spmm_impl=spmm_impl, device="cpu")
    assert lp.dtype == np.float32 and lp.shape == (40, 2)
    np.testing.assert_allclose(lp, want_lp, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(np.exp(lp).sum(-1), 1.0, rtol=1e-5)


def test_predict_dataset_refuses_what_it_cannot_run():
    params = init_params(torch.Generator().manual_seed(0), _model())
    with pytest.raises(ValueError, match="block-COO"):
        infer.predict_dataset(params, _model(), GS, spmm_impl="pallas", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a host with CUDA runs the default device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.predict_dataset(params, _model(), GS)


def _train(tmp_path, tag, **kw):
    cfg = Config(data_type="MUTAG", batch_size=16, num_epochs=1, num_folds=2,
                 layout="dense", data_root=str(tmp_path / "data"),
                 epochs_dir=str(tmp_path / tag / "epochs"),
                 statistics_dir=str(tmp_path / tag / "statistics"), **kw)
    cv.run_cross_validation(cfg, dataset=GS, device="cpu")
    return cv.fold_bundle(cfg, 1)


@pytest.mark.parametrize("kind", ["sequential", "lockstep", "opt_flatten", "raw"])
def test_load_fold_params_reads_every_bundle_kind(tmp_path, kind):
    if kind == "raw":
        net = DGCNNNet(_model(), init_params(torch.Generator().manual_seed(4), _model()))
        path = str(tmp_path / "raw")
        save_checkpoint(path, net.state_dict())
    else:
        path = _train(tmp_path, kind, **{
            "sequential": {"cv_parallel": "sequential"}, "lockstep": {},
            "opt_flatten": {"cv_parallel": "sequential", "opt_flatten": True}}[kind])
    bundle = load_checkpoint(path)
    saved = bundle.get("params", bundle)
    params = infer.load_fold_params(path, _model())
    state = DGCNNNet(_model(), params).state_dict()
    assert set(state) == set(saved)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), saved[k])
    lp, labels = infer.predict_dataset(params, _model(), GS, batch_size=16, device="cpu")
    assert np.isfinite(lp).all() and labels.shape == (40,)
    with pytest.raises(ValueError, match="not the model's"):
        infer.load_fold_params(path, DGCNN(num_features=GS.num_features,
                                           num_classes=GS.num_classes, dense_dim=64))


def test_infer_cli_writes_the_predictions_csv(tmp_path, capsys):
    path = _train(tmp_path, "run", cv_parallel="sequential")
    out_csv = tmp_path / "preds.csv"
    argv = ["--data_type", "MUTAG", "--checkpoint", path,
            "--data_root", str(tmp_path / "infer_data"), "--batch_size", "16",
            "--synthetic"]
    labels = infer.main(argv + ["--out", str(out_csv), "--platform", "cpu"])
    assert "accuracy vs dataset labels" in capsys.readouterr().out
    lines = out_csv.read_text().strip().splitlines()
    assert lines[0] == "graph,predicted_label,confidence,true_label"
    assert len(lines) == 188 + 1  # the full synthetic MUTAG profile
    full = synthesize_tu_dataset("MUTAG")
    lp, want = infer.predict_dataset(infer.load_fold_params(path, _model()), _model(),
                                     full, batch_size=16, device="cpu")
    np.testing.assert_array_equal(labels, want)
    rows = [ln.split(",") for ln in lines[1:]]
    assert [int(r[1]) for r in rows] == want.tolist()
    assert [r[2] for r in rows] == [f"{c:.4f}" for c in np.exp(lp.max(-1))]
    assert [int(r[3]) for r in rows] == full.y.tolist()
    with pytest.raises(NotImplementedError, match="probe"):
        infer.main(argv + ["--platform", "probe"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            infer.main(argv)
