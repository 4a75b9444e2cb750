"""The run tail on the CPU: the curve PNG at the reference's path (and the
reference's bytes), its redraw at chunk boundaries on a throttle, the
TensorBoard export against the reference's on the same event log, the
tqdm fold bar, the best-effort messages when a library is missing, and
the CLI's `--ckpt_every` / `--resume` / `--tensorboard`."""

import json
import os
import sys

import numpy as np
import pytest

from dgcnn_tpu.train.plots import render_curves as jax_render_curves
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.train import cv, plots
from dgcnn_tpu_torch.train.metrics import completed_fold_accuracies
import torch_threads  # noqa: F401  (torch on one CPU thread)

GS = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=5)


def _cfg(tmp_path, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=2, num_folds=2,
                layout="dense", cv_parallel="sequential", max_fused_epochs=1,
                data_root=str(tmp_path / "data"),
                epochs_dir=str(tmp_path / "epochs"),
                statistics_dir=str(tmp_path / "statistics"))
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def finished_run(tmp_path_factory):
    """One sequential run of 2 folds x 2 epochs in chunks of 1, with a
    TensorBoard export; its statistics directory."""
    pytest.importorskip("tensorboardX")
    tmp = tmp_path_factory.mktemp("run")
    cfg = _cfg(tmp, tensorboard_dir=str(tmp / "tb"))
    cv.run_cross_validation(cfg, dataset=GS, device="cpu")
    return cfg


def test_curves_are_drawn_at_the_reference_path_with_its_bytes(finished_run, tmp_path):
    png = os.path.join(finished_run.statistics_dir, "MUTAG_curves.png")
    with open(png, "rb") as f:
        ours = f.read()
    assert ours[:8] == b"\x89PNG\r\n\x1a\n"
    ref = jax_render_curves(finished_run.statistics_dir, "MUTAG",
                            str(tmp_path / "ref.png"))
    with open(ref, "rb") as f:
        assert f.read() == ours
    assert plots.render_curves(finished_run.statistics_dir, "MUTAG") == png


def test_tensorboard_export_counts_the_references_scalars(finished_run, tmp_path):
    from dgcnn_tpu.train.tensorboard import export_events as jax_export

    from dgcnn_tpu_torch.train.tensorboard import export_events

    events = os.path.join(finished_run.statistics_dir, "MUTAG_events.jsonl")
    tb = os.path.join(finished_run.tensorboard_dir, "MUTAG")
    assert sorted(os.listdir(tb)) == ["fold_1", "fold_2"]
    assert all(os.listdir(os.path.join(tb, d)) for d in ("fold_1", "fold_2"))
    n = export_events(events, str(tmp_path / "ours"))
    assert n == jax_export(events, str(tmp_path / "ref")) == 2 * 2 * 6


def test_live_curves_are_drawn_on_a_throttle(tmp_path, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(plots, "render_curves", lambda *a: calls.append(a))
    live = cv.CurveRenderer(_cfg(tmp_path))
    live.maybe_render()
    live.maybe_render()
    assert len(calls) == 1
    live.MIN_SECONDS = 0.0
    live.maybe_render()
    assert len(calls) == 2

    def broken(*a):
        raise OSError("a CSV mid-write")

    monkeypatch.setattr(plots, "render_curves", broken)
    live.maybe_render()
    live.maybe_render()
    assert capsys.readouterr().out.count("(live curve rendering skipped: a CSV mid-write)") == 1


def test_a_run_redraws_its_curves_at_chunk_boundaries(tmp_path, monkeypatch):
    drawn = []
    monkeypatch.setattr(plots, "render_curves", lambda d, ds, *a: drawn.append(
        [completed_fold_accuracies(os.path.join(d, f"{ds}_results_1.csv"), n)
         is not None for n in (1, 2)]))
    monkeypatch.setattr(cv.CurveRenderer, "MIN_SECONDS", 0.0)  # no throttle
    cv.run_cross_validation(_cfg(tmp_path), dataset=GS, device="cpu")
    # fold 1 after epoch 1 and fold 2 after its epoch 1 (fold 1 complete),
    # then the run end
    assert drawn == [[True, False], [False, True], [False, True]]


def test_missing_libraries_are_skipped_with_a_message(tmp_path, monkeypatch, capsys):
    """matplotlib, tensorboardX and tqdm are host-side extras: without
    them the run still completes and says what it skipped."""
    for mod in ("matplotlib", "tensorboardX", "tqdm"):
        monkeypatch.setitem(sys.modules, mod, None)
    res = cv.run_cross_validation(_cfg(tmp_path, tensorboard_dir=str(tmp_path / "tb")),
                                  dataset=GS, device="cpu")
    captured = capsys.readouterr()
    assert "(curve rendering skipped: " in captured.out
    assert "(tensorboard export skipped: " in captured.out
    assert "processing MUTAG" not in captured.err
    assert len(res["test_accuracies"]) == 2
    assert not os.path.exists(tmp_path / "statistics" / "MUTAG_curves.png")


def test_the_fold_bar(tmp_path, capsys, monkeypatch):
    pytest.importorskip("tqdm")
    monkeypatch.setattr(plots, "render_curves", lambda *a, **k: "")
    cv.run_cross_validation(_cfg(tmp_path, num_epochs=1), dataset=GS, device="cpu")
    err = capsys.readouterr().err
    assert "processing MUTAG" in err and "2/2" in err and "test_acc=" in err


def test_cli_serves_ckpt_every_resume_and_tensorboard(tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorboardX")
    monkeypatch.setattr(plots, "render_curves", lambda *a, **k: "")
    argv = ["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
            "--num_folds", "2", "--num_epochs", "2", "--ckpt_every", "1",
            "--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path / "out"),
            "--tensorboard", str(tmp_path / "tb"), "--layout", "dense"]
    first = cli.main(argv)
    assert os.listdir(tmp_path / "tb" / "MUTAG")
    capsys.readouterr()
    again = cli.main(argv + ["--resume"])
    assert capsys.readouterr().out.count("resumed (complete)") == 2
    assert again["test_accuracies"] == pytest.approx(first["test_accuracies"])
    with open(tmp_path / "out" / "statistics" / "MUTAG_events.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("run_end") == 2 and kinds.count("epoch") == 4
    assert np.isfinite(again["test_accuracy_mean"])
