"""The port's pinned trajectory (dgcnn_tpu_torch/tools/pinned_trajectory.py):
the exact 20-epoch per-fold CSVs of the reference's pinned configuration
(synthetic MUTAG, 40 graphs, seed 5; batch 16, 2 folds in lockstep,
graph_pad_multiple 4) on the dense and block lockstep engines, held to
the port's own artifacts (`dgcnn_tpu_torch/assets/pinned_trajectory/`)
at the reference test's tolerance (tests/test_pinned_trajectory.py:42:
rtol 1e-4, atol 1e-6). The port draws its own init and dropout, so its
artifacts are not the reference's; the JAX-held case ties the two: the
same configuration at dropout 0 and 3 epochs through both packages'
`run_cross_validation`, the port starting each fold from the reference's
initial weights (monkeypatched here only), the loss columns within rtol
1e-5 and the accuracy columns equal.

If a change to the math is intended, regenerate with `python -m
dgcnn_tpu_torch.tools.pinned_trajectory --write` and say so in
CHANGES.md."""

import os

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.config import Config as JConfig
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jsynthesize
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jinit
from dgcnn_tpu.train.cv import run_cross_validation as jrun_cv
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.tools import pinned_trajectory as pt
from dgcnn_tpu_torch.train import cv, cv_vmap
import torch_threads  # noqa: F401  (torch on one CPU thread)

HELD_EPOCHS = 3


@pytest.mark.parametrize("layout", pt.LAYOUTS)
def test_pinned_trajectory_matches_the_ports_artifacts(tmp_path, layout):
    got = pt.run_pinned(layout, str(tmp_path), "cpu")
    assert sorted(got) == list(range(1, pt.NUM_FOLDS + 1))
    for fold, text in got.items():
        with open(pt.artifact_path(layout, fold)) as f:
            want = pt.parse_csv(f.read())
        have = pt.parse_csv(text)
        assert have.shape == (pt.NUM_EPOCHS, 5)
        np.testing.assert_allclose(
            have, want, rtol=1e-4, atol=1e-6,
            err_msg=(f"{layout} fold {fold} trajectory drifted: a change to the math "
                     "reached the training path. If intended, regenerate with "
                     "`python -m dgcnn_tpu_torch.tools.pinned_trajectory --write` and "
                     "record why in CHANGES.md."))
        rows = text.splitlines()
        cells = rows[-1].split(",")
        cells[1] = repr(float(cells[1]) * (1 + 1e-3))  # a last-epoch loss 0.1 % off
        off = "\n".join(rows[:-1] + [",".join(cells)])
        assert pt.matches(text, text) and not pt.matches(off, text)


def test_the_tool_runs_on_the_card_by_default(tmp_path, capsys):
    """Without `--platform cpu` the tool runs on the card against the card's
    artifacts (`card/`, one per layout and fold, each 20 epochs of the CSV's
    five columns); without a card it raises before it runs or writes."""
    for layout in pt.LAYOUTS:
        for fold in range(1, pt.NUM_FOLDS + 1):
            path = pt.artifact_path(layout, fold, "cuda")
            assert os.path.dirname(path) == os.path.join(pt.ARTIFACT_DIR, "card")
            with open(path) as f:
                assert pt.parse_csv(f.read()).shape == (pt.NUM_EPOCHS, 5)
    if not torch.cuda.is_available():
        for argv in ([], ["--write"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                pt.main(argv)
        assert capsys.readouterr().out == ""


def _jax_init_by_seed(num_features, num_classes):
    """The reference lockstep driver's initial weights of folds 1..K
    (cv_vmap `_init_all`: fold_in(PRNGKey(seed), f), split, the first
    key), keyed by the seed of the port's init generator of that fold."""
    jm = JDGCNN(num_features=num_features, num_classes=num_classes)
    out = {}
    for f in range(1, pt.NUM_FOLDS + 1):
        key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(324), f))[0]
        out[cv._stream_seed(324, f, 1)] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, jinit(key, jm)))
    return out


def _csvs(stats_dir):
    out = {}
    for fold in range(1, pt.NUM_FOLDS + 1):
        with open(os.path.join(stats_dir, f"MUTAG_results_{fold}.csv")) as f:
            out[fold] = pt.parse_csv(f.read())
    return out


@pytest.mark.parametrize("layout", pt.LAYOUTS)
def test_pinned_configuration_matches_jax_from_its_weights(tmp_path, layout, monkeypatch):
    over = dict(num_epochs=HELD_EPOCHS, dropout_rate=0.0)
    port_cfg = pt.pinned_config(layout, str(tmp_path / "port"), **over)
    jcfg = JConfig(**{**{f: getattr(port_cfg, f) for f in (
        "data_type", "batch_size", "num_epochs", "seed", "num_folds", "layout",
        "cv_parallel", "graph_pad_multiple", "dropout_rate")},
        "data_root": str(tmp_path / "jax" / "data"),
        "epochs_dir": str(tmp_path / "jax" / "epochs"),
        "statistics_dir": str(tmp_path / "jax" / "statistics")})
    jrun_cv(jcfg, dataset=jsynthesize("MUTAG", num_graphs=40, seed=5))

    gs = pt.pinned_dataset()
    weights = _jax_init_by_seed(gs.num_features, gs.num_classes)
    seen = []
    real = cv_vmap.init_params

    def from_jax(gen, model, device="cpu"):
        if gen.initial_seed() not in weights:
            return real(gen, model, device)
        seen.append(gen.initial_seed())
        return state_to_params({k: v.to(device) for k, v in
                                weights[gen.initial_seed()].items()})

    monkeypatch.setattr(cv_vmap, "init_params", from_jax)
    torch.set_num_threads(pt.THREADS)
    cv.run_cross_validation(port_cfg, dataset=gs, device="cpu")
    assert sorted(seen) == sorted(weights)

    port, ref = _csvs(port_cfg.statistics_dir), _csvs(jcfg.statistics_dir)
    for fold in port:
        assert port[fold].shape == ref[fold].shape == (HELD_EPOCHS, 5)
        np.testing.assert_array_equal(port[fold][:, 0], ref[fold][:, 0])
        np.testing.assert_allclose(port[fold][:, 1:3], ref[fold][:, 1:3], rtol=1e-5,
                                   err_msg=f"{layout} fold {fold} losses")
        np.testing.assert_array_equal(port[fold][:, 3:], ref[fold][:, 3:],
                                      err_msg=f"{layout} fold {fold} accuracies")
