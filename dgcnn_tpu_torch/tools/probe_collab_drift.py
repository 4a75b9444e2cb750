"""How far a one-ulp perturbation moves COLLAB's multi-tile rows, beside
how far fold-lockstep moves them.

    python -m dgcnn_tpu_torch.tools.probe_collab_drift [--graphs N]
        [--folds 2] [--epochs 4] [--platform cpu]

Runs synthetic COLLAB (all of its graphs unless `--graphs`) on the
multi-tile layout, `--folds` x `--epochs` at batch 50, four times on the
card unless `--platform cpu`: the folds one after another; the same with
every initial weight scaled by (1 + 2^-22); in lockstep
(`cv_parallel="folds"`); and one after another again. Prints, for each of
the last three, its largest distance from the first run's rows (train
and test loss, train and test accuracy in points) and every fold's test
accuracies by epoch, then one JSON line with all of it, the card's name
and power limit on the card. A rounding-level perturbation that moves
the rows as far as lockstep does makes lockstep's distance the run's own
sensitivity, not a fault of its batched products."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

SCALE = 1 + 2.0 ** -22  # one part in 2^22: two fp32 ulps at most


def scaled(params):
    """Every leaf of a parameter tree times `SCALE`."""
    if isinstance(params, dict):
        return {k: scaled(v) for k, v in params.items()}
    if isinstance(params, list):
        return [scaled(v) for v in params]
    return params * SCALE


def run(gs, mode: str, perturb: bool, folds: int, epochs: int, device) -> np.ndarray:
    """Every fold's CSV rows [folds, epochs, 5] of one run."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train import cv

    real = cv.init_params
    if perturb:
        cv.init_params = lambda gen, model, dev="cpu": scaled(real(gen, model, dev))
    try:
        with tempfile.TemporaryDirectory() as td:
            cfg = Config(data_type="COLLAB", layout="multi", cv_parallel=mode,
                         num_folds=folds, num_epochs=epochs, data_root=f"{td}/data",
                         statistics_dir=f"{td}/statistics", epochs_dir=f"{td}/epochs")
            cv.run_cross_validation(cfg, dataset=gs, device=device)
            return np.stack([np.loadtxt(os.path.join(cfg.statistics_dir,
                                                     f"COLLAB_results_{f}.csv"),
                                        delimiter=",", skiprows=1, ndmin=2)
                             for f in range(1, folds + 1)])
    finally:
        cv.init_params = real


def main(argv=None) -> int:
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.tools.probe_epoch_seconds import card

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--graphs", type=int, default=None)
    p.add_argument("--folds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    gs = (synthesize_tu_dataset("COLLAB") if args.graphs is None else
          synthesize_tu_dataset("COLLAB", num_graphs=args.graphs, seed=0))
    rows, seconds = {}, {}
    for name, mode, perturb in (("sequential", "sequential", False),
                                ("perturbed", "sequential", True),
                                ("lockstep", "folds", False),
                                ("sequential_again", "sequential", False)):
        t0 = time.perf_counter()
        rows[name] = run(gs, mode, perturb, args.folds, args.epochs, device)
        seconds[name] = time.perf_counter() - t0
    base = rows["sequential"]
    dist = {}
    for name in ("perturbed", "lockstep", "sequential_again"):
        d = np.abs(rows[name] - base)
        dist[name] = {"train_loss": float(d[..., 1].max()), "test_loss": float(d[..., 2].max()),
                      "train_acc_pts": float(d[..., 3].max()),
                      "test_acc_pts": float(d[..., 4].max())}
        print(f"{name} vs sequential: {dist[name]}; test accuracy by fold and epoch "
              f"{rows[name][..., 4].round(2).tolist()}")
    print(f"sequential test accuracy by fold and epoch {base[..., 4].round(2).tolist()}")
    print(json.dumps({"graphs": gs.num_graphs, "distance": dist, "seconds": seconds,
                      "rows": {k: v.tolist() for k, v in rows.items()},
                      "card": card() if device is None and torch.cuda.is_available()
                      else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
