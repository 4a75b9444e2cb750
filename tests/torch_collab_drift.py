"""COLLAB's multi-tile rows in both packages on the CPU, lockstep and
one-ulp-perturbed against the folds one after another (a helper script,
not a test file: it takes minutes).

    JAX_PLATFORMS=cpu python tests/torch_collab_drift.py [--graphs 2500]

Runs synthetic COLLAB (`--graphs` of it, seed 0) on the multi-tile layout,
2 folds x 4 epochs at batch 50, through each package's
`run_cross_validation` three times: the folds one after another, the
same with every initial weight scaled by (1 + 2^-22), and in lockstep.
Prints one JSON line: for each package, the lockstep and the perturbed
runs' largest distance from its sequential rows (losses; accuracies in
points) and every run's test accuracies by fold and epoch."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _rows(stats, folds):
    return np.stack([np.loadtxt(os.path.join(stats, f"COLLAB_results_{f}.csv"),
                                delimiter=",", skiprows=1, ndmin=2)
                     for f in range(1, folds + 1)])


def jax_run(graphs, mode, perturb, folds=2, epochs=4):
    import jax

    import dgcnn_tpu.train.cv as jcv
    from dgcnn_tpu.config import Config
    from dgcnn_tpu.data.synthetic import synthesize_tu_dataset

    gs = synthesize_tu_dataset("COLLAB", num_graphs=graphs, seed=0)
    real = jcv.init_params
    if perturb:
        jcv.init_params = lambda key, model: jax.tree_util.tree_map(
            lambda a: a * (1 + 2.0 ** -22), real(key, model))
    try:
        with tempfile.TemporaryDirectory() as td:
            jcv.run_cross_validation(Config(
                data_type="COLLAB", layout="multi", cv_parallel=mode, num_folds=folds,
                num_epochs=epochs, statistics_dir=f"{td}/s", epochs_dir=f"{td}/e",
                data_root=f"{td}/d"), dataset=gs)
            return _rows(f"{td}/s", folds)
    finally:
        jcv.init_params = real


def torch_run(graphs, mode, perturb, folds=2, epochs=4):
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.tools.probe_collab_drift import run

    gs = synthesize_tu_dataset("COLLAB", num_graphs=graphs, seed=0)
    return run(gs, mode, perturb, folds, epochs, "cpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--graphs", type=int, default=2500)
    args = p.parse_args(argv)
    out = {"graphs": args.graphs}
    for pkg, fn in (("jax", jax_run), ("torch", torch_run)):
        runs = {name: fn(args.graphs, mode, perturb) for name, mode, perturb in (
            ("sequential", "sequential", False), ("perturbed", "sequential", True),
            ("lockstep", "folds", False))}
        base = runs["sequential"]
        out[pkg] = {"test_accuracy": {k: v[..., 4].round(2).tolist() for k, v in runs.items()}}
        for name in ("perturbed", "lockstep"):
            d = np.abs(runs[name] - base)
            out[pkg][name] = {"loss": float(d[..., 1:3].max()),
                              "accuracy_pts": float(d[..., 3:5].max())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
