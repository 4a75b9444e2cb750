"""Fold-epoch seconds of one cross-validation run, graphed or eager.

    python dgcnn_tpu_torch/tools/probe_epoch_seconds.py [--data_type DD]
        [--layout coo] [--spmm auto] [--dtype float32] [--folds 2]
        [--epochs 4] [--eager] [--platform cpu]

Runs `run_cross_validation` on synthetic `--data_type`, `--folds` x
`--epochs` at batch 50 in chunks of `max_fused_epochs` 2 (chip_smoke.py's
runs), every epoch eager under `--eager`, on the card unless `--platform
cpu`. Prints one JSON line: the package it ran (its path), each epoch's
(fold, epoch, seconds) from the run's event log, the run's wall seconds
and, on the card, its name and power limit. To compare two trees of the
repository on one card, run this file with each tree's root first on
`PYTHONPATH`: it imports whichever `dgcnn_tpu_torch` comes first."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def card() -> str:
    """`nvidia-smi`'s name and power limit of the first card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_type", default="DD")
    p.add_argument("--layout", default="coo")
    p.add_argument("--spmm", default="auto")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--folds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--eager", action="store_true", help="no CUDA-graph replays")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"])
    args = p.parse_args(argv)

    import dgcnn_tpu_torch
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.cv import run_cross_validation

    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(data_type=args.data_type, num_folds=args.folds,
                     num_epochs=args.epochs, batch_size=50, max_fused_epochs=2,
                     layout=args.layout, spmm_impl=args.spmm,
                     compute_dtype=args.dtype, data_root=os.path.join(tmp, "data"),
                     statistics_dir=os.path.join(tmp, "statistics"),
                     epochs_dir=os.path.join(tmp, "epochs"))
        t0 = time.perf_counter()
        run_cross_validation(cfg, allow_synthetic=True,
                             device="cpu" if args.platform == "cpu" else None,
                             graphs=not args.eager)
        wall = time.perf_counter() - t0
        with open(os.path.join(cfg.statistics_dir, f"{cfg.data_type}_events.jsonl")) as f:
            events = [json.loads(line) for line in f]
    print(json.dumps({
        "package": os.path.dirname(os.path.abspath(dgcnn_tpu_torch.__file__)),
        "eager": args.eager,
        "epoch_seconds": [(e["fold"], e["epoch"], e["epoch_seconds"])
                          for e in events if e["kind"] == "epoch"],
        "wall_s": wall,
        "card": None if args.platform == "cpu" else card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
