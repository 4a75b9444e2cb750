"""Run the full reference protocol (100 epochs x 10-fold CV, batch 50,
seed 324) on the port for the given datasets and append one summary JSON
line each: the input of `release_report`. The port's copy of
tools/release_validation.py.

    python -m dgcnn_tpu_torch.tools.release_validation --out_root release \
        MUTAG PTC_MR NCI1 PROTEINS DD COLLAB IMDB-BINARY IMDB-MULTI
    python -m dgcnn_tpu_torch.tools.release_report release > RESULTS.md

Runs on the card; `--platform cpu` runs the plain PyTorch path on the
CPU, and without a card the run raises. Artifacts land under
<out_root>/{statistics,epochs}, summaries in <out_root>/summary.jsonl.
Each line carries the reference's keys, and beside them the card
(`nvidia-smi`'s name and power limit), the device, the `layout` and
`cv_parallel` the run resolved (its `run_start` event), the depth, and
the kernels' launches over the run (each wrapper's counts, replays
counted: `train/loop.py CountedGraph`).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from dgcnn_tpu_torch.config import DATASETS, Config
from dgcnn_tpu_torch.train.cv import resolve_device, run_cross_validation
from dgcnn_tpu_torch.train.loop import KERNEL_COUNTERS
from dgcnn_tpu_torch.utils.profiling import card_line


def kernel_counts() -> dict:
    """Each kernel's launch counts as they stand (replays counted)."""
    return {name: dict(vars(c)) for name, c in KERNEL_COUNTERS.items()}


def launches_since(before: dict) -> dict:
    """The counters' growth since `before`, kernels that launched only."""
    out = {}
    for name, now in kernel_counts().items():
        grown = {k: v - before[name][k] for k, v in now.items() if v != before[name][k]}
        if grown:
            out[name] = grown
    return out


def run_start(events_path: str) -> dict:
    """The last `run_start` event of an event log (a resumed run appends)."""
    start = {}
    with open(events_path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("kind") == "run_start":
                start = ev
    return start


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("datasets", nargs="+", choices=list(DATASETS))
    p.add_argument("--out_root", default="release")
    p.add_argument("--data_root", default=None,
                   help="dataset root (default <out_root>/data)")
    p.add_argument("--num_epochs", default=100, type=int)
    p.add_argument("--resume", action="store_true",
                   help="skip what a previous run under the same --out_root "
                        "finished: a dataset whose folds are all complete is "
                        "not trained again; the sequential driver skips "
                        "complete folds; a lockstep run writes its folds at "
                        "its end, so one that was cut trains again from "
                        "epoch 1 (no in-flight bundles are written here), "
                        "and one left partly complete by a sequential run "
                        "is finished one fold after another")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype (bfloat16: matmul operands and layer "
                        "outputs in bf16, parameters, loss and Adam fp32)")
    p.add_argument("--adj_dtype", default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="adjacency and block-pool storage dtype "
                        "(Config.adj_dtype). auto is float32 on the port, a "
                        "deliberate divergence from the reference, whose auto "
                        "stores bf16: the card's fp32 products do not round "
                        "their operands to bf16")
    p.add_argument("--block_impl", default="auto", choices=["auto", "xla", "pallas"],
                   help="block-sparse propagation kernel (Config.block_impl)")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the card (raises when CUDA is absent); cpu = "
                        "the plain PyTorch path on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    card = card_line() if device.type == "cuda" else None
    os.makedirs(args.out_root, exist_ok=True)
    for ds in args.datasets:
        cfg = Config(
            data_type=ds,
            num_epochs=args.num_epochs,
            data_root=args.data_root or os.path.join(args.out_root, "data"),
            epochs_dir=os.path.join(args.out_root, "epochs"),
            statistics_dir=os.path.join(args.out_root, "statistics"),
            checkpoint_resume=args.resume,
            compute_dtype=args.dtype,
            adj_dtype=args.adj_dtype,
            block_impl=args.block_impl,
        )
        before = kernel_counts()
        t0 = time.perf_counter()
        r = run_cross_validation(cfg, allow_synthetic=True, device=device)
        wall = time.perf_counter() - t0
        start = run_start(os.path.join(cfg.statistics_dir, f"{ds}_events.jsonl"))
        with open(os.path.join(args.out_root, "summary.jsonl"), "a") as f:
            f.write(json.dumps({
                "dataset": ds,
                "dtype": args.dtype,
                "adj_dtype": args.adj_dtype,
                "block_impl": args.block_impl,
                "wall_s": wall,
                "test_acc_mean": r["test_accuracy_mean"],
                "test_acc_std": r["test_accuracy_std"],
                "train_acc_mean": r["train_accuracy_mean"],
                "card": card,
                "device": str(device),
                "layout": start.get("layout"),
                "cv_parallel": start.get("cv_parallel"),
                "num_epochs": cfg.num_epochs,
                "num_folds": cfg.num_folds,
                "launches": launches_since(before),
            }) + "\n")
        print(ds, "done", f"{wall:.1f}", "s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
