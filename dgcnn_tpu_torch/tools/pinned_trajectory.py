"""The port's pinned-trajectory regression artifact; its copy of
tools/pinned_trajectory.py.

The coarse learnability gates (≥70 % on planted-signal synthetics)
cannot see a bug that costs a few accuracy points. This module pins the
exact 20-epoch per-fold trajectory (the per-epoch loss / accuracy CSVs,
reference train.py:113-136) of a fixed-seed synthetic MUTAG run on the
dense and block fold-lockstep engines, the reference's configuration.
Any edit that changes the math shifts the trajectory and trips
tests/test_torch_pinned_trajectory.py.

The port draws its init and dropout from its own generators, so its
artifacts (`dgcnn_tpu_torch/assets/pinned_trajectory/`) are not the
reference's; the JAX-held case of that test ties the port to the
reference on the same configuration from the reference's weights.

It runs on the card unless given `--platform cpu`, and without a card it
raises. The two have artifact sets of their own: the card's dropout is
drawn on the card (a CUDA generator), so its trajectory is not the
CPU's. On the card (`card/`, made on an NVIDIA H100 80GB HBM3) the run
goes through the trunk and CSR block kernels, the path the kernels'
later changes must keep; card runs are bitwise repeatable. On the CPU
(the directory's top level) it runs the plain PyTorch path at one
intra-op thread, the thread count of the port's tests
(tests/torch_threads.py), since the count moves CPU bits; that set is
what tests/test_torch_pinned_trajectory.py holds.

Regenerate only after an intended change to the math, and say so in
CHANGES.md:

    python -m dgcnn_tpu_torch.tools.pinned_trajectory --write
    python -m dgcnn_tpu_torch.tools.pinned_trajectory --write --platform cpu

Without `--write` it prints MATCH or DIFFERS for each artifact of its
platform (within the test's rtol 1e-4, atol 1e-6), and exits 1 on a
difference.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.train.cv import resolve_device, run_cross_validation

ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "assets", "pinned_trajectory")
LAYOUTS = ("dense", "block")
NUM_FOLDS = 2
NUM_EPOCHS = 20
THREADS = 1
RTOL, ATOL = 1e-4, 1e-6


def pinned_config(layout: str, workdir: str, **over) -> Config:
    """The reference's pinned configuration (tools/pinned_trajectory.py
    :53-66) on `layout`, its artifacts under `workdir/<layout>`."""
    return Config(**{**dict(
        data_type="MUTAG", batch_size=16, num_epochs=NUM_EPOCHS, seed=324,
        num_folds=NUM_FOLDS, layout=layout, cv_parallel="folds",
        data_root=os.path.join(workdir, "data"),
        epochs_dir=os.path.join(workdir, layout, "epochs"),
        statistics_dir=os.path.join(workdir, layout, "statistics"),
        graph_pad_multiple=4), **over})


def pinned_dataset():
    return synthesize_tu_dataset("MUTAG", num_graphs=40, seed=5)


def run_pinned(layout: str, workdir: str, device=None) -> dict:
    """Run the pinned configuration on `layout` fold-lockstep on `device`
    (the card unless "cpu"; the CPU at `THREADS` intra-op threads); returns
    {fold: csv_text} of the per-fold statistics CSVs."""
    device = resolve_device(device)
    if device.type == "cpu":
        torch.set_num_threads(THREADS)
    cfg = pinned_config(layout, workdir)
    run_cross_validation(cfg, dataset=pinned_dataset(), device=device)
    out = {}
    for fold in range(1, NUM_FOLDS + 1):
        with open(os.path.join(cfg.statistics_dir, f"MUTAG_results_{fold}.csv")) as f:
            out[fold] = f.read()
    return out


def artifact_path(layout: str, fold: int, device="cpu") -> str:
    """The artifact of `layout`'s fold on the CPU, or on the card under
    `card/`."""
    sub = () if torch.device(device).type == "cpu" else ("card",)
    return os.path.join(ARTIFACT_DIR, *sub, f"MUTAG_{layout}_fold{fold}.csv")


def parse_csv(text: str) -> np.ndarray:
    """A fold CSV's rows (epoch and the four metric columns) as floats."""
    rows = [r.split(",") for r in text.strip().splitlines()[1:]]
    return np.array([[float(x) for x in r] for r in rows])


def matches(have: str, want: str) -> bool:
    a, b = parse_csv(have), parse_csv(want)
    return a.shape == b.shape and np.allclose(a, b, rtol=RTOL, atol=ATOL)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--write", action="store_true",
                   help="regenerate the platform's artifacts (after an intended "
                        "change to the math only)")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the card and its artifacts (raises when CUDA is "
                        "absent); cpu = the plain PyTorch path and the CPU's")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    ok = True
    with tempfile.TemporaryDirectory() as td:
        for layout in LAYOUTS:
            for fold, text in run_pinned(layout, td, device).items():
                path = artifact_path(layout, fold, device)
                if args.write:
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "w") as f:
                        f.write(text)
                    print(f"wrote {path}")
                    continue
                with open(path) as f:
                    same = matches(text, f.read())
                ok = ok and same
                print(f"{path}: {'MATCH' if same else 'DIFFERS'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
