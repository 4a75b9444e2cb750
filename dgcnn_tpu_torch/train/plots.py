"""Training-curve plots — the visdom replacement; the port's copy of
dgcnn_tpu/train/plots.py (`render_curves` :31), plain Python and
matplotlib, imported when a curve is drawn.

The reference live-plots four windows (Train/Test Loss/Accuracy, one series
per fold) to a visdom server (reference train.py:122-125) and publishes the
screenshots (reference results/*.png). Here the same four panels render
offline from the per-fold CSVs to one PNG per dataset — no server process.

    python -m dgcnn_tpu_torch.train.plots --data_type MUTAG --statistics_dir statistics
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Dict, List


def _read_fold_csv(path: str) -> Dict[str, List[float]]:
    with open(path) as f:
        lines = f.read().strip().splitlines()
    cols = lines[0].split(",")[1:]
    out: Dict[str, List[float]] = {c: [] for c in cols}
    for line in lines[1:]:
        for c, v in zip(cols, line.split(",")[1:]):
            out[c].append(float(v))
    return out


def render_curves(statistics_dir: str, data_type: str, out_path: str = "") -> str:
    """Render the four reference panels from `<DS>_results_<fold>.csv` files;
    returns the written PNG path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # filter by the same regex the sort key uses: the glob alone also
    # admits names like <DS>_results_1_old.csv, whose non-match would
    # crash .group(1)
    pat = re.compile(r"_(\d+)\.csv$")
    paths = sorted(
        (
            p
            for p in glob.glob(
                os.path.join(statistics_dir, f"{data_type}_results_[0-9]*.csv")
            )
            if pat.search(p)
        ),
        key=lambda p: int(pat.search(p).group(1)),
    )
    if not paths:
        raise FileNotFoundError(
            f"no {data_type}_results_<fold>.csv under {statistics_dir}"
        )

    panels = [
        ("train_loss", "Train Loss", "NLL Loss"),
        ("train_accuracy", "Train Accuracy", "%"),
        ("test_loss", "Test Loss", "NLL Loss"),
        ("test_accuracy", "Test Accuracy", "%"),
    ]
    # parse each fold CSV once, not once per panel
    parsed = [(pat.search(p).group(1), _read_fold_csv(p)) for p in paths]
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    for ax, (col, title, ylabel) in zip(axes.ravel(), panels):
        for fold, rows in parsed:
            ax.plot(range(1, len(rows[col]) + 1), rows[col], label=f"Fold_{fold}",
                    linewidth=1.0)
        ax.set_title(title)
        ax.set_xlabel("Epoch")
        ax.set_ylabel(ylabel)
        ax.grid(alpha=0.3)
    axes[0, 0].legend(fontsize=7, ncol=2)
    fig.suptitle(data_type)
    fig.tight_layout()

    out_path = out_path or os.path.join(statistics_dir, f"{data_type}_curves.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="render training curves")
    p.add_argument("--data_type", required=True)
    p.add_argument("--statistics_dir", default="statistics")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    print(render_curves(args.statistics_dir, args.data_type, args.out))


if __name__ == "__main__":
    main()
