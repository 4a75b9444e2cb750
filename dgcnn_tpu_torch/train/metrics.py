"""Metrics writers — the observability layer.

Replaces the reference's visdom live plots + pandas CSVs (reference
train.py:80,122-125,130-131,144-145) with server-free artifacts:

  * per-fold CSV `statistics/<DS>_results_<fold>.csv` with the same columns
    and index label as the reference (epoch, train_loss, test_loss,
    train_accuracy, test_accuracy);
  * overall CSV `statistics/<DS>_results_overall.csv` (fold-indexed);
  * an append-only JSONL event stream (`statistics/<DS>_events.jsonl`) with
    throughput fields (edges/s, step time) the reference never had.

A copy of dgcnn_tpu/train/metrics.py (plain Python), so the port writes
the same artifacts with the same columns.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple


class FoldMetrics:
    """Accumulates per-epoch metrics for one fold (reference
    train.py:113-121)."""

    COLUMNS = ("train_loss", "test_loss", "train_accuracy", "test_accuracy")

    def __init__(self):
        self.rows: Dict[str, List[float]] = {c: [] for c in self.COLUMNS}

    def append(self, train_loss, test_loss, train_acc, test_acc):
        self.rows["train_loss"].append(float(train_loss))
        self.rows["test_loss"].append(float(test_loss))
        self.rows["train_accuracy"].append(float(train_acc))
        self.rows["test_accuracy"].append(float(test_acc))

    def last(self, column: str) -> float:
        return self.rows[column][-1]

    def to_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("epoch," + ",".join(self.COLUMNS) + "\n")
            for i in range(len(self.rows["train_loss"])):
                vals = ",".join(str(self.rows[c][i]) for c in self.COLUMNS)
                f.write(f"{i + 1},{vals}\n")


def completed_fold_accuracies(csv_path: str, num_epochs: int
                              ) -> Optional[Tuple[float, float]]:
    """If a fold CSV already holds `num_epochs` rows, its last epoch's
    (train_acc, test_acc), so that `--resume` can skip the fold (the
    reference's `_completed_fold_accuracies`, dgcnn_tpu/train/cv.py:218)."""
    if not os.path.exists(csv_path):
        return None
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    if len(lines) != num_epochs + 1:
        return None
    last = lines[-1].split(",")
    return float(last[3]), float(last[4])


def write_overall_csv(path: str, train_accs: List[float], test_accs: List[float]):
    """`statistics/<DS>_results_overall.csv` (reference train.py:144-145)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("fold,train_accuracy,test_accuracy\n")
        for i, (tr, te) in enumerate(zip(train_accs, test_accs), start=1):
            f.write(f"{i},{tr},{te}\n")


class EventLog:
    """Append-only JSONL event stream for programmatic observability."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, **event) -> None:
        if not self.path:
            return
        event.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")
