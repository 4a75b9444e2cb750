"""TensorBoard export of the JSONL event stream; the port's copy of
dgcnn_tpu/train/tensorboard.py (`export_events` :23), plain Python and
tensorboardX, imported when the export runs.

The reference plots four live per-fold series to a visdom server (reference
train.py:80,122-125: Train/Test Loss/Accuracy, env per dataset). This build
logs the same metrics serverlessly (CSV + JSONL + PNG — train/metrics.py);
this module additionally materializes them as TensorBoard event files, the
SURVEY §5 visdom replacement, from the already-written
`statistics/<DS>_events.jsonl` — a pure post-hoc conversion, so the hot
training path never takes a TensorBoard dependency.

Layout mirrors visdom's per-fold line series: one TB run directory per fold
(`<logdir>/<DS>/fold_<k>`), scalars `train_loss`, `test_loss`,
`train_accuracy`, `test_accuracy` stepped by epoch, plus the throughput
scalars (`edges_per_second`, `epoch_seconds`) the reference never had.
"""

from __future__ import annotations

import json
import os


def export_events(events_path: str, logdir: str) -> int:
    """Convert one `<DS>_events.jsonl` into TensorBoard event files under
    `<logdir>/<DS>/fold_<k>/`. Returns the number of scalar points written.
    Lazy-imports tensorboardX so training environments without it are
    unaffected."""
    from tensorboardX import SummaryWriter

    ds = os.path.basename(events_path).split("_events")[0]
    # the event stream is APPEND-ONLY: a crash inside a fused chunk that
    # postdates the last checkpoint makes --resume replay (and re-append)
    # those epochs, so (fold, epoch) can occur twice — keep the LAST
    # occurrence (the replayed, authoritative one)
    latest = {}
    with open(events_path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("kind") != "epoch":
                continue
            latest[(int(ev["fold"]), int(ev["epoch"]))] = ev

    writers = {}
    points = 0
    try:
        for (fold, epoch), ev in sorted(latest.items()):
            w = writers.get(fold)
            if w is None:
                w = writers[fold] = SummaryWriter(
                    logdir=os.path.join(logdir, ds, f"fold_{fold}")
                )
            ts = ev.get("ts")
            for tag in ("train_loss", "test_loss", "train_accuracy",
                        "test_accuracy", "edges_per_second",
                        "epoch_seconds"):
                if tag in ev:
                    w.add_scalar(tag, float(ev[tag]), global_step=epoch,
                                 walltime=ts)
                    points += 1
    finally:
        for w in writers.values():
            w.close()
    return points
