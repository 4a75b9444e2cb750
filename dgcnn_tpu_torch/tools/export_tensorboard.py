"""Export training event logs to TensorBoard event files; the port's copy
of tools/export_tensorboard.py, over `train/tensorboard.py export_events`
(needs tensorboardX).

    python -m dgcnn_tpu_torch.tools.export_tensorboard \
        statistics/MUTAG_events.jsonl [...] --logdir runs

Then: `tensorboard --logdir runs`. One run directory per fold
(`<logdir>/<DS>/fold_<k>`); a (fold, epoch) that a resumed run wrote
twice is exported once, the last written.
"""

from __future__ import annotations

import argparse

from dgcnn_tpu_torch.train.tensorboard import export_events


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("events", nargs="+", help="statistics/<DS>_events.jsonl files")
    p.add_argument("--logdir", default="runs")
    args = p.parse_args(argv)
    for path in args.events:
        n = export_events(path, args.logdir)
        print(f"{path}: {n} scalar points -> {args.logdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
