"""Byte-compare the artifacts of two training runs; the port's copy of
tools/diff_runs.py.

On one card the port's runs are bitwise deterministic (fixed generators,
the kernels' deterministic sums, one shuffle stream per fold). This tool
checks it in one command:

    python -m dgcnn_tpu_torch.cli --data_type MUTAG --synthetic --out_root runA
    python -m dgcnn_tpu_torch.cli --data_type MUTAG --synthetic --out_root runB
    python -m dgcnn_tpu_torch.tools.diff_runs runA/statistics runB/statistics

Exit code 0 = both runs produced the same files and every common CSV is
byte-identical; 1 otherwise, with a per-file report. JSONL event logs
are compared on their metric fields only (timestamps and wall times
differ between runs). Both drivers, sequential and lockstep, write one
`epoch` event per fold and epoch with the same metric fields (a lockstep
event adds `folds_in_lockstep`), so a lockstep run is compared fold by
fold; an event log with no metric row fails, so that two runs are never
found equal on nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

METRIC_KEYS = ("kind", "fold", "epoch", "train_loss", "test_loss",
               "train_accuracy", "test_accuracy")


def _events_metrics(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            rows.append(tuple(ev.get(k) for k in METRIC_KEYS))
    return rows


def _has_metrics(rows) -> bool:
    return any(r[0] == "epoch" and r[3] is not None for r in rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    args = p.parse_args(argv)

    ok = True
    names_a = sorted(os.listdir(args.dir_a))
    names_b = sorted(os.listdir(args.dir_b))
    for missing, where in ((set(names_a) - set(names_b), args.dir_b),
                           (set(names_b) - set(names_a), args.dir_a)):
        for n in sorted(missing):
            print(f"MISSING  {n} (not in {where})")
            ok = False

    for name in sorted(set(names_a) & set(names_b)):
        a, b = os.path.join(args.dir_a, name), os.path.join(args.dir_b, name)
        if not (os.path.isfile(a) and os.path.isfile(b)):
            continue
        if name.endswith(".jsonl"):
            ra, rb = _events_metrics(a), _events_metrics(b)
            same = ra == rb and _has_metrics(ra)
            label = ("metrics-identical" if same else "NO METRIC ROWS" if ra == rb
                     else "METRICS DIFFER")
        elif name.endswith(".png"):
            continue  # plots embed timestamps; covered by the CSVs
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                same = fa.read() == fb.read()
            label = "byte-identical" if same else "DIFFERS"
        print(f"{'OK      ' if same else 'FAIL    '}{name}: {label}")
        ok = ok and same

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
