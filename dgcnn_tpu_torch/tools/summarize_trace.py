"""Summarize a `--profile DIR` trace into top-op tables; the port's copy
of tools/summarize_trace.py, for the Chrome trace that `torch.profiler`
writes (`utils/profiling.py trace`: `DIR/trace_<pid>.json`, one file a
process, so one a rank of a mesh run).

Reads the newest trace under DIR (or the one of `--pid`), groups its
complete events by name, the card's (kernels, copies and sets) apart
from the host's (ATen ops) and from the program's own spans (train/
metrics.py `SPANS`: the trace's user annotations, `engine.build`,
`fold.begin`, `runner.replay`, ...), and prints the top-N of each by
total duration with its share of that side's busy time, and the span the
events cover.

    python -m dgcnn_tpu_torch.tools.summarize_trace prof [--top 30] [--pid PID]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SIDES = ("device", "host", "spans")
# the program's span names (train/metrics.py `SPANS`): some torch versions
# file a host annotation as a "cpu_op", others as a "user_annotation"
SPAN_PREFIXES = ("engine.", "fold.", "runner.", "mesh.")


def side_of(event: dict):
    """The side a complete event is tabled on, or None (runtime calls, the
    card's annotation ranges, flows)."""
    cat = event.get("cat")
    if cat in DEVICE_CATS:
        return "device"
    if cat == "user_annotation" or (
            cat == "cpu_op" and event.get("name", "").startswith(SPAN_PREFIXES)):
        return "spans"
    return "host" if cat == "cpu_op" else None


def find_trace(logdir: str, pid=None) -> str:
    """`logdir/trace_<pid>.json`, or the newest trace there."""
    if pid is not None:
        path = os.path.join(logdir, f"trace_{pid}.json")
        if not os.path.exists(path):
            raise SystemExit(f"no {path}")
        return path
    paths = glob.glob(os.path.join(logdir, "trace_*.json"))
    if not paths:
        raise SystemExit(f"no trace_*.json under {logdir}")
    return max(paths, key=os.path.getmtime)


def summarize(path: str) -> dict:
    """side ("device" / "host" / "spans") → {"ops": [(name, total_us,
    calls)] by total descending, "busy_us", "span_us"}."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {}
    for side in SIDES:
        total, calls = collections.Counter(), collections.Counter()
        t_min, t_max = float("inf"), float("-inf")
        for e in events:
            if e.get("ph") != "X" or side_of(e) != side:
                continue
            dur = float(e.get("dur", 0.0))
            total[e.get("name", "?")] += dur
            calls[e.get("name", "?")] += 1
            ts = float(e.get("ts", 0.0))
            t_min, t_max = min(t_min, ts), max(t_max, ts + dur)
        out[side] = {"ops": [(n, d, calls[n]) for n, d in total.most_common()],
                     "busy_us": sum(total.values()),
                     "span_us": max(t_max - t_min, 0.0)}
    return out


def table(side: str, s: dict, top: int) -> str:
    # a host op's (or span's) time holds the ops it calls, so the host's sum
    # passes its span
    busy = "busy" if side == "device" else "summed (nested ops in each)"
    lines = [f"# {side}: {len(s['ops'])} distinct ops, {busy} {s['busy_us'] / 1e3:.3f} ms "
             f"over a {s['span_us'] / 1e3:.3f} ms span"]
    if not s["ops"]:
        return lines[0] + " (no events)"
    lines.append(f"{'op':60s} {'total_ms':>10s} {'calls':>7s} {'%busy':>6s}")
    for name, dur, n in s["ops"][:top]:
        lines.append(f"{name[:60]:60s} {dur / 1e3:10.3f} {n:7d} "
                     f"{dur / max(s['busy_us'], 1e-9) * 100:6.1f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("logdir")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--pid", type=int, default=None,
                   help="the process (a mesh rank) whose trace to read; "
                        "default the newest")
    args = p.parse_args(argv)
    path = find_trace(args.logdir, args.pid)
    s = summarize(path)
    print(f"# {path}")
    for side in SIDES:
        print(table(side, s[side], args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
