"""The traced stretch: `torch.profiler` over it, its events kept in memory
(nothing is written to disk), reduced to what the per-layer metrics read.

The grouping is a copy of the port's `tools/summarize_trace.py`: the
card's events (kernels, copies, sets) apart from the host's (operators
and runtime calls), each side summed by name. Added here: the device's
busy time as the union of its event intervals (overlapping kernels count
once), the idle gaps between them labelled by the host event running at
the gap's start (the innermost one), and kernel counts and times by name,
which each metric attributes by its own name list.
"""

from __future__ import annotations

import collections
import time

import numpy as np


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# not host work: the card's user-annotation ranges (they span kernels)
SKIP_CATS = ("gpu_user_annotation",)


def events_of(prof) -> list:
    """(name, category, start_us, end_us) of every event the profiler kept,
    the category as a Chrome trace names it ("kernel", "cpu_op",
    "cuda_runtime", ...)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        if hasattr(ev, "activity_type"):
            cat = ev.activity_type()
        else:  # an older kineto: device events as kernels, annotations apart
            cat = ("gpu_user_annotation" if ev.is_user_annotation() else "kernel") \
                if ev.device_type() == DeviceType.CUDA else "cpu_op"
        out.append((ev.name(), cat, start, start + ev.duration_ns() / 1e3))
    return out


def profiled(fn, device):
    """Run `fn` under the profiler (host and card), synchronized at both
    ends. Returns (fn's result, events, wall seconds of the stretch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return out, events_of(prof), wall


def summarize(events, wall_s: float, top: int = 10) -> dict:
    """busy_s (union of device intervals), window_s, the kernels' count and
    {name: [count, seconds]}, the device's top ops by time and the idle
    time by host label."""
    dev = sorted((s, e, n, c) for n, c, s, e in events if c in DEVICE_CATS)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    by_name = collections.Counter()
    for s, e, n, c in dev:
        by_name[n] += (e - s) / 1e6
        if c == "kernel":
            kernels[n][0] += 1
            kernels[n][1] += (e - s) / 1e6
    merged = []
    for s, e, _, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    host = sorted((s, e, n) for n, c, s, e in events
                  if c not in DEVICE_CATS and c not in SKIP_CATS)
    starts = np.array([h[0] for h in host])
    idle = collections.Counter()
    at = np.searchsorted(starts, [g0 for g0, _ in gaps], side="right") - 1
    for (g0, g1), i in zip(gaps, at.tolist()):
        label = "(no host event)"
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= g0:
                label = host[j][2]
                break
        idle[label] += (g1 - g0) / 1e6
    return {"busy_s": busy, "window_s": wall_s,
            "kernels": {n: v for n, v in kernels.items()},
            "kernel_count": sum(v[0] for v in kernels.values()),
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def attributed(kernels: dict, names) -> float:
    """Seconds of the kernels whose name holds one of `names`."""
    return sum(v[1] for n, v in kernels.items() if any(k in n for k in names))


def names_beside(path: str) -> list:
    """The kernel names a roofline reader attributes to its kernels: one a
    line of the `.names` file at `path`, `#` lines left out."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def roofline_pct(ranks: list, names, ops_key: str, bytes_key: str):
    """The least time of the work `ranks[i]["work"][ops_key, bytes_key]`
    (benchmark/work) over the device time of the kernels named `names`,
    in %, over the ranks; None where no such kernel ran."""
    from benchmark.work import least_seconds

    ranks = [r for r in ranks if r]
    seconds = sum(attributed(r["kernels"], names) for r in ranks)
    if not seconds:
        return None
    least = sum(least_seconds(r["work"][ops_key], r["work"][bytes_key]) for r in ranks)
    return 100.0 * least / seconds
