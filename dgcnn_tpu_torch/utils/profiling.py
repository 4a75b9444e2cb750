"""Measurement helpers of the port: the probe's synthetic edge stream (a
NumPy copy of dgcnn_tpu/utils/profiling.py:62 `_batch_edges`), the
kernel-vs-plain tolerance, device times on the card by CUDA-graph replay,
and the least time of a call (its bound) on an H100.

Nothing here touches the card at import time; the timing helpers need
CUDA tensors and raise without them.
"""

from __future__ import annotations

import contextlib
import os
import subprocess

import numpy as np
import torch

# published H100 SXM peaks: fp32 outside the tensor cores, bf16 in them
# (dense), and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REPS = 10  # calls per captured graph
FLUSH_BYTES = 64 << 20  # over the H100's 50 MB L2
# fp32 kernel vs fp32 plain version, same inputs: the two sum the same
# products in different orders, so they differ by rounding only — about
# sqrt(n)·2^-24 relative for sums of n ≤ 56·2048 terms, far under 1e-4
# of the largest value. A wrong index or a missed tile is off by O(1).
RTOL, ATOL = 1e-4, 1e-6


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


@contextlib.contextmanager
def trace(logdir: str):
    """A `torch.profiler` trace of the enclosed run (the CLI's `--profile
    DIR`; the port of dgcnn_tpu/utils/profiling.py:51 `trace`): the host's
    ops, and the card's kernels where CUDA is present, written at the end
    as a Chrome trace `DIR/trace_<pid>.json` (one file a process, so the
    ranks of a mesh run do not overwrite each other's). The program's spans
    (train/metrics.py `SPANS`) are ranges of their names in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, that over the largest |want|, within RTOL/ATOL)."""
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    scale = want.double().abs().max().item() if want.numel() else 0.0
    return err, err / max(scale, ATOL), err <= ATOL + RTOL * scale


def _batch_edges(rng, num_nodes: int, num_edges: int, avg_graph_nodes: int = 30):
    """Block-diagonal-ish edge stream shaped like a real packed batch:
    contiguous graphs of ~avg_graph_nodes nodes with random intra-graph
    edges, dst-sorted, padded with w=0 edges (src 0 → dst num_nodes−1) to a
    multiple of 1024. Same draws, same bytes as the reference's."""
    src_l, dst_l = [], []
    base, budget = 0, num_edges
    while base < num_nodes and budget > 0:
        gn = max(4, int(rng.normal(avg_graph_nodes, avg_graph_nodes * 0.25)))
        gn = min(gn, num_nodes - base)
        ge = min(int(gn * num_edges / num_nodes), budget)
        if ge <= 0:
            break
        src_l.append(rng.integers(0, gn, ge) + base)
        dst_l.append(rng.integers(0, gn, ge) + base)
        base += gn
        budget -= ge
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    w = (rng.random(src.shape[0]).astype(np.float32) - 0.5) * 0.01
    pad = -len(src) % 1024
    if pad:
        src = np.r_[src, np.zeros(pad, np.int32)]
        dst = np.r_[dst, np.full(pad, num_nodes - 1, np.int32)]
        w = np.r_[w, np.zeros(pad, np.float32)]
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order], w[order]


def bound(nbytes: float, flops: float, bf16_flops: float = 0.0):
    """(least ms, "bytes" or "operations"): max(bytes / HBM rate, fp32
    operations / fp32 peak + operations on bf16 operands / bf16 peak)."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def trunk_bounds(s: int, t: int, k: int, dims, es: int = 4, round_h: bool = False):
    """(fwd, bwd) (least ms, by) of one GCN-trunk call on S slots of T rows,
    K weight sets, an adjacency of `es` bytes an element: each input read
    once, each output written once. The adjacency products are counted at
    the bf16 peak when the adjacency is bf16 (both operands are), the
    h @ W and chain products at the fp32 peak, or, with `round_h`, the
    forward's h @ W at the bf16 peak."""
    sd = sum(dims)
    pairs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    wbytes = 4 * k * (pairs + sd) + 4 * s
    p = pairs + sd  # per-slot gradient values the backward writes
    adj = es * s * t * t
    fwd_bytes = adj + 4 * (s * t * dims[0] + s * t + s * t * sd) + wbytes
    bwd_bytes = adj + 4 * (s * t + 2 * s * t * sd + s * t * dims[0] + s * p) + wbytes
    prop = 2.0 * s * t * t * sd
    hw = 2.0 * s * t * pairs
    on16 = es == 2
    return (bound(fwd_bytes, (0 if on16 else prop) + (0 if round_h else hw),
                  (prop if on16 else 0) + (hw if round_h else 0)),
            bound(bwd_bytes, (0 if on16 else prop) + 2 * hw, prop if on16 else 0))


def block_bounds(n_items: int, nb: int, f: int, es: int = 4, bs: int = 128):
    """(least ms, by) of one block propagation: each real item's block
    and source rows read once (`es` bytes an element, 2 in the bf16 mode),
    the [nb, bs, F] fp32 output written once; the products at the fp32
    peak, or the bf16 peak when the operands are bf16."""
    nbytes = n_items * (bs * bs * es + bs * f * es) + nb * bs * f * 4
    ops = 2.0 * n_items * bs * bs * f
    return bound(nbytes, 0.0, ops) if es == 2 else bound(nbytes, ops)


def spmm_bound(e_real, n, rows_read, f):
    """(least ms, by) of one SpMM, out [n, F] = A·x with A's real edges in
    CSR form: each edge's index and weight read once (8 bytes), the n + 1
    row pointers, the `rows_read` rows of x that some edge references
    (the padding rows no edge touches are never read), and all n rows of
    out written once; 2 operations per edge and column."""
    nbytes = e_real * 8 + (n + 1) * 4 + rows_read * f * 4 + n * f * 4
    return bound(nbytes, 2.0 * e_real * f)


def graph_ms(body, reps: int, replays: int) -> float:
    """ms per replay of a CUDA graph holding `reps` calls of `body`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up outside capture (first-use set-up, allocator)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            body()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / replays
    del graph
    return ms


class Flush:
    """A 64 MB write that evicts the 50 MB L2, and its own device time."""

    def __init__(self, device):
        self.buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        self.k = 0
        self.ms = graph_ms(self, REPS, 5) / REPS

    def __call__(self):
        self.k += 1
        self.buf.fill_(float(self.k % 7))


def device_ms(fn, flush: Flush = None, replays: int = 5) -> float:
    """Device time of one call of `fn`: `REPS` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events, so the host's
    launch rate is out of the number. Warm (operands left in L2 by the
    previous call) when `flush` is None, else after an L2 flush, net of
    the flush's own time."""
    if flush is None:
        return graph_ms(fn, REPS, replays) / REPS

    def body():
        flush()
        fn()

    return graph_ms(body, REPS, replays) / REPS - flush.ms


def events_ms(fn, reps: int = 20) -> float:
    """Back-to-back calls timed with CUDA events (an upper bound on the
    device time where the host issues slower than the card runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps
