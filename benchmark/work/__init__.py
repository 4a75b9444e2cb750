"""The work a run's graphs need, counted from the graphs and the published
model alone, the same whatever kernel or layout computes it: padding,
recomputation and the layout's own tables are never counted. This module
holds the peaks and the GCN counts every family shares; a family's whole
count is `benchmark/work/<family>.py` (`fold_epoch`), found through
`benchmark/family.py`.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): 67 TFLOP/s
in float32 outside the tensor cores and 3.35 TB/s of HBM. Both assume
the card's full 700 W.

GCN trunk, per graph of N real nodes and E real directed edges (input
self-loops removed), with one self-loop a node added, per layer of width
F_in → F_out (the first layer's F_in the feature width):

    forward operations  2·(E + N)·F_out + 2·N·F_in·F_out
    backward            twice the forward's operations
    forward bytes       x read once (4·N·F), the normalized adjacency read
                        once as CSR ((E + N)·8 + (N + 1)·4), the
                        concatenated layer outputs written once (4·N·Σdims)
    backward bytes      the adjacency, x and the outputs read, the
                        outputs' gradient read (4·N·Σdims)

The weights (about 17 KB a call) are left out of the bytes. The trunk's
least time is the larger of its operations at the fp32 peak and its
bytes at the HBM rate, over all the passes counted together.

GCN propagation alone (Â · HW, what the block and SpMM kernels compute),
per graph and per layer of output width F, in each direction (the
backward pass propagates the gradient of HW once, through Âᵀ):

    operations          2·(E + N)·F
    bytes               the adjacency as CSR ((E + N)·8 + (N + 1)·4),
                        features in (4·N·F) and out (4·N·F)

summed over the layers. No 128×128 block fill and no padded slot is
counted."""

from __future__ import annotations

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def graph_sizes(graphs: dict) -> tuple:
    """(N, E) of every graph: real nodes, real directed edges."""
    n = np.diff(graphs["node_ptr"]).astype(np.float64)
    counts = np.diff(graphs["edge_ptr"])
    edge_graph = np.repeat(np.arange(len(counts)), counts)
    loops = np.bincount(edge_graph[graphs["edge_src"] == graphs["edge_dst"]],
                        minlength=len(counts))
    return n, (counts - loops).astype(np.float64)


def trunk_forward(n, e, f_in: int, dims) -> tuple:
    """(operations, bytes) of one forward pass, per graph."""
    ops, d_in = 0.0, f_in
    for d in dims:
        ops = ops + 2.0 * (e + n) * d + 2.0 * n * d_in * d
        d_in = d
    adj = (e + n) * 8.0 + (n + 1) * 4.0
    return ops, 4.0 * n * f_in + adj + 4.0 * n * sum(dims)


def trunk_backward(n, e, f_in: int, dims) -> tuple:
    ops, _ = trunk_forward(n, e, f_in, dims)
    adj = (e + n) * 8.0 + (n + 1) * 4.0
    return 2.0 * ops, adj + 4.0 * n * f_in + 2 * 4.0 * n * sum(dims)


def propagation(n, e, dims) -> tuple:
    """(operations, bytes) of one direction's propagations over the layers
    of output widths `dims`, per graph."""
    ops = nbytes = 0.0
    for d in dims:
        ops = ops + 2.0 * (e + n) * d
        nbytes = nbytes + (e + n) * 8.0 + (n + 1) * 4.0 + 2 * 4.0 * n * d
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
