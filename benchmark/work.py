"""The work a run's graphs need, counted from the graphs and the published
model alone, the same whatever kernel or layout computes it: padding,
recomputation and the layout's own tables are never counted.

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

Model FLOPs, per graph forward: the trunk's operations, conv5 (one 97 →
16 product a sort-pooled row, k rows), conv6 (width 5, 16 → 32, k/2 − 4
positions), lin1 and lin2. A training pass counts three times its
forward, an evaluation pass once."""

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


def readout_flops(model: dict, num_classes: int) -> float:
    k, dims = model["sort_pool_k"], model["hidden_dims"]
    c5, c6 = model["conv1d_channels"]
    w, dense = model["conv1d_kernel"], model["dense_dim"]
    t6 = k // 2 - w + 1
    return (2.0 * k * sum(dims) * c5 + 2.0 * t6 * w * c5 * c6
            + 2.0 * t6 * c6 * dense + 2.0 * dense * num_classes)


def fold_epoch(graphs: dict, model: dict, train_ids, test_ids) -> dict:
    """One fold-epoch's work: every training graph once forward and
    backward, every test graph once forward."""
    n, e = graph_sizes(graphs)
    f_in, dims = graphs["x"].shape[1], model["hidden_dims"]
    tr, te = np.asarray(train_ids), np.asarray(test_ids)
    fo, fb = trunk_forward(n, e, f_in, dims)
    bo, bb = trunk_backward(n, e, f_in, dims)
    ro = readout_flops(model, int(graphs["num_classes"]))
    return {"trunk_ops": float(fo[tr].sum() + bo[tr].sum() + fo[te].sum()),
            "trunk_bytes": float(fb[tr].sum() + bb[tr].sum() + fb[te].sum()),
            "model_flops": float(3.0 * (fo[tr].sum() + len(tr) * ro)
                                 + fo[te].sum() + len(te) * ro)}


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
