"""DGCNN's work count (benchmark/work/__init__.py has the trunk's and the
propagation's equations and the peaks).

Model FLOPs, per graph forward: the trunk's operations, conv5 (one 97 →
16 product a sort-pooled row, k rows), conv6 (width 5, 16 → 32, k/2 − 4
positions), lin1 and lin2. A training pass counts three times its
forward, an evaluation pass once. The propagation is counted forward and
backward for a training graph, forward for a test graph."""

from __future__ import annotations

import numpy as np

from benchmark.work import graph_sizes, propagation, trunk_backward, trunk_forward


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
    po, pb = propagation(n, e, dims)
    ro = readout_flops(model, int(graphs["num_classes"]))
    return {"trunk_ops": float(fo[tr].sum() + bo[tr].sum() + fo[te].sum()),
            "trunk_bytes": float(fb[tr].sum() + bb[tr].sum() + fb[te].sum()),
            "model_flops": float(3.0 * (fo[tr].sum() + len(tr) * ro)
                                 + fo[te].sum() + len(te) * ro),
            "prop_ops": float(2.0 * po[tr].sum() + po[te].sum()),
            "prop_bytes": float(2.0 * pb[tr].sum() + pb[te].sum())}
