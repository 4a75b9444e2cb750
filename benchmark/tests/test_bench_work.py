"""The work counts of benchmark/work on hand-counted graphs, and their
independence from the layout: graph order, batch split and the tile the
largest graph would set move nothing."""

import numpy as np
import pytest

from benchmark import work
from benchmark.work import dgcnn as dgcnn_work


def graphs(sizes_edges, f_in=2, classes=2):
    """A dataset from [(n, [(src, dst), ...]), ...]."""
    node_ptr = np.concatenate([[0], np.cumsum([n for n, _ in sizes_edges])])
    edge_ptr = np.concatenate([[0], np.cumsum([len(e) for _, e in sizes_edges])])
    src = np.array([s for _, e in sizes_edges for s, _ in e], dtype=np.int32)
    dst = np.array([d for _, e in sizes_edges for _, d in e], dtype=np.int32)
    return {"x": np.zeros((int(node_ptr[-1]), f_in), np.float32), "node_ptr": node_ptr,
            "edge_ptr": edge_ptr, "edge_src": src, "edge_dst": dst,
            "y": np.zeros(len(sizes_edges), np.int32), "num_classes": classes}


TRIANGLE = (3, [(0, 1), (1, 0), (1, 2), (2, 1), (0, 2), (2, 0)])
PAIR_WITH_LOOP = (2, [(0, 1), (1, 0), (0, 0)])  # the input self-loop is not an edge


def test_sizes():
    n, e = work.graph_sizes(graphs([TRIANGLE, PAIR_WITH_LOOP]))
    assert n.tolist() == [3, 2] and e.tolist() == [6, 2]


def test_triangle_by_hand():
    # layer 1: 2·(6+3)·4 + 2·3·2·4 = 120; layer 2: 2·9·1 + 2·3·4·1 = 42
    ops, nbytes = work.trunk_forward(np.array([3.0]), np.array([6.0]), 2, (4, 1))
    assert ops[0] == 162
    # x 4·3·2 + CSR (9·8 + 4·4) + outputs 4·3·5
    assert nbytes[0] == 24 + 88 + 60
    ops_b, bytes_b = work.trunk_backward(np.array([3.0]), np.array([6.0]), 2, (4, 1))
    assert ops_b[0] == 324 and bytes_b[0] == 88 + 24 + 120


def test_propagation_by_hand():
    # layer 1: 2·(6+3)·4 = 72; layer 2: 2·9·1 = 18
    ops, nbytes = work.propagation(np.array([3.0]), np.array([6.0]), (4, 1))
    assert ops[0] == 90
    # per layer CSR (9·8 + 4·4) and features in and out (2·4·3·F)
    assert nbytes[0] == (88 + 96) + (88 + 24)


def test_pair_by_hand():
    ops, nbytes = work.trunk_forward(np.array([2.0]), np.array([2.0]), 1, (1,))
    assert ops[0] == 2 * 4 * 1 + 2 * 2 * 1 * 1
    assert nbytes[0] == 8 + (4 * 8 + 3 * 4) + 8


def test_readout_by_hand():
    model = {"sort_pool_k": 30, "hidden_dims": [32, 32, 32, 1], "conv1d_channels": [16, 32],
             "conv1d_kernel": 5, "dense_dim": 128}
    assert dgcnn_work.readout_flops(model, 2) == (2 * 30 * 97 * 16 + 2 * 11 * 5 * 16 * 32
                                            + 2 * 11 * 32 * 128 + 2 * 128 * 2)


MODEL = {"sort_pool_k": 4, "hidden_dims": [4, 1], "conv1d_channels": [2, 2],
         "conv1d_kernel": 2, "dense_dim": 3}


def test_fold_epoch_counts_passes():
    g = graphs([TRIANGLE, PAIR_WITH_LOOP])
    w = dgcnn_work.fold_epoch(g, MODEL, [0], [1])
    fo, _ = work.trunk_forward(*work.graph_sizes(g), 2, (4, 1))
    bo, _ = work.trunk_backward(*work.graph_sizes(g), 2, (4, 1))
    ro = dgcnn_work.readout_flops(MODEL, 2)
    assert w["trunk_ops"] == fo[0] + bo[0] + fo[1]
    assert w["model_flops"] == 3 * (fo[0] + ro) + fo[1] + ro
    po, pb = work.propagation(*work.graph_sizes(g), (4, 1))
    assert w["prop_ops"] == 2 * po[0] + po[1] and w["prop_bytes"] == 2 * pb[0] + pb[1]


@pytest.mark.parametrize("order", ["shuffled", "padded_by_a_large_graph"])
def test_layout_does_not_move_the_count(order):
    rng = np.random.default_rng(0)
    base = [TRIANGLE, PAIR_WITH_LOOP] * 5
    g = graphs(base)
    train, test = np.arange(0, 8), np.arange(8, 10)
    want = dgcnn_work.fold_epoch(g, MODEL, train, test)
    if order == "shuffled":  # another epoch order and batch split
        got = dgcnn_work.fold_epoch(g, MODEL, rng.permutation(train), test[::-1])
    else:  # a larger graph in the dataset sets a larger tile for every batch
        big = (40, [(i, i + 1) for i in range(39)] + [(i + 1, i) for i in range(39)])
        got = dgcnn_work.fold_epoch(graphs(base + [big]), MODEL, train, test)
    assert got == want
