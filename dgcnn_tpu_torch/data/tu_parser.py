"""TU-Dortmund graph-kernel dataset format: parser, writer, and the
feature-assembly contract.

Replaces PyG's `TUDataset` raw parsing plus the `Indegree` pre-transform
(reference train.py:81-87, utils.py:5-36). File format (one directory,
prefix `<name>_`):

    <name>_A.txt                "i, j" 1-based GLOBAL node-id pairs (directed COO)
    <name>_graph_indicator.txt  1-based graph id of each node (nodes contiguous)
    <name>_graph_labels.txt     one label per graph (arbitrary ints)
    <name>_node_labels.txt      one int per node                      [optional]
    <name>_node_attributes.txt  comma-separated floats per node       [optional]
    <name>_edge_labels.txt      present in some datasets; unused by the model
                                (reference model consumes only x/edge_index —
                                model.py:27)

Feature assembly (SURVEY §2d; reference README.md:44-45):
    x = [ node_attrs ‖ one-hot(node_labels) ‖ normalized in-degree ]
with the degree column normalized by the PER-GRAPH max — the reference's
`Indegree` runs as a per-`Data` pre_transform, so `deg /= deg.max()`
(utils.py:22-23) sees one graph at a time despite its docstring saying
"globally normalized" (SURVEY §3.5).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dgcnn_tpu_torch.data.graphset import GraphSet


def _one_hot(labels: np.ndarray) -> np.ndarray:
    """One-hot with PyG's exact semantics (read_tu_data): min-shift, then
    one column per value in [0, max-min] — NON-OCCURRING intermediate
    labels still get (all-zero) columns, so the feature width is
    max-min+1, not the number of distinct values. The 8 reference
    datasets have contiguous label sets, where both definitions agree;
    this keeps the parity contract for arbitrary TU datasets too."""
    shifted = np.asarray(labels) - int(np.min(labels))
    width = int(shifted.max()) + 1
    out = np.zeros((len(labels), width), dtype=np.float32)
    out[np.arange(len(labels)), shifted] = 1.0
    return out


def assemble_features(
    total_nodes: int,
    node_ptr: np.ndarray,
    local_dst: np.ndarray,
    edge_ptr: np.ndarray,
    node_labels: Optional[np.ndarray],
    node_attrs: Optional[np.ndarray],
) -> np.ndarray:
    """Build the [N, F] feature matrix from parsed pieces.

    In-degree counts `edge_dst` occurrences over the RAW edge list — before
    any self-loop stripping, matching the reference where `Indegree` is a
    dataset pre_transform (utils.py:19-20) but `remove_self_loops` happens
    later inside the forward pass (model.py:28).
    """
    node_ptr = np.asarray(node_ptr, dtype=np.int64)
    edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
    num_graphs = len(node_ptr) - 1

    # graph id of each edge, local→global dst, global in-degree count
    edge_graph = np.repeat(np.arange(num_graphs), np.diff(edge_ptr))
    global_dst = np.asarray(local_dst, dtype=np.int64) + node_ptr[edge_graph]
    deg = np.bincount(global_dst, minlength=total_nodes).astype(np.float32)

    # per-graph max normalization (reference utils.py:22-23)
    node_graph = np.repeat(np.arange(num_graphs), np.diff(node_ptr))
    per_graph_max = np.zeros(num_graphs, dtype=np.float32)
    np.maximum.at(per_graph_max, node_graph, deg)
    deg = deg / np.maximum(per_graph_max, 1e-12)[node_graph]

    cols = []
    if node_attrs is not None:
        cols.append(np.asarray(node_attrs, dtype=np.float32).reshape(total_nodes, -1))
    if node_labels is not None:
        cols.append(_one_hot(np.asarray(node_labels)))
    cols.append(deg[:, None])
    return np.concatenate(cols, axis=1)


def _read_int_lines(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([int(float(t)) for t in f.read().split()], dtype=np.int64)


def parse_tu_dir(raw_dir: str, name: str, use_node_attr: bool = True) -> GraphSet:
    """Parse one TU-format directory into a GraphSet (features assembled)."""
    p = lambda suffix: os.path.join(raw_dir, f"{name}_{suffix}.txt")

    indicator = _read_int_lines(p("graph_indicator")) - 1  # 0-based graph ids
    total_nodes = len(indicator)
    num_graphs = int(indicator.max()) + 1
    counts = np.bincount(indicator, minlength=num_graphs)
    node_ptr = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(counts, out=node_ptr[1:])
    if not (np.sort(indicator) == indicator).all():
        raise ValueError(f"{name}: graph_indicator not contiguous")

    pairs = np.loadtxt(p("A"), delimiter=",", dtype=np.int64, ndmin=2)
    if pairs.size == 0:
        pairs = pairs.reshape(0, 2)
    g_src, g_dst = pairs[:, 0] - 1, pairs[:, 1] - 1  # 0-based global node ids
    edge_graph = indicator[g_src]
    if not (edge_graph == indicator[g_dst]).all():
        raise ValueError(f"{name}: edge crosses graph boundary")
    # group edges by graph (stable: keeps file order within a graph)
    order = np.argsort(edge_graph, kind="stable")
    g_src, g_dst, edge_graph = g_src[order], g_dst[order], edge_graph[order]
    e_counts = np.bincount(edge_graph, minlength=num_graphs)
    edge_ptr = np.zeros(num_graphs + 1, dtype=np.int64)
    np.cumsum(e_counts, out=edge_ptr[1:])
    edge_src = (g_src - node_ptr[edge_graph]).astype(np.int32)
    edge_dst = (g_dst - node_ptr[edge_graph]).astype(np.int32)

    raw_y = _read_int_lines(p("graph_labels"))
    if len(raw_y) != num_graphs:
        raise ValueError(f"{name}: {len(raw_y)} labels for {num_graphs} graphs")
    classes, y = np.unique(raw_y, return_inverse=True)

    node_labels = (
        _read_int_lines(p("node_labels"))
        if os.path.exists(p("node_labels"))
        else None
    )
    node_attrs = None
    if use_node_attr and os.path.exists(p("node_attributes")):
        node_attrs = np.loadtxt(
            p("node_attributes"), delimiter=",", dtype=np.float32, ndmin=2
        )

    x = assemble_features(
        total_nodes, node_ptr, edge_dst, edge_ptr, node_labels, node_attrs
    )
    return GraphSet(
        x=x,
        node_ptr=node_ptr,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_ptr=edge_ptr,
        y=y.astype(np.int32),
        num_classes=len(classes),
    )


def write_tu_format(
    raw_dir: str,
    name: str,
    node_ptr: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_ptr: np.ndarray,
    y: np.ndarray,
    node_labels: Optional[np.ndarray] = None,
    node_attrs: Optional[np.ndarray] = None,
) -> None:
    """Emit a GraphSet-shaped topology as TU-format text files (the inverse
    of `parse_tu_dir`; used for fixtures and offline dataset preparation)."""
    os.makedirs(raw_dir, exist_ok=True)
    node_ptr = np.asarray(node_ptr, dtype=np.int64)
    edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
    num_graphs = len(node_ptr) - 1
    p = lambda suffix: os.path.join(raw_dir, f"{name}_{suffix}.txt")

    node_graph = np.repeat(np.arange(num_graphs), np.diff(node_ptr))
    edge_graph = np.repeat(np.arange(num_graphs), np.diff(edge_ptr))
    g_src = np.asarray(edge_src, dtype=np.int64) + node_ptr[edge_graph] + 1
    g_dst = np.asarray(edge_dst, dtype=np.int64) + node_ptr[edge_graph] + 1

    with open(p("A"), "w") as f:
        for s, d in zip(g_src, g_dst):
            f.write(f"{s}, {d}\n")
    with open(p("graph_indicator"), "w") as f:
        f.write("\n".join(map(str, node_graph + 1)) + "\n")
    with open(p("graph_labels"), "w") as f:
        f.write("\n".join(map(str, np.asarray(y, dtype=np.int64))) + "\n")
    if node_labels is not None:
        with open(p("node_labels"), "w") as f:
            f.write("\n".join(map(str, np.asarray(node_labels, np.int64))) + "\n")
    if node_attrs is not None:
        attrs = np.asarray(node_attrs, dtype=np.float32).reshape(
            int(node_ptr[-1]), -1
        )
        with open(p("node_attributes"), "w") as f:
            for row in attrs:
                f.write(", ".join(repr(float(v)) for v in row) + "\n")
