"""`GraphSet` — a whole graph dataset as flat, contiguous NumPy arrays.

Replaces PyG's list-of-`Data` dataset representation (reference
train.py:81-87): instead of one ragged object per graph, all node features
and edges live in flat arrays indexed through `node_ptr`/`edge_ptr`
prefix-sum tables. This is the natural host-side layout for a TPU
framework — the batch packer (batching/packer.py) and the dense
materializer (batching/dense.py) slice it with zero per-graph Python
object overhead, and the C++ epoch packer (dgcnn_tpu_torch/native,
`packer.cc`) reads the same arrays through ctypes without any
conversion.

Edge indices are **graph-local** (each graph's nodes are numbered from 0);
the packers add batch offsets. Edges are directed COO pairs; TU-format
graphs store each undirected edge in both directions (SURVEY §2c
"PyG degree" row).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphSet:
    """A dataset of `G` graphs with `N` total nodes and `E` total edges.

    x:           [N, F] float32 — assembled node features
                 (attrs ‖ one-hot labels ‖ per-graph-normalized in-degree,
                 SURVEY §2d)
    node_ptr:    [G+1] int64 — node prefix sums; graph g owns rows
                 node_ptr[g]:node_ptr[g+1] of `x`
    edge_src:    [E] int32 — graph-LOCAL source node index
    edge_dst:    [E] int32 — graph-LOCAL destination node index
    edge_ptr:    [G+1] int64 — edge prefix sums
    y:           [G] int32 — class labels in [0, num_classes)
    num_classes: int
    """

    x: np.ndarray
    node_ptr: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_ptr: np.ndarray
    y: np.ndarray
    num_classes: int

    # -- shape accessors ----------------------------------------------------

    @property
    def num_graphs(self) -> int:
        return len(self.node_ptr) - 1

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def total_nodes(self) -> int:
        return int(self.node_ptr[-1])

    @property
    def total_edges(self) -> int:
        return int(self.edge_ptr[-1])

    def node_counts(self) -> np.ndarray:
        """[G] nodes per graph."""
        return np.diff(self.node_ptr)

    def edge_counts(self) -> np.ndarray:
        """[G] directed edges per graph."""
        return np.diff(self.edge_ptr)

    def num_nodes(self, g: int) -> int:
        return int(self.node_ptr[g + 1] - self.node_ptr[g])

    def num_edges(self, g: int) -> int:
        return int(self.edge_ptr[g + 1] - self.edge_ptr[g])

    # -- slicing -------------------------------------------------------------

    def subset(self, graph_indices) -> "GraphSet":
        """New GraphSet holding the given graphs, in the given order —
        the equivalent of PyG's integer-array dataset indexing
        (reference train.py:107: `data_set[train_idxes]`)."""
        idx = np.asarray(graph_indices, dtype=np.int64)
        nc = self.node_counts()[idx]
        ec = self.edge_counts()[idx]
        node_ptr = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(nc, out=node_ptr[1:])
        edge_ptr = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(ec, out=edge_ptr[1:])

        x = np.empty((int(node_ptr[-1]), self.num_features), dtype=self.x.dtype)
        edge_src = np.empty(int(edge_ptr[-1]), dtype=self.edge_src.dtype)
        edge_dst = np.empty(int(edge_ptr[-1]), dtype=self.edge_dst.dtype)
        for j, g in enumerate(idx):
            ns, ne = self.node_ptr[g], self.node_ptr[g + 1]
            x[node_ptr[j] : node_ptr[j + 1]] = self.x[ns:ne]
            es, ee = self.edge_ptr[g], self.edge_ptr[g + 1]
            edge_src[edge_ptr[j] : edge_ptr[j + 1]] = self.edge_src[es:ee]
            edge_dst[edge_ptr[j] : edge_ptr[j + 1]] = self.edge_dst[es:ee]

        return GraphSet(
            x=x,
            node_ptr=node_ptr,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_ptr=edge_ptr,
            y=np.asarray(self.y)[idx],
            num_classes=self.num_classes,
        )

    # -- (de)serialization ----------------------------------------------------

    def to_npz(self, path: str) -> None:
        np.savez_compressed(
            path,
            x=self.x,
            node_ptr=self.node_ptr,
            edge_src=self.edge_src,
            edge_dst=self.edge_dst,
            edge_ptr=self.edge_ptr,
            y=self.y,
            num_classes=np.int64(self.num_classes),
        )

    @staticmethod
    def from_npz(path: str) -> "GraphSet":
        with np.load(path) as z:
            return GraphSet(
                x=z["x"],
                node_ptr=z["node_ptr"],
                edge_src=z["edge_src"],
                edge_dst=z["edge_dst"],
                edge_ptr=z["edge_ptr"],
                y=z["y"],
                num_classes=int(z["num_classes"]),
            )
