"""Dense per-graph batch layout — the port of dgcnn_tpu/batching/dense.py.

A batch is

    x         [S, n_tile, F]       per-graph node features (zero padded)
    adj       [S, n_tile, n_tile]  D̂^{-1/2}(A+I)D̂^{-1/2}, built on the host
    node_mask [S, n_tile]

and one GCN propagation is a batched product `adj @ (x @ W)`. The host
packer is a line-for-line copy of the reference's, so both packages build
the same bytes. The whole dataset is packed once on the host, moved to
the device in one transfer (`build_dense_dataset`), and an epoch's batches
are gathered on the device from a [steps, slots] index matrix
(`order_matrix`, `gather_dense_batch`).

The adjacency is symmetric whenever the graph's edge list holds each
undirected edge in both directions (TU format does): the GCN-trunk kernel's
backward relies on that (kernels/dense_trunk.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from dgcnn_tpu_torch.data.graphset import GraphSet


@dataclasses.dataclass
class DenseGraphBatch:
    """One dense-layout batch (host numpy arrays or device tensors)."""

    x: object  # [S, n_tile, F]
    adj: object  # [S, n_tile, n_tile] normalized, self-loops included
    node_mask: object  # [S, n_tile]
    y: object  # [S]
    graph_mask: object  # [S]
    num_graphs: object  # []


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_tile(dataset: GraphSet, multiple: int = 8) -> int:
    """n_tile = dataset max graph size rounded up to `multiple`."""
    return _round_up(int(dataset.node_counts().max()), multiple)


def pack_dense_batch(
    dataset: GraphSet,
    graph_indices: Sequence[int],
    n_tile: int,
    num_graph_slots: int,
) -> DenseGraphBatch:
    """Pack graphs into the dense layout (host numpy) with the
    GCN-normalized adjacency precomputed: input self-loops stripped, one
    self-loop re-added per node (PyG GCNConv defaults)."""
    idx = np.asarray(graph_indices, dtype=np.int64)
    b = len(idx)
    if b > num_graph_slots:
        raise ValueError(f"{b} graphs > {num_graph_slots} slots")
    F = dataset.num_features

    x = np.zeros((num_graph_slots, n_tile, F), dtype=np.float32)
    adj = np.zeros((num_graph_slots, n_tile, n_tile), dtype=np.float32)
    node_mask = np.zeros((num_graph_slots, n_tile), dtype=np.float32)
    y = np.zeros(num_graph_slots, dtype=np.int32)
    graph_mask = np.zeros(num_graph_slots, dtype=np.float32)

    for j, g in enumerate(idx):
        ns, ne = dataset.node_ptr[g], dataset.node_ptr[g + 1]
        n = ne - ns
        if n > n_tile:
            raise ValueError(f"graph {g} has {n} nodes > n_tile={n_tile}")
        x[j, :n] = dataset.x[ns:ne]
        node_mask[j, :n] = 1.0

        es, ee = dataset.edge_ptr[g], dataset.edge_ptr[g + 1]
        s = dataset.edge_src[es:ee]
        d = dataset.edge_dst[es:ee]
        keep = s != d  # strip input self-loops
        a = adj[j]
        np.add.at(a, (d[keep], s[keep]), 1.0)
        a[np.arange(n), np.arange(n)] += 1.0  # re-added self-loops
        deg = a[:n, :n].sum(axis=1)
        dinv = 1.0 / np.sqrt(deg)
        a[:n, :n] *= dinv[:, None] * dinv[None, :]

    y[:b] = dataset.y[idx]
    graph_mask[:b] = 1.0
    return DenseGraphBatch(
        x=x,
        adj=adj,
        node_mask=node_mask,
        y=y,
        graph_mask=graph_mask,
        num_graphs=np.asarray(b, dtype=np.int32),
    )


def batch_to_device(batch: DenseGraphBatch, device) -> DenseGraphBatch:
    """Host-packed batch → tensors on `device` (y stays int32)."""
    return DenseGraphBatch(
        **{
            f.name: torch.from_numpy(np.asarray(getattr(batch, f.name))).to(device)
            for f in dataclasses.fields(DenseGraphBatch)
        }
    )


@dataclasses.dataclass
class DenseDataset:
    """All graphs of a dataset in dense form, on one device. Row g holds
    graph g; gather with an index vector to form a batch."""

    x: torch.Tensor  # [G, n_tile, F]
    adj: torch.Tensor  # [G, n_tile, n_tile]
    node_mask: torch.Tensor  # [G, n_tile]
    y: torch.Tensor  # [G] int32


def build_dense_dataset(dataset: GraphSet, n_tile: int, device) -> DenseDataset:
    """Pack every graph once on the host, then one transfer per array to
    `device`. The adjacency (G·n_tile² fp32) dominates the footprint."""
    g = dataset.num_graphs
    batch = pack_dense_batch(dataset, np.arange(g), n_tile, g)
    return DenseDataset(
        x=torch.from_numpy(batch.x).to(device),
        adj=torch.from_numpy(batch.adj).to(device),
        node_mask=torch.from_numpy(batch.node_mask).to(device),
        y=torch.from_numpy(batch.y).to(device),
    )


def dense_dataset_bytes(
    dataset: GraphSet, n_tile: int, adj_bytes: int = 4
) -> int:
    """Device-resident footprint of the dense layout (same estimate as the
    reference, which choose_layout's memory gate reads)."""
    g, f = dataset.num_graphs, dataset.num_features
    return g * n_tile * (n_tile * adj_bytes + (f + 1) * 4)


def order_matrix(order: np.ndarray, batch_size: int, batch_slots: int) -> np.ndarray:
    """Epoch index matrix [steps, batch_slots]; −1 marks padded slots.
    Batches are consecutive `batch_size` slices of `order`, like the
    reference loader (train.py:108-109)."""
    order = np.asarray(order, dtype=np.int32)
    steps = -(-len(order) // batch_size)
    out = np.full((steps, batch_slots), -1, dtype=np.int32)
    for s in range(steps):
        chunk = order[s * batch_size : (s + 1) * batch_size]
        out[s, : len(chunk)] = chunk
    return out


def gather_dense_batch(data: DenseDataset, idx: torch.Tensor) -> DenseGraphBatch:
    """Device-side batch construction: gather graph rows by index (−1 →
    masked padding slot). `idx` lies on the dataset's device, so nothing
    here waits for the host."""
    valid = idx >= 0
    safe = idx.clamp(min=0).long()
    gm = valid.to(torch.float32)
    return DenseGraphBatch(
        x=data.x[safe],
        adj=data.adj[safe],
        node_mask=data.node_mask[safe] * gm[:, None],
        y=data.y[safe] * valid.to(data.y.dtype),
        graph_mask=gm,
        num_graphs=gm.sum().to(torch.int32),
    )
