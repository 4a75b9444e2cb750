"""Size-bucketed multi-tile dense layout — the port of
dgcnn_tpu/batching/multi_dense.py (`MultiDenseRouting` :36, `plan_tiles`
:44, `build_routing` :67, `build_multi_dense` :85,
`build_multi_dense_on_device` :98, `multi_dense_bytes` :124,
`route_order_rows` :134, `class_batch_counts` :155).

The single-tile dense layout is quadratic in the dataset's largest graph.
Here each graph is stored dense at the smallest tile of a geometric (×2)
ladder that holds it, one `DenseDataset` per tile class, and a batch is
computed per class: each class gathers its graphs of the batch, runs the
GCN trunk at its own tile and sort-pools; the pooled rows of all classes
are concatenated for the shared readout and loss
(models/dgcnn.py `apply_multi_dense`). A batch keeps its membership; only
the compute grouping changes. Per-batch work follows each graph's own
tile (Σ S_c·t_c²) instead of the largest tile squared.

`MultiDenseBatch` is one batch split by class, the form the model and the
epoch loop take. Device footprint: Σ_c G_c·t_c·(t_c+F+1)·4 bytes
(`multi_dense_bytes`, which `train/cv.py choose_layout` reads).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.batching.dense import (
    DenseDataset, DenseGraphBatch, build_dense_dataset, store_dtypes,
)
from dgcnn_tpu_torch.batching.device_coo import build_device_graphset, densify_many_on_device
from dgcnn_tpu_torch.data.graphset import GraphSet


@dataclasses.dataclass
class MultiDenseRouting:
    """Host-side routing tables (never shipped to the device)."""

    tiles: Tuple[int, ...]  # tile size per class, ascending
    class_of: np.ndarray  # [G] class index of each graph
    index_in_class: np.ndarray  # [G] row of the graph inside its class


@dataclasses.dataclass
class MultiDenseBatch:
    """One batch split by tile class: `classes[c]` holds class c's slots.
    In fold-lockstep a class holds `num_folds` folds' slots, fold f's in
    the f-th run of its S_c. `y` and `graph_mask` are fold-major: fold f's
    classes concatenated in class order, the order of the log-probs of
    `apply_multi_dense` (one fold) and `apply_multi_dense_folds`."""

    classes: Tuple[DenseGraphBatch, ...]
    num_folds: int = 1

    def _by_fold(self, field: str) -> torch.Tensor:
        return torch.cat([getattr(b, field).view(self.num_folds, -1)
                          for b in self.classes], dim=1).reshape(-1)

    @property
    def y(self) -> torch.Tensor:
        return self._by_fold("y")

    @property
    def graph_mask(self) -> torch.Tensor:
        return self._by_fold("graph_mask")


def plan_tiles(
    node_counts: np.ndarray, min_tile: int = 256, multiple: int = 8
) -> Tuple[int, ...]:
    """Geometric (×2) tile ladder from min_tile up to the largest graph
    (top tile rounded to `multiple`). Classes that would hold no graphs
    are dropped."""
    max_n = int(np.asarray(node_counts).max())
    tiles: List[int] = []
    t = min_tile
    while t < max_n:
        tiles.append(t)
        t *= 2
    tiles.append(-(-max_n // multiple) * multiple)
    prev = 0
    kept = []
    for t in tiles:
        if ((node_counts > prev) & (node_counts <= t)).any():
            kept.append(t)
        prev = t
    return tuple(kept)


def build_routing(node_counts: np.ndarray, tiles: Sequence[int]) -> MultiDenseRouting:
    """Each graph's class (the smallest tile that holds it) and its row in
    that class. Raises when a graph is larger than the top tile: it would
    belong to no class, and every batch would drop it silently."""
    nc = np.asarray(node_counts)
    if len(nc) and int(nc.max()) > int(tiles[-1]):
        raise ValueError(
            f"largest graph has {int(nc.max())} nodes > top tile "
            f"{int(tiles[-1])}; tiles must cover every graph"
        )
    class_of = np.searchsorted(np.asarray(tiles), nc, side="left").astype(np.int32)
    index_in_class = np.zeros(len(nc), dtype=np.int32)
    for c in range(len(tiles)):
        members = np.flatnonzero(class_of == c)
        index_in_class[members] = np.arange(len(members), dtype=np.int32)
    return MultiDenseRouting(tuple(int(t) for t in tiles), class_of, index_in_class)


def build_multi_dense(
    dataset: GraphSet, tiles: Sequence[int], device="cpu",
    adj_dtype: str = "float32", compute_dtype: str = "float32",
) -> Tuple[Tuple[DenseDataset, ...], MultiDenseRouting]:
    """Host-side materialization: one `DenseDataset` per tile class over
    that class's graphs (rows in global graph-id order), packed on the
    host, stored at `store_dtypes(adj_dtype, compute_dtype)` and moved to
    `device`."""
    routing = build_routing(dataset.node_counts(), tiles)
    classes = tuple(
        build_dense_dataset(dataset.subset(np.flatnonzero(routing.class_of == c)),
                            t, device, adj_dtype, compute_dtype)
        for c, t in enumerate(routing.tiles))
    return classes, routing


def build_multi_dense_on_device(
    dataset: GraphSet, tiles: Sequence[int], device,
    adj_dtype: str = "float32", compute_dtype: str = "float32",
) -> Tuple[Tuple[DenseDataset, ...], MultiDenseRouting]:
    """Device-side materialization: per class, ship the compact COO subset
    and densify it on `device` (batching/device_coo.py
    `densify_many_on_device`): O(nodes + edges) crosses the link instead of
    O(Σ G_c·t_c²). The densify is fp32 (bitwise `build_multi_dense`); each
    class is then rounded to its storage dtypes (`store_dtypes`), as the
    reference rounds its classes after its densify
    (dgcnn_tpu/train/cv.py:604-611). Bitwise equal to `build_multi_dense`
    at the same dtypes."""
    routing = build_routing(dataset.node_counts(), tiles)
    hosts = [build_device_graphset(dataset.subset(np.flatnonzero(routing.class_of == c)))
             for c in range(len(routing.tiles))]
    classes = densify_many_on_device(hosts, routing.tiles, device,
                                     lambda d: store_dtypes(d, adj_dtype, compute_dtype))
    return tuple(classes), routing


def multi_dense_bytes(dataset: GraphSet, tiles: Sequence[int]) -> int:
    routing = build_routing(dataset.node_counts(), tiles)
    total = 0
    for c, t in enumerate(routing.tiles):
        g = int((routing.class_of == c).sum())
        total += g * t * (t + dataset.num_features + 1) * 4
    return total


def route_order_rows(
    routing: MultiDenseRouting, ids: np.ndarray, slots: Sequence[int]
) -> List[np.ndarray]:
    """One global batch → per-class index rows [slots_c] (−1 padded),
    indices into each class's DenseDataset. Raises on slot overflow (the
    engine sizes slots grow-only from the epochs it runs)."""
    ids = np.asarray(ids)
    rows = []
    for c, s in enumerate(slots):
        members = ids[routing.class_of[ids] == c]
        if len(members) > s:
            raise ValueError(f"class {c} has {len(members)} graphs > {s} slots")
        row = np.full(s, -1, dtype=np.int32)
        row[: len(members)] = routing.index_in_class[members]
        rows.append(row)
    return rows


def class_batch_counts(
    routing: MultiDenseRouting, order: np.ndarray, batch_size: int
) -> np.ndarray:
    """[steps, num_classes] per-batch class membership counts, the slot
    sizing input."""
    order = np.asarray(order)
    steps = -(-len(order) // batch_size)
    out = np.zeros((steps, len(routing.tiles)), dtype=np.int64)
    for s in range(steps):
        chunk = order[s * batch_size : (s + 1) * batch_size]
        cls, cnt = np.unique(routing.class_of[chunk], return_counts=True)
        out[s, cls] = cnt
    return out
