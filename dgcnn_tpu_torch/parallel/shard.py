"""Batch re-layout for the process grid — the port of
dgcnn_tpu/parallel/shard.py (`lpt_assign` :37, `shard_bucket` :53,
`partition_edges` :66, `shard_batch_for_dp` :83, `pack_epoch_dp` :103,
`local_view` :139).

Two partitionings of a packed epoch, as in the reference:

  * data axis — each global batch's graphs are split into balanced
    sub-batches (LPT greedy on node counts, at most ⌈batch/n⌉ graphs each,
    so the per-shard bucket bound holds); the loss and the gradients are
    summed over the data group, so the update is the single-device
    global-batch update up to float reassociation;
  * graph axis — each sub-batch's destination-sorted edge stream is cut
    into contiguous chunks, node arrays replicated; each rank aggregates
    its chunk and one sum over the graph group rebuilds the aggregate. A
    chunk of a destination-sorted stream is destination-sorted.

Leaf layouts (S = steps):
  node/graph leaves  [S, n_data, ...]
  edge leaves        [S, n_data, n_graph, E/n_graph]

`local_view` is a rank's own selection, [d] on every leaf and [g] on the
edge leaves. The reference's `batch_pspecs` and `device_put_epoch` place a
packed epoch on a JAX mesh; here each rank keeps only its selection, so
they have no counterpart.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dgcnn_tpu_torch.batching.packer import (
    ARRAY_FIELDS, BucketSpec, GraphBatch, compute_bucket, pack_batch,
)
from dgcnn_tpu_torch.data.graphset import GraphSet

EDGE_FIELDS = ("edge_src", "edge_dst", "edge_mask")


def lpt_assign(node_counts: np.ndarray, n_shards: int, cap: int) -> List[np.ndarray]:
    """Longest-processing-time greedy: balance total nodes per shard with at
    most `cap` graphs each. Returns per-shard index arrays (into the input)."""
    order = np.argsort(node_counts)[::-1]
    totals = np.zeros(n_shards, dtype=np.int64)
    counts = np.zeros(n_shards, dtype=np.int64)
    groups: List[List[int]] = [[] for _ in range(n_shards)]
    for i in order:
        open_shards = np.flatnonzero(counts < cap)
        s = open_shards[np.argmin(totals[open_shards])]
        groups[s].append(int(i))
        totals[s] += node_counts[i]
        counts[s] += 1
    return [np.array(sorted(g), dtype=np.int64) for g in groups]


def shard_bucket(dataset: GraphSet, batch_size: int, n_data: int,
                 node_multiple: int = 128, edge_multiple: int = 256,
                 graph_multiple: int = 4, n_graph: int = 1) -> BucketSpec:
    """Worst-case per-shard bucket: any ≤⌈batch/n⌉-graph group fits; the
    edge axis divides evenly over the graph axis."""
    per_shard = -(-batch_size // n_data)
    b = compute_bucket(dataset, per_shard, node_multiple, edge_multiple, graph_multiple)
    e = -(-b.num_edges // (edge_multiple * n_graph)) * (edge_multiple * n_graph)
    return BucketSpec(b.num_nodes, e, b.num_graphs)


def _map_fields(batch: GraphBatch, fn) -> GraphBatch:
    return GraphBatch(**{name: fn(name, getattr(batch, name)) for name in ARRAY_FIELDS})


def partition_edges(batch: GraphBatch, n_graph: int) -> GraphBatch:
    """Reshape the edge leaves [..., E] → [..., n_graph, E/n_graph]."""
    def reshape(name, arr):
        if name in EDGE_FIELDS:
            e = arr.shape[-1]
            if e % n_graph:
                raise ValueError(f"{name}: {e} edges do not split over {n_graph} "
                                 f"graph ranks")
            return arr.reshape(arr.shape[:-1] + (n_graph, e // n_graph))
        return arr

    return _map_fields(batch, reshape)


def _stack(batches) -> GraphBatch:
    return GraphBatch(**{name: np.stack([getattr(b, name) for b in batches])
                         for name in ARRAY_FIELDS})


def shard_batch_for_dp(dataset: GraphSet, graph_indices: np.ndarray,
                       bucket: BucketSpec, n_data: int, n_graph: int = 1) -> GraphBatch:
    """Pack ONE global batch as `n_data` balanced sub-batches (leaves gain a
    leading [n_data] axis; edge leaves also [n_graph], of size 1 when the
    stream is not partitioned, so `local_view` is layout-uniform)."""
    idx = np.asarray(graph_indices, dtype=np.int64)
    cap = max(-(-len(idx) // n_data) if len(idx) else 1, 1)
    groups = lpt_assign(dataset.node_counts()[idx], n_data, cap)
    return partition_edges(_stack([pack_batch(dataset, idx[g], bucket) for g in groups]),
                           n_graph)


def pack_epoch_dp(dataset: GraphSet, order: np.ndarray, batch_size: int,
                  bucket: BucketSpec, n_data: int, n_graph: int = 1) -> GraphBatch:
    """Pack a shuffled epoch for the grid: leaves [S, n_data(, n_graph), ...]."""
    order = np.asarray(order, dtype=np.int64)
    return _stack([
        shard_batch_for_dp(dataset, order[i : i + batch_size], bucket, n_data, n_graph)
        for i in range(0, len(order), batch_size)
    ])


def local_view(batch: GraphBatch, d: int, g: int, n_data: int, n_graph: int,
               steps: bool = False) -> GraphBatch:
    """Rank (d, g)'s selection of a batch packed for an (n_data, n_graph)
    grid: [d] on every leaf, [g] on the edge leaves; with `steps`, of a
    packed epoch (a leading step axis kept). Raises when an axis is not
    the grid's size — a batch packed for another grid would otherwise
    lose sub-batches without a word (the reference's asserts)."""
    lead = 1 if steps else 0

    def select(name, arr):
        if arr.shape[lead] != n_data:
            raise ValueError(f"{name}: data axis is {arr.shape[lead]}, expected "
                             f"{n_data} — batch packed for a different mesh shape?")
        arr = arr[:, d] if steps else arr[d]
        if name in EDGE_FIELDS:
            if arr.shape[lead] != n_graph:
                raise ValueError(f"{name}: graph axis is {arr.shape[lead]}, expected "
                                 f"{n_graph} — batch packed for a different mesh shape?")
            arr = arr[:, g] if steps else arr[g]
        return arr

    return _map_fields(batch, select)


def balanced_rows(weights: np.ndarray, ids: np.ndarray, n_data: int,
                  slots: int) -> np.ndarray:
    """One global batch of graph `ids` → [n_data, slots] (−1 padded): LPT
    balance on the graphs' `weights`, at most `slots` a row (the mesh
    engines' `_batch_rows`, dgcnn_tpu/train/cv.py:805, :978)."""
    out = np.full((n_data, slots), -1, np.int32)
    for d, grp in enumerate(lpt_assign(weights[ids], n_data, slots)):
        out[d, : len(grp)] = ids[grp]
    return out


def epoch_rows(weights: np.ndarray, ids_seq: np.ndarray, batch_size: int,
               n_data: int, slots: int) -> np.ndarray:
    """An epoch's graph ids → [steps, n_data, slots], `balanced_rows` of each
    consecutive `batch_size` slice."""
    rows = [balanced_rows(weights, ids_seq[i : i + batch_size], n_data, slots)
            for i in range(0, len(ids_seq), batch_size)]
    return np.stack(rows) if rows else np.full((0, n_data, slots), -1, np.int32)


__all__ = ["EDGE_FIELDS", "balanced_rows", "epoch_rows", "local_view", "lpt_assign",
           "pack_epoch_dp", "partition_edges", "shard_batch_for_dp", "shard_bucket"]
