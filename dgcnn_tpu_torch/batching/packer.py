"""Pad-and-bucket COO batcher — the port of dgcnn_tpu/batching/packer.py
(`BucketSpec` :37, `GraphBatch` :46, `compute_bucket` :97, `pack_batch`
:119, `blockcoo_item_bound` :189, `add_blockcoo` :211, `pack_epoch` :291).

Up to `batch_size` graphs are packed into one fixed (num_nodes, num_edges,
num_graphs) bucket with explicit masks. Invariants, as in the reference:
  * self-loops are stripped at pack time (GCN re-adds them densely);
  * edges are sorted by destination (stable), so a batch's stream is a
    CSR-ordered edge list;
  * padded nodes carry graph id `num_graphs` (one past the last slot);
  * padded edges sit at the tail of the stream as src 0 → dst N_pad−1 with
    edge_mask 0, so the destination column stays sorted while the edges
    add nothing (their GCN weight is the mask).

The packers are NumPy on the host and give the reference's bytes. The
reference's C++ packer (`native/packer.cc`, identical output) is not
ported yet (ROADMAP Queue 1 item 8): `pack_epoch` here is the NumPy
backend. `GraphBatch` holds NumPy arrays after packing and tensors after
`batch_to_device` or `batching/device_coo.gather_coo_batch`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from dgcnn_tpu_torch.data.graphset import GraphSet


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shapes of a packed batch."""

    num_nodes: int  # N_pad
    num_edges: int  # E_pad
    num_graphs: int  # B_pad (graph slots)


@dataclasses.dataclass
class GraphBatch:
    """One packed COO batch (or a stacked epoch of them, one leading axis).

    x:           [N_pad, F]   node features (zeros in padding)
    edge_src:    [E_pad]      batch-global source node (0 in padding)
    edge_dst:    [E_pad]      batch-global destination node, sorted
    edge_mask:   [E_pad]      1.0 for real edges
    node_graph:  [N_pad]      graph slot of each node; == B_pad in padding
    node_mask:   [N_pad]      1.0 for real nodes
    y:           [B_pad]      labels (0 in padding)
    graph_mask:  [B_pad]      1.0 for real graphs
    num_graphs:  []           count of real graphs
    blockcoo:    optional (BlockCOO, w_pad, w_padT) from `add_blockcoo`,
                 which `--spmm pallas` runs on the block-COO kernel
    """

    x: object
    edge_src: object
    edge_dst: object
    edge_mask: object
    node_graph: object
    node_mask: object
    y: object
    graph_mask: object
    num_graphs: object
    blockcoo: object = None


ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(GraphBatch)
                     if f.name != "blockcoo")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compute_bucket(
    dataset: GraphSet,
    batch_size: int,
    node_multiple: int = 256,
    edge_multiple: int = 1024,
    graph_multiple: int = 8,
) -> BucketSpec:
    """Worst-case bucket for shuffled batches of `batch_size` graphs: the
    sum of the `batch_size` largest node and edge counts, rounded up, so
    any batch composition fits."""
    nc = np.sort(dataset.node_counts())[::-1]
    ec = np.sort(dataset.edge_counts())[::-1]
    k = min(batch_size, len(nc))
    n_max = int(nc[:k].sum())
    e_max = int(ec[:k].sum())
    return BucketSpec(
        num_nodes=_round_up(max(n_max, 1), node_multiple),
        num_edges=_round_up(max(e_max, 1), edge_multiple),
        num_graphs=_round_up(batch_size, graph_multiple),
    )


def pack_batch(
    dataset: GraphSet, graph_indices: Sequence[int], bucket: BucketSpec
) -> GraphBatch:
    """Pack the given graphs into one fixed-shape GraphBatch (NumPy)."""
    idx = np.asarray(graph_indices, dtype=np.int64)
    b = len(idx)
    if b > bucket.num_graphs:
        raise ValueError(f"{b} graphs > bucket.num_graphs={bucket.num_graphs}")
    n_counts = dataset.node_counts()[idx]
    n_tot = int(n_counts.sum())
    if n_tot > bucket.num_nodes:
        raise ValueError(f"{n_tot} nodes > bucket.num_nodes={bucket.num_nodes}")

    x = np.zeros((bucket.num_nodes, dataset.num_features), dtype=np.float32)
    node_graph = np.full(bucket.num_nodes, bucket.num_graphs, dtype=np.int32)
    node_mask = np.zeros(bucket.num_nodes, dtype=np.float32)
    y = np.zeros(bucket.num_graphs, dtype=np.int32)
    graph_mask = np.zeros(bucket.num_graphs, dtype=np.float32)
    node_off = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(n_counts, out=node_off[1:])

    srcs, dsts = [], []
    for j, g in enumerate(idx):
        ns, ne = dataset.node_ptr[g], dataset.node_ptr[g + 1]
        x[node_off[j] : node_off[j + 1]] = dataset.x[ns:ne]
        node_graph[node_off[j] : node_off[j + 1]] = j
        es, ee = dataset.edge_ptr[g], dataset.edge_ptr[g + 1]
        s = dataset.edge_src[es:ee].astype(np.int64)
        d = dataset.edge_dst[es:ee].astype(np.int64)
        keep = s != d
        srcs.append(s[keep] + node_off[j])
        dsts.append(d[keep] + node_off[j])
    node_mask[:n_tot] = 1.0
    y[:b] = dataset.y[idx]
    graph_mask[:b] = 1.0

    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    e_tot = len(src)
    if e_tot > bucket.num_edges:
        raise ValueError(f"{e_tot} edges > bucket.num_edges={bucket.num_edges}")
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]

    edge_src = np.zeros(bucket.num_edges, dtype=np.int32)
    edge_dst = np.full(bucket.num_edges, bucket.num_nodes - 1, dtype=np.int32)
    edge_mask = np.zeros(bucket.num_edges, dtype=np.float32)
    edge_src[:e_tot] = src
    edge_dst[:e_tot] = dst
    edge_mask[:e_tot] = 1.0
    return GraphBatch(
        x=x, edge_src=edge_src, edge_dst=edge_dst, edge_mask=edge_mask,
        node_graph=node_graph, node_mask=node_mask, y=y,
        graph_mask=graph_mask, num_graphs=np.asarray(b, dtype=np.int32),
    )


def pack_epoch(
    dataset: GraphSet, order: np.ndarray, batch_size: int, bucket: BucketSpec
) -> GraphBatch:
    """An epoch's batches (consecutive `batch_size` slices of `order`, the
    last one ragged), stacked on a leading axis."""
    order = np.asarray(order, dtype=np.int64)
    batches = [
        pack_batch(dataset, order[i : i + batch_size], bucket)
        for i in range(0, len(order), batch_size)
    ]
    return GraphBatch(**{
        name: np.stack([getattr(b, name) for b in batches])
        for name in ARRAY_FIELDS
    })


def blockcoo_item_bound(dataset: GraphSet, batch_size: int, eb: int = 0) -> int:
    """Shape-stable per-batch work-item bound for `add_blockcoo`, from the
    worst-case batch (the `batch_size` largest graphs): each graph spans
    n//128 + 2 node blocks and gives at most ~3·span (r, c) groups plus its
    own EB chunking. `add_blockcoo` grows past it when an epoch needs more."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import BS, DEFAULT_EB

    eb = eb or DEFAULT_EB
    nc = np.sort(dataset.node_counts())[::-1][:batch_size]
    ec = np.sort(dataset.edge_counts())[::-1][:batch_size]
    span = nc // BS + 2
    groups = np.minimum(3 * span, np.maximum(ec, 1))
    items = groups + ec // eb
    return int(items.sum()) + 8


def add_blockcoo(batch: GraphBatch, eb: int = 0, pad_items_to: int = 0) -> GraphBatch:
    """Attach the block-pair structure (kernels/spmm_block_coo.py) to a
    host-packed batch or stacked epoch: built from each batch's real edges,
    both orientations padded to one item count (the epoch's largest, or
    `pad_items_to` if larger), weights = the edge masks (the GCN's symmetric
    norm runs as node-row scalings around the SpMM). The meta's per-batch
    values are replaced by the reference's −1 sentinels."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import (
        DEFAULT_EB, BlockCOO, build_block_coo, pad_structure, pad_weights,
        pad_weights_t,
    )

    eb = eb or DEFAULT_EB
    src_all = np.asarray(batch.edge_src)
    stacked = src_all.ndim == 2
    srcs = src_all if stacked else src_all[None]
    dsts = np.asarray(batch.edge_dst).reshape(srcs.shape)
    masks = np.asarray(batch.edge_mask).reshape(srcs.shape)
    n_pad = np.asarray(batch.x).shape[-2]

    per_batch = [(s[m > 0], d[m > 0], m[m > 0]) for s, d, m in zip(srcs, dsts, masks)]
    raw = [build_block_coo(s, d, n_pad, eb=eb) for s, d, _ in per_batch]
    w_max = max(max(s.ls.shape[0] for s in raw), max(s.lsT.shape[0] for s in raw),
                pad_items_to)
    structs, wps, wpTs = [], [], []
    for s, (_, _, mask) in zip(raw, per_batch):
        s = pad_structure(s, w_max)
        structs.append(s)
        wps.append(pad_weights(s, mask))
        wpTs.append(pad_weights_t(s, mask))
    meta = dataclasses.replace(structs[0].meta, num_edges=-1, fill=-1.0)

    def cat(field):
        out = np.stack([np.asarray(getattr(s, field)) for s in structs])
        return out if stacked else out[0]

    structure = BlockCOO(meta=meta, **{f: cat(f) for f in BlockCOO.ARRAYS})
    w_pad, w_padT = np.stack(wps), np.stack(wpTs)
    if not stacked:
        w_pad, w_padT = w_pad[0], w_padT[0]
    return dataclasses.replace(batch, blockcoo=(structure, w_pad, w_padT))


def pad_blockcoo(epoch: GraphBatch, w: int) -> GraphBatch:
    """A stacked epoch from `add_blockcoo` with both orientations' item axes
    padded further to `w`: `pad_structure` appends sentinel items, and the
    weights null slots (0), so the SpMM adds the same."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import BlockCOO, pad_structure

    structure, w_pad, w_padT = epoch.blockcoo
    structs = [pad_structure(structure.map(lambda a, i=i: np.asarray(a)[i]), w)
               for i in range(len(w_pad))]
    padded = BlockCOO(meta=structure.meta, **{
        f: np.stack([getattr(s, f) for s in structs]) for f in BlockCOO.ARRAYS})
    extra = ((0, 0), (0, w - w_pad.shape[1]), (0, 0))
    return dataclasses.replace(
        epoch, blockcoo=(padded, np.pad(w_pad, extra), np.pad(w_padT, extra)))


def map_batch(batch: GraphBatch, fn) -> GraphBatch:
    """`fn` applied to every array of a batch, the block structure's too."""
    bc = batch.blockcoo
    if bc is not None:
        structure, w_pad, w_padT = bc
        bc = (structure.map(fn), fn(w_pad), fn(w_padT))
    return GraphBatch(**{name: fn(getattr(batch, name)) for name in ARRAY_FIELDS},
                      blockcoo=bc)


def batch_arrays(batch: GraphBatch) -> list:
    """Every array of a batch in one fixed order (`map_batch`'s)."""
    out = []
    map_batch(batch, lambda a: out.append(a))
    return out


def batch_to_device(batch: GraphBatch, device) -> GraphBatch:
    """A host-packed batch (or stacked epoch) → tensors on `device`, one
    transfer per array; the block structure's arrays too."""
    return map_batch(batch, lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))


def pin_batch(batch: GraphBatch) -> GraphBatch:
    """A host-packed batch → CPU tensors in page-locked memory, from which
    a copy to the card runs asynchronously."""
    return map_batch(batch, lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory())


def empty_batch_like(batch: GraphBatch, device) -> GraphBatch:
    """Uninitialized tensors on `device` of a batch of tensors' shapes and
    dtypes."""
    return map_batch(batch, lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))


def batch_step(stacked: GraphBatch, i: int) -> GraphBatch:
    """Step `i` of a stacked epoch (views, no copies)."""
    return map_batch(stacked, lambda a: a[i])
