"""Device-resident COO graphset with on-device batch assembly — the port of
dgcnn_tpu/batching/device_coo.py (`DeviceGraphSet` :38,
`build_device_graphset` :75, `batch_extents` :115, `assert_bucket_fits`
:130, `device_graphset_bytes` :291, `segment_of` :299, `gather_coo_batch`
:313).

The flattened GraphSet (features, per-graph destination-sorted edges with
self-loops stripped, prefix tables) goes to the device once; a packed
`GraphBatch` is assembled there from a [slots] row of graph ids with
cumulative sums, the slot mapping `segment_of` and row gathers. The result
equals `packer.pack_batch` byte for byte: per-graph edges are sorted at
build time and slot offsets grow with the slot, so the concatenated stream
is globally destination-sorted as the packer's stable argsort makes it.

`densify_on_device` / `densify_many_on_device` (:147, :243; the
multi-tile layout's builder) turn the graphset into a `DenseDataset` on
its device, in the host builder's arithmetic, so the two agree bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgcnn_tpu_torch.batching.block_sparse import segment_of
from dgcnn_tpu_torch.batching.dense import DenseDataset
from dgcnn_tpu_torch.batching.packer import BucketSpec, GraphBatch
from dgcnn_tpu_torch.data.graphset import GraphSet


@dataclasses.dataclass
class DeviceGraphSet:
    """A whole GraphSet as arrays (NumPy from the build, tensors after
    `device_graphset_to`). Row G of the count tables is a zero-count
    sentinel graph for empty slots; row N of `x` is a zero sentinel node.

    x:           [N+1, F]  node features (+ zero row)
    node_start:  [G+1]     first row of each graph's nodes (+ N)
    node_count:  [G+1]     nodes per graph (+ 0)
    edge_src:    [E]       graph-local src, per-graph dst-sorted
    edge_dst:    [E]       graph-local dst, per-graph sorted ascending
    edge_start:  [G+1]     first edge of each graph (+ sentinel)
    edge_count:  [G+1]     self-loop-stripped edges per graph (+ 0)
    y:           [G+1]     labels (+ 0)
    """

    x: object
    node_start: object
    node_count: object
    edge_src: object
    edge_dst: object
    edge_start: object
    edge_count: object
    y: object


def build_device_graphset(dataset: GraphSet) -> DeviceGraphSet:
    """Host-side one-time preparation: strip self-loops, sort each graph's
    edges by destination (stable), append the sentinels."""
    g = dataset.num_graphs
    srcs, dsts, counts = [], [], np.zeros(g + 1, dtype=np.int32)
    for i in range(g):
        es, ee = dataset.edge_ptr[i], dataset.edge_ptr[i + 1]
        s = dataset.edge_src[es:ee]
        d = dataset.edge_dst[es:ee]
        keep = s != d
        s, d = s[keep], d[keep]
        order = np.argsort(d, kind="stable")
        srcs.append(s[order])
        dsts.append(d[order])
        counts[i] = len(s)
    edge_start = np.zeros(g + 1, dtype=np.int32)
    np.cumsum(counts[:-1], out=edge_start[1:])
    x = np.concatenate([dataset.x.astype(np.float32),
                        np.zeros((1, dataset.num_features), np.float32)])
    return DeviceGraphSet(
        x=x,
        node_start=dataset.node_ptr.astype(np.int32),
        node_count=np.concatenate([np.diff(dataset.node_ptr).astype(np.int32), [0]]),
        edge_src=np.concatenate(srcs).astype(np.int32) if g else np.zeros(0, np.int32),
        edge_dst=np.concatenate(dsts).astype(np.int32) if g else np.zeros(0, np.int32),
        edge_start=edge_start,
        edge_count=counts,
        y=np.concatenate([dataset.y.astype(np.int32), [0]]),
    )


def device_graphset_to(host: DeviceGraphSet, device) -> DeviceGraphSet:
    """One transfer per array; index tables become int64 (torch indexes
    with them), features stay float32."""
    out = {}
    for fld in dataclasses.fields(DeviceGraphSet):
        a = np.asarray(getattr(host, fld.name))
        t = torch.from_numpy(a)
        out[fld.name] = (t if a.dtype == np.float32 else t.long()).to(device)
    return DeviceGraphSet(**out)


def batch_extents(node_counts, edge_counts, order_mat) -> tuple:
    """Max (nodes, edges) over the batch rows of an order matrix (last axis
    = graph slots, −1 padding): the host-side source of truth for bucket
    sizing, since the device assembly cannot raise."""
    order_mat = np.asarray(order_mat)
    rows = order_mat.reshape(-1, order_mat.shape[-1])
    safe = np.maximum(rows, 0)
    valid = rows >= 0
    n = int((np.asarray(node_counts)[safe] * valid).sum(axis=1).max())
    e = int((np.asarray(edge_counts)[safe] * valid).sum(axis=1).max())
    return n, e


def assert_bucket_fits(node_counts, edge_counts, order_mat, bucket: BucketSpec) -> None:
    """Raise when a batch row overflows the bucket (the device assembly
    would truncate silently)."""
    n, e = batch_extents(node_counts, edge_counts, order_mat)
    if n > bucket.num_nodes or e > bucket.num_edges:
        raise ValueError(
            f"batch of {n} nodes / {e} edges overflows bucket {bucket} "
            f"(edge counts may include self-loops stripped at build time, "
            f"so the edge bound is conservative)"
        )


def device_graphset_bytes(dataset: GraphSet) -> int:
    return (
        (dataset.total_nodes + 1) * dataset.num_features * 4
        + dataset.total_edges * 8
        + dataset.num_graphs * 24
    )


def gather_coo_batch(dev: DeviceGraphSet, idx_row: torch.Tensor,
                     bucket: BucketSpec, edge_window=None) -> GraphBatch:
    """Assemble one packed GraphBatch on the device of `dev` from [slots]
    graph ids (−1 = empty slot). Equal to `pack_batch` of the same graphs:
    same slot layout, padded nodes with graph id = slots, padded edges
    src 0 → dst N_pad−1 with mask 0 at the tail, destination-sorted.

    `edge_window=(start, length)` (ints) assembles only that contiguous
    slice of the batch's edge stream, the node arrays whole: a graph
    rank's chunk on the edge-partitioned grid (parallel/train_dp.py)."""
    slots = idx_row.shape[0]
    n_pad, e_pad = bucket.num_nodes, bucket.num_edges
    e_start = 0
    if edge_window is not None:
        e_start, e_pad = (int(v) for v in edge_window)
    device = idx_row.device
    num_graphs_total = dev.node_start.shape[0] - 1

    valid = idx_row >= 0
    g = torch.where(valid, idx_row.long(), num_graphs_total)
    zero = torch.zeros(1, dtype=torch.long, device=device)
    node_off = torch.cat([zero, torch.cumsum(dev.node_count[g], 0)])  # [slots+1]
    edge_off = torch.cat([zero, torch.cumsum(dev.edge_count[g], 0)])

    pos = torch.arange(n_pad, device=device)
    slot_c = segment_of(node_off[1:], pos).clamp(max=slots - 1)
    node_ok = pos < node_off[slots]
    src_row = dev.node_start[g[slot_c]] + pos - node_off[slot_c]
    x = dev.x[torch.where(node_ok, src_row, dev.x.shape[0] - 1)]
    node_graph = torch.where(node_ok, slot_c, slots)

    epos = torch.arange(e_start, e_start + e_pad, device=device)
    eslot_c = segment_of(edge_off[1:], epos).clamp(max=slots - 1)
    edge_ok = epos < edge_off[slots]
    erow = torch.where(edge_ok, dev.edge_start[g[eslot_c]] + epos - edge_off[eslot_c], 0)
    base = node_off[eslot_c]
    edge_src = torch.where(edge_ok, dev.edge_src[erow] + base, 0)
    edge_dst = torch.where(edge_ok, dev.edge_dst[erow] + base, n_pad - 1)

    i32 = torch.int32
    return GraphBatch(
        x=x,
        edge_src=edge_src.to(i32),
        edge_dst=edge_dst.to(i32),
        edge_mask=edge_ok.to(torch.float32),
        node_graph=node_graph.to(i32),
        node_mask=node_ok.to(torch.float32),
        y=torch.where(valid, dev.y[g], 0).to(i32),
        graph_mask=valid.to(torch.float32),
        num_graphs=valid.sum().to(i32),
    )


# the normalize's chunk: ~256 MB of adjacency at a time; the scatter's:
# 4M edges, whose index and sort buffers stay near 200 MB
_NORMALIZE_CHUNK_BYTES = 256 << 20
_SCATTER_CHUNK_EDGES = 1 << 22


def densify_on_device(dev: DeviceGraphSet, n_tile: int) -> DenseDataset:
    """A `DenseDataset` at tile `n_tile` (batching/dense.py layout: per-graph
    GCN-normalized adjacency, features, node mask, labels) built on the
    device of `dev` from the compact graphset, equal to the host builder
    `build_dense_dataset` bit for bit. Only the graphset crossed the link;
    the quadratic arrays are born on the device.

    The raw adjacency holds exact integer counts: the self-loop-stripped
    edge stream is added as 1.0s at (graph, dst, src) with
    `index_put_(accumulate=True)` (exact below 2^24), 4M edges at a time,
    then one self-loop on each real node. The normalization is the host
    builder's arithmetic (`pack_dense_batch`): fp32 degrees, dinv =
    1 / sqrt(deg), and `a * (dinv_i * dinv_j)` with the outer product
    taken first, in graph chunks of ~256 MB, in place. The degrees are
    integers, so dinv is read from a table of 1 / sqrt(k) that NumPy
    computes as the host builder does: the bits then do not depend on the
    device's square root and division, whose rounding torch does not pin
    (its multi-threaded CPU kernels have given other bits than NumPy's)."""
    g = int(dev.node_start.shape[0]) - 1
    device = dev.x.device
    pos = torch.arange(n_tile, device=device)
    node_ok = pos[None, :] < dev.node_count[:g, None]
    rows = dev.node_start[:g, None] + pos[None, :]
    x = dev.x[torch.where(node_ok, rows, dev.x.shape[0] - 1)]
    node_mask = node_ok.to(torch.float32)

    adj = torch.zeros((g, n_tile, n_tile), dtype=torch.float32, device=device)
    flat = adj.view(-1)
    for e0 in range(0, int(dev.edge_src.shape[0]), _SCATTER_CHUNK_EDGES):
        src = dev.edge_src[e0 : e0 + _SCATTER_CHUNK_EDGES]
        epos = torch.arange(e0, e0 + src.shape[0], device=device)
        graph = torch.searchsorted(dev.edge_start[1 : g + 1], epos, right=True)
        at = (graph * n_tile + dev.edge_dst[e0 : e0 + src.shape[0]]) * n_tile + src
        flat.index_put_((at,), torch.ones(src.shape[0], device=device), accumulate=True)
    adj.diagonal(dim1=1, dim2=2).add_(node_mask)

    deg = adj.sum(dim=2).long()
    with np.errstate(divide="ignore"):
        table = np.float32(1.0) / np.sqrt(np.arange(int(deg.max()) + 1 if deg.numel() else 1,
                                                    dtype=np.float32))
    table[0] = 0.0  # padded rows: no degree, no scale
    dinv = torch.from_numpy(table).to(device)[deg]
    chunk = max(1, _NORMALIZE_CHUNK_BYTES // (n_tile * n_tile * 4))
    for i0 in range(0, g, chunk):
        d = dinv[i0 : i0 + chunk]
        adj[i0 : i0 + chunk].mul_(d[:, :, None] * d[:, None, :])
    return DenseDataset(x=x, adj=adj, node_mask=node_mask,
                        y=dev.y[:g].to(torch.int32))


def densify_many_on_device(hosts, tiles, device, store=None):
    """`densify_on_device` of several classes: each host graphset
    (`build_device_graphset`) is moved to `device` and densified at its
    tile, one class after another, its compact arrays dropped as soon as
    its class is built. `store`, when given, maps each fp32 class to its
    storage dtypes before the next class is built (batching/dense.py
    `store_dtypes`), so at most one class is held in fp32."""
    hosts = list(hosts)
    out = []
    for i, t in enumerate(tiles):
        dev = device_graphset_to(hosts[i], device)
        hosts[i] = None
        data = densify_on_device(dev, int(t))
        out.append(store(data) if store is not None else data)
        del dev, data
    return out
