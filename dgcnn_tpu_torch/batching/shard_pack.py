"""Node-sharded batch packing for the halo layout — the port of
dgcnn_tpu/batching/shard_pack.py (`HaloBatch` :41, `halo_width` :83,
`pack_batch_halo` :91, `pack_step_halo` :202, `HaloBucket` :229,
`halo_bucket` :240, `pack_epoch_halo` :271, `halo_owned_order` :293).

Each graph-axis rank owns a NODE SHARD of one sub-batch, and boundary
rows move as neighbour exchanges (parallel/halo.py):

  * the packed node axis is split into G contiguous shards of S rows;
  * graphs are packed contiguously, so an edge's endpoints are at most one
    graph-span apart: a halo of H rows (H ≥ the largest graph) on each
    side makes every edge resolvable after one exchange with the two
    neighbouring shards;
  * each graph is OWNED by the shard holding its first node; the owner
    sees the whole graph inside its extended [H | S | H] row window, so
    SortPooling, the readout and the loss run shard-locally on owned
    graphs.

Index conventions per shard g:
  local rows    = global rows [g·S, (g+1)·S)
  extended rows = global [g·S − H, (g+1)·S + H), local coordinate
                  ext = global − g·S + H  ∈ [0, S + 2H)
  edge_dst_loc  ∈ [0, S)        (dst-partitioned: owner shard of dst)
  edge_src_ext  ∈ [0, S + 2H)   (always valid: |src − dst| < H)

Every field and every ValueError is the reference's, byte for byte; the
reference's per-node loop is array operations here. A rank of the
(data, graph) grid packs only its own sub-batch, and keeps its own shard
(`pack_epoch_halo(..., rank=(d, g))`): its G shards come out of one
contiguous packing of sub-batch d, as row d·G + g of `pack_step_halo`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from dgcnn_tpu_torch.data.graphset import GraphSet

FIELDS = ("x", "edge_src_ext", "edge_dst_loc", "edge_mask", "node_mask",
          "node_graph_ext", "y", "graph_mask", "num_graphs")


@dataclasses.dataclass
class HaloBatch:
    """One packed batch, node-sharded over the grid's graph axis with
    halo-resolvable edges (NumPy on the host, tensors on a device). In the
    full layout the leading axis is the shard (G; D·G for a step); one
    rank's view has no shard axis. All shapes static per bucket.

    x:              [G, S, F]      node features (zeros in padding)
    edge_src_ext:   [G, E_s]       source, EXTENDED local coords
    edge_dst_loc:   [G, E_s]       destination, local coords, sorted
    edge_mask:      [G, E_s]
    node_mask:      [G, S]
    node_graph_ext: [G, S+2H]      local slot of the row's graph IF this
                                   shard owns it, else B_s (pool mask)
    y:              [G, B_s]
    graph_mask:     [G, B_s]
    num_graphs:     [G]            owned-graph count per shard
    halo:           int (static)
    """

    x: np.ndarray
    edge_src_ext: np.ndarray
    edge_dst_loc: np.ndarray
    edge_mask: np.ndarray
    node_mask: np.ndarray
    node_graph_ext: np.ndarray
    y: np.ndarray
    graph_mask: np.ndarray
    num_graphs: np.ndarray
    halo: int = 0

    def map(self, fn) -> "HaloBatch":
        """Every array field through `fn` (the halo width kept)."""
        return dataclasses.replace(self, **{f: fn(getattr(self, f)) for f in FIELDS})


def combine(fn, batches: Sequence[HaloBatch]) -> HaloBatch:
    """Field by field, `fn` of the batches' arrays (concatenate, stack)."""
    return dataclasses.replace(
        batches[0], **{f: fn([getattr(b, f) for b in batches]) for f in FIELDS})


def halo_width(dataset: GraphSet, multiple: int = 64) -> int:
    """Bucket halo: the largest graph's node count rounded up — the bound
    that keeps every graph inside its owner's extended window and every
    edge within one neighbour exchange."""
    m = int(dataset.node_counts().max())
    return -(-m // multiple) * multiple


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The concatenated ranges [starts[i], starts[i] + counts[i])."""
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.repeat(starts, counts) + (np.arange(total) - first)


def pack_batch_halo(
    dataset: GraphSet,
    graph_indices: Sequence[int],
    n_shards: int,
    shard_nodes: int,
    shard_edges: int,
    shard_graphs: int,
    halo: int,
) -> HaloBatch:
    """Pack graphs contiguously into G node shards of `shard_nodes` rows.

    Self-loops are stripped and per-shard edges are destination-sorted,
    exactly like batching/packer.py."""
    idx = np.asarray(graph_indices, dtype=np.int64)
    g_count, s, h = n_shards, shard_nodes, halo
    f = dataset.num_features

    n_counts = dataset.node_counts()[idx]
    if int(n_counts.max(initial=0)) > h:
        raise ValueError(
            f"graph with {int(n_counts.max())} nodes exceeds halo {h}"
        )
    total = int(n_counts.sum())
    if total > g_count * s:
        raise ValueError(f"{total} nodes > {g_count}×{s} shard budget")

    # graphs in packing order: offset, owner shard and slot within it
    offsets = np.cumsum(n_counts) - n_counts
    owners = offsets // s
    first_of_owner = np.searchsorted(owners, owners, side="left")
    slots = np.arange(len(idx)) - first_of_owner
    escapes = offsets + n_counts > (owners + 1) * s + h
    over = slots >= shard_graphs
    bad = np.flatnonzero(escapes | over)
    if len(bad):  # the first failing graph decides, as the reference's loop
        i = int(bad[0])
        if escapes[i]:
            raise ValueError(
                f"graph of {int(n_counts[i])} nodes at offset {int(offsets[i])} "
                f"escapes shard {int(owners[i])}'s window (S={s}, H={h})"
            )
        raise ValueError(f"shard {int(owners[i])} exceeds {shard_graphs} slots")

    x = np.zeros((g_count, s, f), np.float32)
    node_mask = np.zeros((g_count, s), np.float32)
    node_graph_ext = np.full((g_count, s + 2 * h), shard_graphs, np.int32)
    y = np.zeros((g_count, shard_graphs), np.int32)
    graph_mask = np.zeros((g_count, shard_graphs), np.float32)
    y[owners, slots] = dataset.y[idx]
    graph_mask[owners, slots] = 1.0
    num_graphs = np.bincount(owners, minlength=g_count).astype(np.int32)

    n_glob = np.arange(total)
    sh = n_glob // s
    x[sh, n_glob - sh * s] = dataset.x[_ranges(dataset.node_ptr[idx], n_counts)]
    node_mask[sh, n_glob - sh * s] = 1.0
    # ownership rows in the OWNER's extended coordinates
    node_owner = np.repeat(owners, n_counts)
    node_graph_ext[node_owner, n_glob - node_owner * s + h] = np.repeat(slots, n_counts)

    e_counts = dataset.edge_counts()[idx]
    eidx = _ranges(dataset.edge_ptr[idx], e_counts)
    e_off = np.repeat(offsets, e_counts)
    src = dataset.edge_src[eidx].astype(np.int64) + e_off
    dst = dataset.edge_dst[eidx].astype(np.int64) + e_off
    keep = src != dst  # strip self-loops once
    src, dst = src[keep], dst[keep]
    dsh = dst // s  # dst-partitioned

    edge_src_ext = np.zeros((g_count, shard_edges), np.int32)
    edge_dst_loc = np.full((g_count, shard_edges), s - 1, np.int32)
    edge_mask = np.zeros((g_count, shard_edges), np.float32)
    for shard in range(g_count):
        m = dsh == shard
        n_e = int(m.sum())
        if not n_e:
            continue
        if n_e > shard_edges:
            raise ValueError(
                f"shard {shard}: {n_e} edges > budget {shard_edges}"
            )
        s_src, s_dst = src[m] - shard * s + h, dst[m] - shard * s
        order = np.argsort(s_dst, kind="stable")
        edge_src_ext[shard, :n_e] = s_src[order]
        edge_dst_loc[shard, :n_e] = s_dst[order]
        edge_mask[shard, :n_e] = 1.0
        # pad dst = S−1 keeps the dst column sorted across padding

    return HaloBatch(
        x=x, edge_src_ext=edge_src_ext, edge_dst_loc=edge_dst_loc,
        edge_mask=edge_mask, node_mask=node_mask, node_graph_ext=node_graph_ext,
        y=y, graph_mask=graph_mask, num_graphs=num_graphs, halo=h,
    )


def pack_step_halo(
    dataset: GraphSet,
    graph_indices: Sequence[int],
    n_data: int,
    n_graph: int,
    shard_nodes: int,
    shard_edges: int,
    shard_graphs: int,
    halo: int,
    rank: Optional[Tuple[int, int]] = None,
) -> HaloBatch:
    """One DP×halo training step: the batch split into `n_data` contiguous
    sub-batches (`np.array_split`), each node-sharded over `n_graph`
    shards, stacked data-major to [n_data·n_graph, ...] (sub-batch d's
    shards in rows [d·G, (d+1)·G)). With `rank` = (d, g), only sub-batch
    d is packed and its shard g returned, with no shard axis: row d·G + g
    of the full step."""
    idx = np.asarray(graph_indices, dtype=np.int64)
    splits = np.array_split(idx, n_data)
    geom = (n_graph, shard_nodes, shard_edges, shard_graphs, halo)
    if rank is not None:
        d, g = rank
        return pack_batch_halo(dataset, splits[d], *geom).map(lambda a: np.asarray(a[g]))
    return combine(lambda xs: np.concatenate(xs, axis=0),
                   [pack_batch_halo(dataset, part, *geom) for part in splits])


@dataclasses.dataclass(frozen=True)
class HaloBucket:
    """Static per-fold shard geometry (grow-only, like BucketSpec): every
    batch of ≤ batch_size graphs packs into it."""

    shard_nodes: int   # S — node rows per graph-axis shard
    shard_edges: int   # E_s — edge budget per shard
    shard_graphs: int  # B_s — owned-graph slots per shard
    halo: int          # H — exchange width (≥ max nodes per graph)


def halo_bucket(
    dataset: GraphSet,
    batch_size: int,
    n_data: int,
    n_graph: int,
    node_multiple: int = 64,
    edge_multiple: int = 512,
    graph_multiple: int = 4,
) -> HaloBucket:
    """Worst-case shard geometry over ANY batch composition (the
    `batch_size` largest graphs, mirroring compute_bucket). S ≥ H is a
    hard invariant: the left halo rows [g·S−H, g·S) must live inside the
    LEFT NEIGHBOUR's shard, which holds only S rows. The edge budget is
    the whole sub-batch's worst edge count (a shard can never hold
    more)."""
    h = halo_width(dataset, node_multiple)
    sub = max(1, -(-batch_size // n_data))
    nc = np.sort(dataset.node_counts())[::-1][:sub]
    ec = np.sort(dataset.edge_counts())[::-1][:sub]
    worst_nodes = int(nc.sum())
    s = max(-(-worst_nodes // n_graph), h)
    s = -(-s // node_multiple) * node_multiple
    e_s = max(int(ec.sum()), 1)
    e_s = -(-e_s // edge_multiple) * edge_multiple
    b_s = -(-sub // graph_multiple) * graph_multiple
    return HaloBucket(s, e_s, b_s, h)


def pack_epoch_halo(
    dataset: GraphSet,
    order: np.ndarray,
    batch_size: int,
    n_data: int,
    n_graph: int,
    bucket: HaloBucket,
    rank: Optional[Tuple[int, int]] = None,
) -> HaloBatch:
    """One epoch → a HaloBatch with leaves [steps, n_data·n_graph, ...]
    (with `rank` = (d, g): that rank's [steps, ...] alone)."""
    order = np.asarray(order, dtype=np.int64)
    steps = [
        pack_step_halo(
            dataset, order[i : i + batch_size], n_data, n_graph,
            bucket.shard_nodes, bucket.shard_edges, bucket.shard_graphs,
            bucket.halo, rank,
        )
        for i in range(0, len(order), batch_size)
    ]
    return combine(lambda xs: np.stack(xs, axis=0), steps)


def halo_owned_order(batch: HaloBatch) -> np.ndarray:
    """The stacked batch's real (device-major) graph slots in the original
    packing order: flat indices into the [D·G, B_s] slot grid. Contiguous
    packing assigns graphs to shards in order, so device-major slot
    traversal IS the original order; this drops the padded slots."""
    gm = np.asarray(batch.graph_mask).reshape(-1)
    return np.flatnonzero(gm > 0)
