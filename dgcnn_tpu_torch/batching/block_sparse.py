"""Block-sparse (BSR-style) device-resident layout — the port of the
single-fold half of dgcnn_tpu/batching/block_sparse.py (`BlockGraphSet`
:69, `BlockBatch` :115, `build_block_graphset` :216,
`block_graphset_bytes` :302, `block_batch_extents` :320,
`gather_block_batch` :463).

Each graph's normalized adjacency D̂^{-1/2}(A+I)D̂^{-1/2} is cut into a
grid of bs×bs (128) blocks and only the nonzero blocks are stored, all
graphs sharing one flat pool [P+1, bs, bs] on the device (row P is a zero
block). A batch packs graphs onto a block-aligned node axis (graph g
occupies nb_g consecutive block-rows) and lists one work item per stored
block, (pool id, batch block-row, batch block-col), so one GCN
propagation is

    out[r] = Σ_{w: item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]

(kernels/block_csr.py, kernels/block_resident.py). The backward runs the
same product over a col-major traversal of the items (`item_permT`,
`item_colT`), baked in at build time.

What differs from the reference: `x_blocks` is stored [ΣNb+1, bs, F]. The
reference keeps [ΣNb+1, F, bs] only for the TPU's lane tiling; the
port's gather wants the node axis first, so a batch's features are one
leading-axis gather and a free reshape. Fold-lockstep
(`FoldBlockBatch`, `gather_block_batch_folds`) is ROADMAP Queue 1 item 9.

The build is NumPy on the host, once per run; the batch assembly is
torch tensor ops on the run's device from a [slots] graph-id row, so an
epoch ships only its int32 order matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.data.graphset import GraphSet

BLOCK_SIZE = 128


@dataclasses.dataclass
class BlockGraphSet:
    """A whole GraphSet in block-sparse form: NumPy arrays after
    `build_block_graphset`, tensors after `block_graphset_to_device`.
    Sentinels: pool row P is a zero block (padded work items), x_blocks
    row ΣNb is a zero block-row, table row G is a zero-count graph.

    pool:        [P+1, bs, bs] normalized adjacency blocks (+ zero block)
    block_row:   [P+1]  graph-local block-row of each pool block
    block_col:   [P+1]  graph-local block-col
    trperm:      [P+1]  within-graph col-major rank → row-major rank
    block_start: [G+1]  first pool index of each graph (+ sentinel)
    block_count: [G+1]  stored blocks per graph (+ 0)
    nb:          [G+1]  block-rows per graph = ceil(n_g/bs) (+ 0)
    x_blocks:    [ΣNb+1, bs, F] node features as padded block-rows
                        (+ zero sentinel block-row)
    bofs:        [G+1]  first x_blocks row of each graph (+ total)
    node_count:  [G+1]  nodes per graph (+ 0)
    y:           [G+1]  labels (+ 0)
    """

    pool: object
    block_row: object
    block_col: object
    trperm: object
    block_start: object
    block_count: object
    nb: object
    x_blocks: object
    bofs: object
    node_count: object
    y: object


@dataclasses.dataclass
class BlockBatch:
    """One assembled block-sparse batch (every shape set by the budgets).

    x:          [S, F]   packed node features, S = nb_budget·bs
    item_pool:  [W]      pool index per work item (sentinel P when padded)
    item_row:   [W]      batch block-row (destination), non-decreasing;
                         nb_budget for padded items
    item_col:   [W]      batch block-col (source); 0 for padded items
    item_permT: [W]      col-major traversal: item index of the w-th block
                         in (slot, col, row) order (identity on padding)
    item_colT:  [W]      batch block-col in that order, non-decreasing;
                         nb_budget on padding
    node_graph: [S]      graph slot per node (slots when padding)
    node_mask:  [S]
    y:          [slots]
    graph_mask: [slots]
    num_graphs: []
    num_items:  []       real work-item count (≤ W)
    """

    x: torch.Tensor
    item_pool: torch.Tensor
    item_row: torch.Tensor
    item_col: torch.Tensor
    item_permT: torch.Tensor
    item_colT: torch.Tensor
    node_graph: torch.Tensor
    node_mask: torch.Tensor
    y: torch.Tensor
    graph_mask: torch.Tensor
    num_graphs: torch.Tensor
    num_items: torch.Tensor


def build_block_graphset(dataset: GraphSet, bs: int = BLOCK_SIZE) -> BlockGraphSet:
    """Host-side one-time build: per graph, strip self-loops, find the
    nonzero block grid of Â = A+I, materialize each block with the
    symmetric normalization baked in (adj[dst, src], out = adj @ h),
    sorted by (row, col). The same bytes as the reference's build, with
    x_blocks node-axis first."""
    g = dataset.num_graphs
    f = dataset.num_features
    nc = dataset.node_counts()
    nb = -(-nc // bs)

    pools, rows, cols, perms, xbs = [], [], [], [], []
    counts = np.zeros(g + 1, np.int32)
    for i in range(g):
        n = int(nc[i])
        es, ee = dataset.edge_ptr[i], dataset.edge_ptr[i + 1]
        s = dataset.edge_src[es:ee].astype(np.int64)
        d = dataset.edge_dst[es:ee].astype(np.int64)
        keep = s != d
        s, d = s[keep], d[keep]

        # deg_hat = in-degree of stripped edges + 1 (the re-added self-loop)
        deg = np.bincount(d, minlength=n).astype(np.float64) + 1.0
        dinv = 1.0 / np.sqrt(deg)

        nbi = int(nb[i])
        bid = (d // bs) * nbi + (s // bs)
        diag = np.arange(nbi, dtype=np.int64) * nbi + np.arange(nbi)
        present = np.unique(np.concatenate([bid, diag]))
        lut = np.full(nbi * nbi, -1, np.int64)
        lut[present] = np.arange(len(present))

        blocks = np.zeros((len(present), bs, bs), np.float32)
        w = (dinv[d] * dinv[s]).astype(np.float32)
        np.add.at(blocks, (lut[bid], d % bs, s % bs), w)
        r_idx = np.arange(n, dtype=np.int64)
        np.add.at(
            blocks,
            (lut[diag[r_idx // bs]], r_idx % bs, r_idx % bs),
            (dinv * dinv).astype(np.float32),
        )

        r_of = (present // nbi).astype(np.int32)
        c_of = (present % nbi).astype(np.int32)
        pools.append(blocks)
        rows.append(r_of)
        cols.append(c_of)
        perms.append(np.lexsort((r_of, c_of)).astype(np.int32))
        counts[i] = len(present)

        xb = np.zeros((nbi * bs, f), np.float32)
        xb[:n] = dataset.x[dataset.node_ptr[i] : dataset.node_ptr[i + 1]]
        xbs.append(xb.reshape(nbi, bs, f))

    block_start = np.zeros(g + 1, np.int32)
    np.cumsum(counts[:-1], out=block_start[1:])
    bofs = np.zeros(g + 1, np.int32)
    np.cumsum(nb, out=bofs[1:])
    zi = np.zeros(1, np.int32)
    return BlockGraphSet(
        pool=np.concatenate(pools + [np.zeros((1, bs, bs), np.float32)]),
        block_row=np.concatenate(rows + [zi]),
        block_col=np.concatenate(cols + [zi]),
        trperm=np.concatenate(perms + [zi]),
        block_start=block_start,
        block_count=counts,
        nb=np.concatenate([nb.astype(np.int32), [0]]),
        x_blocks=np.concatenate(xbs + [np.zeros((1, bs, f), np.float32)]),
        bofs=bofs,
        node_count=np.concatenate(
            [np.diff(dataset.node_ptr).astype(np.int32), [0]]
        ),
        y=np.concatenate([dataset.y.astype(np.int32), [0]]),
    )


def block_graphset_to_device(host: BlockGraphSet, device) -> BlockGraphSet:
    """One transfer per array. Index tables become int64 (torch indexes
    with them); pool and features stay float32."""
    out = {}
    for fld in dataclasses.fields(BlockGraphSet):
        a = np.asarray(getattr(host, fld.name))
        t = torch.from_numpy(a)
        out[fld.name] = (t if a.dtype == np.float32 else t.long()).to(device)
    return BlockGraphSet(**out)


def block_graphset_bytes(dataset: GraphSet, bs: int = BLOCK_SIZE) -> int:
    """Cheap host estimate of the device pool size (upper-bounds the exact
    block grid with per-graph unique (dst//bs, src//bs) pairs plus
    diagonals)."""
    total = 0
    nc = dataset.node_counts()
    for i in range(dataset.num_graphs):
        es, ee = dataset.edge_ptr[i], dataset.edge_ptr[i + 1]
        nbi = -(-int(nc[i]) // bs)
        bid = (dataset.edge_dst[es:ee].astype(np.int64) // bs) * nbi + (
            dataset.edge_src[es:ee].astype(np.int64) // bs
        )
        diag = np.arange(nbi, dtype=np.int64) * (nbi + 1)
        total += len(np.unique(np.concatenate([bid, diag])))
    nbsum = int((-(-nc // bs)).sum())
    return (total * bs * bs + nbsum * bs * dataset.num_features) * 4


def block_batch_extents(
    nb: np.ndarray, block_count: np.ndarray, order_mat: np.ndarray
) -> Tuple[int, int]:
    """Max (Σ block-rows, Σ work items) over the batch rows of an order
    matrix (last axis = graph slots, −1 padding): the host-side source
    of truth for budget sizing."""
    rows = np.asarray(order_mat).reshape(-1, order_mat.shape[-1])
    safe = np.maximum(rows, 0)
    valid = rows >= 0
    nbs = int((np.asarray(nb)[safe] * valid).sum(axis=1).max())
    w = int((np.asarray(block_count)[safe] * valid).sum(axis=1).max())
    return nbs, w


def segment_of(cum_ends: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """`searchsorted(cum_ends, pos, side="right")` for a small sorted
    `cum_ends` (the batch's per-slot offsets): the count of segment ends
    ≤ pos, as one [len(pos), slots] compare and row sum — the port's copy
    of dgcnn_tpu/batching/device_coo.py:299."""
    return (pos[:, None] >= cum_ends[None, :]).sum(dim=1)


def gather_block_batch(
    dev: BlockGraphSet, idx_row: torch.Tensor, nb_budget: int, w_budget: int
) -> BlockBatch:
    """Assemble one BlockBatch on the device of `dev` from [slots] graph
    ids (−1 = empty slot); every shape is set by the budgets.

    Graph g of slot s occupies batch block-rows [Σ nb_before, +nb_g) and
    node rows block-aligned under them; work items are each slot's stored
    blocks with row and col rebased by the slot's block-row offset.
    item_row is non-decreasing (blocks are (row, col)-sorted per graph),
    and item_permT/item_colT give the col-major traversal whose segment
    ids are non-decreasing too. Everything is index math at block
    granularity plus leading-axis block gathers; padded node rows are
    exact zeros (zero-padded at build time)."""
    bs = dev.pool.shape[1]
    slots = idx_row.shape[0]
    num_graphs_total = dev.block_start.shape[0] - 1
    sentinel_pool = dev.pool.shape[0] - 1
    sentinel_xb = dev.x_blocks.shape[0] - 1
    device = idx_row.device

    valid = idx_row >= 0
    g = torch.where(valid, idx_row.long(), num_graphs_total)
    zero = torch.zeros(1, dtype=torch.long, device=device)

    nbs = dev.nb[g]
    bo = torch.cat([zero, torch.cumsum(nbs, 0)])  # [slots+1]

    # nodes, per block-row: block-row q belongs to the slot whose
    # cumulative block range contains q
    q = torch.arange(nb_budget, device=device)
    slot_c = segment_of(bo[1:], q).clamp(max=slots - 1)
    q_ok = q < bo[slots]
    qin = q - bo[slot_c]
    gq = g[slot_c]
    xb_row = torch.where(q_ok, dev.bofs[gq] + qin, sentinel_xb)
    x = dev.x_blocks[xb_row].reshape(nb_budget * bs, -1)

    lane = torch.arange(bs, device=device)
    n_of = dev.node_count[gq]
    node_ok = q_ok[:, None] & ((qin[:, None] * bs + lane[None, :]) < n_of[:, None])
    node_graph = torch.where(node_ok, slot_c[:, None], slots)

    # work items: the same mapping over the block counts
    wc = dev.block_count[g]
    wo = torch.cat([zero, torch.cumsum(wc, 0)])
    wpos = torch.arange(w_budget, device=device)
    wslot_c = segment_of(wo[1:], wpos).clamp(max=slots - 1)
    j = wpos - wo[wslot_c]
    w_ok = wpos < wo[slots]
    gw = g[wslot_c]
    own = dev.block_start[gw] + j
    pool_id = torch.where(w_ok, own, sentinel_pool)
    base = bo[wslot_c]
    item_row = torch.where(w_ok, base + dev.block_row[pool_id], nb_budget)
    item_col = torch.where(w_ok, base + dev.block_col[pool_id], 0)

    # col-major traversal: the w-th block in (slot, col, row) order is the
    # batch item (wpos − j + trperm[j-th of graph]); identity on padding
    jt = dev.trperm[pool_id]
    permT = torch.where(w_ok, wpos - j + jt, wpos)
    pool_idT = torch.where(w_ok, dev.block_start[gw] + jt, sentinel_pool)
    item_colT = torch.where(w_ok, base + dev.block_col[pool_idT], nb_budget)

    i32 = torch.int32
    return BlockBatch(
        x=x,
        item_pool=pool_id.to(i32),
        item_row=item_row.to(i32),
        item_col=item_col.to(i32),
        item_permT=permT.to(i32),
        item_colT=item_colT.to(i32),
        node_graph=node_graph.reshape(-1).to(i32),
        node_mask=node_ok.reshape(-1).to(torch.float32),
        y=torch.where(valid, dev.y[g], 0).to(i32),
        graph_mask=valid.to(torch.float32),
        num_graphs=valid.sum().to(i32),
        num_items=wo[slots].to(i32),
    )
