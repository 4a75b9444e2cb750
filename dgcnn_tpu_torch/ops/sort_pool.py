"""SortPooling — the port of dgcnn_tpu/ops/sort_pool.py: `sort_pool_dense`
(:233) for the dense layout, the global lexicographic `sort_pool` (:64)
with its row-block prefilter (:27) for the packed node axis of the
block-sparse layout, and `sort_pool_folds` (:125) for the block layout's
fold-lockstep."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k_order(key: torch.Tensor, k: int):
    """(values, indices) of the k largest keys along dim 1, in the order
    the reference's `lax.top_k` gives: descending, equal keys by lower
    index, and +0.0 before −0.0 (top_k orders floats totally, where a
    plain sort holds ±0 equal). Two stable sorts — sign bit first, then
    value — since `torch.topk`'s tie order on CUDA is unspecified."""
    by_sign = torch.sort(torch.signbit(key).to(torch.uint8), dim=1, stable=True).indices
    vals, order = torch.sort(torch.gather(key, 1, by_sign), dim=1,
                             descending=True, stable=True)
    return vals[:, :k], torch.gather(by_sign, 1, order[:, :k])


def sort_pool_dense(x: torch.Tensor, node_mask: torch.Tensor, k: int) -> torch.Tensor:
    """[B, n, C] → [B, k, C]: each graph's k nodes with the largest last
    channel, in descending order.

    Equal keys keep the lower node index first (PyG's stable descending
    sort, the reference's `lax.top_k`; `top_k_order`). Masked nodes
    key at −inf; rows whose key is not finite (graphs with fewer than k
    real nodes) are zeroed. A node axis shorter than k is zero-padded.
    Selection is a gather: each output row is exactly one input row, and
    the indices of a row are distinct, so its backward adds each gradient
    once (deterministic on the card)."""
    if x.shape[1] < k:
        pad = k - x.shape[1]
        x = F.pad(x, (0, 0, 0, pad))
        node_mask = F.pad(node_mask, (0, pad))
    key = torch.where(
        node_mask > 0, x[..., -1].to(torch.float32),
        torch.full_like(node_mask, float("-inf"), dtype=torch.float32),
    )
    top_val, top_idx = top_k_order(key, k)
    pooled = torch.gather(
        x, 1, top_idx[..., None].expand(-1, -1, x.shape[2])
    )
    return torch.where(torch.isfinite(top_val)[..., None], pooled,
                       torch.zeros_like(pooled))


def _row_block_candidates(key, node_graph, num_graph_slots, k, row_block):
    """Per-row-block top-k prefilter (dgcnn_tpu/ops/sort_pool.py:27): when
    the packed node axis splits into `row_block`-sized runs that each
    belong to one graph (the block layout packs graphs block-row
    aligned), a graph's global top k lies inside the union of its
    row-blocks' top k, so the sort runs over nb·k candidates instead of
    nb·row_block nodes. Each row block's top k is taken in `lax.top_k`'s
    order (`top_k_order`), and candidates enumerate in (row, rank)
    order, which for equal keys is node order.

    Returns (cand_key [nb·k], cand_graph [nb·k], node_idx [nb·k])."""
    nb = key.shape[0] // row_block
    keym = torch.where(
        node_graph < num_graph_slots, key, torch.full_like(key, float("-inf"))
    ).reshape(nb, row_block)
    val, idx = top_k_order(keym, k)
    base = torch.arange(nb, device=key.device)[:, None] * row_block
    node_idx = (idx + base).reshape(-1)
    cand_graph = torch.gather(node_graph.reshape(nb, row_block), 1, idx).reshape(-1)
    return val.reshape(-1), cand_graph, node_idx


def sort_pool(x: torch.Tensor, node_graph: torch.Tensor, num_graph_slots: int,
              k: int, row_block: int = 0) -> torch.Tensor:
    """[N, C] packed node features → [num_graph_slots, k, C] — the port of
    the global lexicographic `sort_pool` (dgcnn_tpu/ops/sort_pool.py:64).

    Nodes sort by (graph ascending, last channel descending), stable in
    node order, done as two stable sorts (key first, then graph: torch has
    no multi-key sort). A node's rank inside its graph is its sorted
    position less its graph's first sorted position; (slot, rank) cells
    with rank < k take the node's row, cells of padded nodes
    (graph = num_graph_slots) or rank ≥ k are dropped, and empty cells are
    zero. `row_block` > k dividing N promises single-graph runs of that
    length and prefilters with `_row_block_candidates` (identical
    output). The kept indices are distinct, so the gather's backward adds
    each gradient once."""
    n = x.shape[0]
    key = x[:, -1].to(torch.float32)
    graph = node_graph.long()
    if row_block > k and n % row_block == 0:
        key, graph, node_idx = _row_block_candidates(
            key, graph, num_graph_slots, k, row_block
        )
    else:
        node_idx = torch.arange(n, device=x.device)

    by_key = torch.sort(key, descending=True, stable=True).indices
    g1 = graph[by_key]
    by_graph = torch.sort(g1, stable=True).indices
    g_sorted = g1[by_graph]
    perm = node_idx[by_key[by_graph]]

    slots = num_graph_slots
    starts = torch.searchsorted(
        g_sorted, torch.arange(slots, device=x.device), side="left"
    )
    pos = torch.arange(g_sorted.shape[0], device=x.device)
    rank = pos - starts[g_sorted.clamp(max=slots - 1)]
    keep = (g_sorted < slots) & (rank < k)
    # dropped entries all land in one spare cell past the end
    cell = torch.where(keep, g_sorted * k + rank, slots * k)
    idx = torch.full((slots * k + 1,), n, dtype=torch.long, device=x.device)
    idx = idx.scatter(0, cell, perm)[: slots * k]
    valid = idx < n
    pooled = x[idx.clamp(max=n - 1)].reshape(slots, k, x.shape[1])
    return torch.where(valid.reshape(slots, k, 1), pooled, torch.zeros_like(pooled))


def sort_pool_folds(x: torch.Tensor, node_graph: torch.Tensor, num_graph_slots: int,
                    k: int, row_block: int = 0) -> torch.Tensor:
    """Fold-lockstep SortPooling: [F, S, C] → [F, num_graph_slots, k, C],
    fold f's slots pooled from its own nodes as `sort_pool` pools one
    batch. One `sort_pool` over the flattened [F·S] nodes, fold f's slot
    g regrouped as f·num_graph_slots + g and every padded node in one
    group past the last: each group's nodes keep their node order, so
    each (fold, slot) takes the rows the per-fold sort gives it.
    `row_block` as in `sort_pool` (a row block never spans two folds when
    it divides S)."""
    f, s, c = x.shape
    fold_base = torch.arange(f, device=x.device)[:, None] * num_graph_slots
    gid = torch.where(node_graph < num_graph_slots, node_graph.long() + fold_base,
                      f * num_graph_slots)
    pooled = sort_pool(x.reshape(f * s, c), gid.reshape(-1), f * num_graph_slots, k,
                       row_block=row_block)
    return pooled.reshape(f, num_graph_slots, k, c)
