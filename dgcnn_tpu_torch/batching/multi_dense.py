"""Sizing half of dgcnn_tpu/batching/multi_dense.py: the tile ladder and
its device footprint, which `train/cv.py choose_layout` reads to decide
between the dense and multi-tile layouts. The multi-tile engine itself is
not ported yet (ROADMAP Queue 1 item 7)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dgcnn_tpu_torch.data.graphset import GraphSet


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


def tile_class_of(node_counts: np.ndarray, tiles: Sequence[int]) -> np.ndarray:
    """[G] index of the smallest tile that holds each graph."""
    nc = np.asarray(node_counts)
    if len(nc) and int(nc.max()) > int(tiles[-1]):
        raise ValueError(
            f"largest graph has {int(nc.max())} nodes > top tile "
            f"{int(tiles[-1])}; tiles must cover every graph"
        )
    return np.searchsorted(np.asarray(tiles), nc, side="left").astype(np.int32)


def multi_dense_bytes(dataset: GraphSet, tiles: Sequence[int]) -> int:
    class_of = tile_class_of(dataset.node_counts(), tiles)
    total = 0
    for c, t in enumerate(tiles):
        g = int((class_of == c).sum())
        total += g * int(t) * (int(t) + dataset.num_features + 1) * 4
    return total
