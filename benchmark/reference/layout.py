"""Which U[0, 1) dropout row the program gives each graph of a training
batch, worked out again from the graphs and the program's published
layout rules, never read from the program.

The program draws one row of `dense_dim` uniforms for every graph slot
of a step, padded slots included, and a graph keeps the row of its slot.
In fold-lockstep each fold draws its own step's rows from its own
generator, and draws nothing on a step where it has no graph, so that
its rows are those it would draw alone. The slots of a step, by the
engine `make_engine` builds on one card:

  * dense, block-sparse and COO layouts (`DenseRows`), sequential or in
    lockstep, the COO layout's device-assembled and host-packed engines
    alike: `round_up(batch, graph_pad_multiple)` slots, the batch's
    graphs in order, then padding;
  * multi-tile dense layout (`MultiRows`): the graphs split by tile class
    (the smallest tile of the ×2 ladder from `min_tile` that holds the
    graph; the top tile is the largest graph rounded up to 8), class c's
    graphs in batch order in its S_c slots, the classes side by side.
    The slot counts start at 4 a class, grow over 40 permutations of all
    graphs (batches of `batch`) from `default_rng(SeedSequence([seed,
    0]))`, round up to 4 and are capped at `round_up(batch, 4)`; then
    each chunk grows them to its batches' and the test batches' largest
    class counts, rounded up to 4, and never shrinks them. Folds one
    after another: the chunk's own fold's batches and test graphs, over
    every chunk run before in the process; in lockstep: every fold's
    batches of the chunk and every fold's test graphs.
"""

from __future__ import annotations

import numpy as np


def _round_up(x, m):
    return -(-x // m) * m


def plan_tiles(node_counts: np.ndarray, min_tile: int, multiple: int = 8) -> tuple:
    max_n = int(node_counts.max())
    tiles, t = [], min_tile
    while t < max_n:
        tiles.append(t)
        t *= 2
    tiles.append(_round_up(max_n, multiple))
    kept, prev = [], 0
    for t in tiles:
        if ((node_counts > prev) & (node_counts <= t)).any():
            kept.append(t)
        prev = t
    return tuple(kept)


class DenseRows:
    def __init__(self, batch: int, pad_multiple: int):
        self.slots = _round_up(batch, pad_multiple)

    def start_chunk(self, *seqs) -> None:
        pass

    def __call__(self, epoch: int, ids) -> tuple:
        return np.arange(len(ids)), self.slots


class MultiRows:
    def __init__(self, node_counts: np.ndarray, batch: int, min_tile: int, seed: int):
        self.batch = batch
        self.tiles = plan_tiles(node_counts, min_tile)
        self.class_of = np.searchsorted(np.asarray(self.tiles), node_counts, side="left")
        self.slots = np.full(len(self.tiles), 4, dtype=np.int64)
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0]))
        self.grow(*(rng.permutation(len(node_counts)) for _ in range(40)))
        self.slots = np.minimum(self.slots, _round_up(batch, 4))
        self.by_epoch = []

    def grow(self, *seqs) -> None:
        need = self.slots
        for ids in seqs:
            for s in range(0, len(ids), self.batch):
                cnt = np.bincount(self.class_of[ids[s:s + self.batch]],
                                  minlength=len(self.tiles))
                need = np.maximum(need, cnt)
        self.slots = _round_up(need, 4)

    def start_chunk(self, *seqs) -> None:
        """A chunk of one epoch: its training order and the test graphs."""
        self.grow(*seqs)
        self.by_epoch.append(self.slots.copy())

    def __call__(self, epoch: int, ids) -> tuple:
        slots = self.by_epoch[epoch]
        base = np.concatenate([[0], np.cumsum(slots)[:-1]])
        cls = self.class_of[np.asarray(ids)]
        rows = np.empty(len(ids), dtype=np.int64)
        for c in range(len(slots)):
            members = np.flatnonzero(cls == c)
            rows[members] = base[c] + np.arange(len(members))
        return rows, int(slots.sum())
