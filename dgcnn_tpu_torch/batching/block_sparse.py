"""Sizing half of dgcnn_tpu/batching/block_sparse.py: the device-pool
estimate that `train/cv.py choose_layout` reads. The block-sparse engine
itself is not ported yet (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

import numpy as np

from dgcnn_tpu_torch.data.graphset import GraphSet

BLOCK_SIZE = 128


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
