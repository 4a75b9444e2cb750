"""Batching: host packing of graphs into device layouts (dense layout in
this slice; the multi-tile and block-sparse modules hold only the sizing
functions the layout choice reads)."""

from dgcnn_tpu_torch.batching.dense import (
    DenseDataset,
    DenseGraphBatch,
    build_dense_dataset,
    dense_tile,
    gather_dense_batch,
    order_matrix,
    pack_dense_batch,
)

__all__ = [
    "DenseDataset",
    "DenseGraphBatch",
    "build_dense_dataset",
    "dense_tile",
    "gather_dense_batch",
    "order_matrix",
    "pack_dense_batch",
]
