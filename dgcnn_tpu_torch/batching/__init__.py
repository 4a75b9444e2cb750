"""Batching: the dataset in a device layout and the on-device assembly
of a batch from graph ids (dense, block-sparse and COO layouts; the COO
layout also packs on the host, packer.py; the multi-tile module holds
only the sizing functions the layout choice reads)."""

from dgcnn_tpu_torch.batching.block_sparse import (
    BlockBatch,
    BlockGraphSet,
    block_batch_extents,
    block_graphset_to_device,
    build_block_graphset,
    gather_block_batch,
)
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
    "BlockBatch",
    "BlockGraphSet",
    "DenseDataset",
    "DenseGraphBatch",
    "block_batch_extents",
    "block_graphset_to_device",
    "build_block_graphset",
    "build_dense_dataset",
    "dense_tile",
    "gather_block_batch",
    "gather_dense_batch",
    "order_matrix",
    "pack_dense_batch",
]
