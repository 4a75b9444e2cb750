"""Models: DGCNN on the dense, block-sparse and COO layouts."""

from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNNet,
    apply_block,
    apply_coo,
    apply_dense,
    init_params,
    num_params,
)

__all__ = ["DGCNN", "DGCNNNet", "apply_block", "apply_coo", "apply_dense",
           "init_params", "num_params"]
