"""Models: DGCNN on the dense, block-sparse and COO layouts, and the
fold-stacked dense forward of fold-lockstep."""

from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNFoldsNet,
    DGCNNNet,
    apply_block,
    apply_coo,
    apply_dense,
    apply_dense_folds,
    init_params,
    num_params,
)

__all__ = ["DGCNN", "DGCNNFoldsNet", "DGCNNNet", "apply_block", "apply_coo",
           "apply_dense", "apply_dense_folds", "init_params", "num_params"]
