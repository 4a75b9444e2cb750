"""Models: DGCNN on the dense and block-sparse layouts."""

from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNNet,
    apply_block,
    apply_dense,
    init_params,
    num_params,
)

__all__ = ["DGCNN", "DGCNNNet", "apply_block", "apply_dense", "init_params",
           "num_params"]
