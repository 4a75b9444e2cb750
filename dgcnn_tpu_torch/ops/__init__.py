"""Graph ops in plain PyTorch: SortPooling (dense and packed) and the
conv1d readout."""

from dgcnn_tpu_torch.ops.readout import conv1d_readout
from dgcnn_tpu_torch.ops.sort_pool import sort_pool, sort_pool_dense

__all__ = ["conv1d_readout", "sort_pool", "sort_pool_dense"]
