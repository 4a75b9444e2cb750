"""Parallelism over a (data, graph) process grid — the port of
dgcnn_tpu/parallel (less `batch_pspecs` and `device_put_epoch`, which
place arrays on a JAX mesh: a rank here keeps its own selection,
`shard.local_view`), and the halo layout's node-sharded forward
(`halo.py`)."""

from dgcnn_tpu_torch.parallel.halo import (
    HaloExchange, apply_halo, make_halo_eval_epoch, make_halo_loss, make_halo_train_epoch,
)
from dgcnn_tpu_torch.parallel.mesh import (
    ProcessGrid, device_grid, initialize_multihost, make_mesh,
)
from dgcnn_tpu_torch.parallel.shard import (
    local_view, lpt_assign, pack_epoch_dp, partition_edges, shard_batch_for_dp,
    shard_bucket,
)
from dgcnn_tpu_torch.parallel.train_dp import (
    graphed_dp_run, make_block_dp_run, make_dense_dp_run, make_device_coo_dp_run,
    make_dp_eval_epoch, make_dp_train_epoch, make_sharded_loss, reduce_gradients,
)

__all__ = [
    "HaloExchange",
    "ProcessGrid",
    "apply_halo",
    "device_grid",
    "graphed_dp_run",
    "initialize_multihost",
    "local_view",
    "lpt_assign",
    "make_block_dp_run",
    "make_dense_dp_run",
    "make_device_coo_dp_run",
    "make_dp_eval_epoch",
    "make_dp_train_epoch",
    "make_halo_eval_epoch",
    "make_halo_loss",
    "make_halo_train_epoch",
    "make_mesh",
    "make_sharded_loss",
    "pack_epoch_dp",
    "partition_edges",
    "reduce_gradients",
    "shard_batch_for_dp",
    "shard_bucket",
]
