"""Command-line interface — the port of dgcnn_tpu/cli.py, with the same
flags. Runs on the GPU (`cuda`); `--platform cpu` runs the plain PyTorch
path on the CPU. `--platform probe` (a TPU transport health check) is
not ported and raises NotImplementedError. On several devices, one
process each (the port's mesh, parallel/mesh.py):

    torchrun --nproc_per_node 4 -m dgcnn_tpu_torch.cli --data_type DD \
        --synthetic --layout coo --mesh 2,2
    torchrun --nproc_per_node 2 -m dgcnn_tpu_torch.cli --data_type DD \
        --synthetic --layout halo --mesh 1,2    # nodes sharded over 2 ranks
    torchrun --nproc_per_node 2 -m dgcnn_tpu_torch.cli --data_type NCI1 \
        --synthetic --mesh 2,1    # auto: the folds' lockstep sharded over 2
    python -m dgcnn_tpu_torch.cli ... --mesh 2,2 --multihost \
        --coordinator HOST:PORT --num_processes 4 --process_id R

    python -m dgcnn_tpu_torch.cli --data_type NCI1 --synthetic --layout dense
    python -m dgcnn_tpu_torch.cli --data_type DD --synthetic   # block layout
    python -m dgcnn_tpu_torch.cli --data_type DD --synthetic --layout coo \
        [--spmm xla|onehot|pallas]
    python -m dgcnn_tpu_torch.cli --data_type MUTAG --synthetic --ckpt_every 5
    python -m dgcnn_tpu_torch.cli --data_type MUTAG --synthetic --ckpt_every 5 \
        --resume   # after a crash: skips complete folds, continues the rest
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from dgcnn_tpu_torch.config import DATASETS, Config
from dgcnn_tpu_torch.train.cv import run_cross_validation


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Model")
    parser.add_argument("--data_type", default="DD", type=str, choices=list(DATASETS),
                        help="dataset type")
    parser.add_argument("--batch_size", default=50, type=int, help="train batch size")
    parser.add_argument("--num_epochs", default=100, type=int, help="train epochs number")
    parser.add_argument("--seed", default=324, type=int, help="random seed")
    parser.add_argument("--data_root", default="data", type=str,
                        help="dataset root directory")
    parser.add_argument("--fold_dir", default=None, type=str,
                        help="directory with {train,test}_idx-<k>.txt fold files")
    parser.add_argument("--layout", default="auto",
                        choices=["auto", "coo", "dense", "multi", "block", "halo"],
                        help="batch layout; halo shards each sub-batch's "
                             "nodes over the mesh's graph axis (needs --mesh); "
                             "auto picks as the reference does")
    parser.add_argument("--mesh", default="1,1", type=str,
                        help="process grid 'data,graph' (e.g. 2,2 = 2-way data "
                             "parallel x 2-way edge-partitioned), one process "
                             "per device: launch D*G processes (torchrun, or "
                             "the multi-host flags below)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the run's process group before the first "
                             "device touch: tcp://--coordinator with the two "
                             "flags below, else torchrun's environment "
                             "(env://); implied under torchrun")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="rank 0's host:port (tcp:// rendezvous)")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="the run's process count (the world size)")
    parser.add_argument("--process_id", default=None, type=int,
                        help="this process's rank")
    parser.add_argument("--lr", default=1e-3, type=float, help="Adam learning rate")
    parser.add_argument("--sortpool_k", default=30, type=int,
                        help="SortPooling k (overridden by --sortpool_percentile)")
    parser.add_argument("--hidden_dims", default="32,32,32,1", type=str,
                        help="comma-separated GCN layer widths")
    parser.add_argument("--dense_dim", default=128, type=int,
                        help="width of the penultimate dense layer")
    parser.add_argument("--dropout", default=0.5, type=float,
                        help="dropout rate before the classifier")
    parser.add_argument("--num_folds", default=10, type=int,
                        help="cross-validation fold count")
    parser.add_argument("--spmm", default="auto",
                        choices=["auto", "xla", "onehot", "pallas"],
                        help="COO SpMM kernel on the card: xla = the "
                             "row-parallel CSR kernel, onehot = the "
                             "edge-block kernel, pallas = the block-COO "
                             "kernel on host-packed batches, auto = the "
                             "faster on the DD COO main path; on the CPU "
                             "every value runs the plain PyTorch version")
    parser.add_argument("--sortpool_percentile", default=None, type=float,
                        help="pick SortPooling k as this quantile of graph sizes")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype: bfloat16 runs matmul operands "
                             "and layer outputs in bf16 with fp32 sums "
                             "(parameters, the loss and Adam stay fp32) on "
                             "the dense, multi and block layouts; the COO "
                             "layout refuses it")
    parser.add_argument("--adj_dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="adjacency and block-pool storage dtype (auto = "
                             "float32 on the card); bfloat16 halves them and "
                             "runs the kernels' bf16 modes; the COO layout "
                             "ignores it")
    parser.add_argument("--block_impl", default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="block-sparse propagation kernel on the card: "
                             "pallas = the CSR kernel, xla = the "
                             "item-parallel kernel, auto = the faster on "
                             "the DD main path; on the CPU every value runs "
                             "the plain PyTorch version")
    parser.add_argument("--dense_trunk", default="auto",
                        choices=["auto", "xla", "fused"],
                        help="accepted for parity: the port always runs its "
                             "CUDA trunk kernel on the card")
    parser.add_argument("--multi_min_tile", type=int, default=256,
                        help="smallest tile of the multi-tile ladder (read by "
                             "the layout choice)")
    parser.add_argument("--opt_flatten", action="store_true",
                        help="one Adam update over the raveled parameter "
                             "vector (the same bits; vector-shaped bundles)")
    parser.add_argument("--synthetic", action="store_true",
                        help="allow synthetic profile data when the real "
                             "dataset is unavailable offline")
    parser.add_argument("--resume", action="store_true",
                        help="resume a partial run: skip complete folds, "
                             "continue the others from their in-flight bundles")
    parser.add_argument("--ckpt_every", default=0, type=int,
                        help="write an in-flight resume bundle every N epochs "
                             "(epochs/<DS>_<fold>_inflight; lockstep: "
                             "epochs/<DS>_lockstep_inflight)")
    parser.add_argument("--log_every", default=0, type=int,
                        help="print metrics every N epochs (0 = per-fold only)")
    parser.add_argument("--out_root", default=None, type=str, metavar="DIR",
                        help="write artifacts under DIR/statistics and DIR/epochs")
    parser.add_argument("--tensorboard", default=None, type=str, metavar="DIR",
                        help="export the run's events as TensorBoard scalars "
                             "under DIR at run end (needs tensorboardX)")
    parser.add_argument("--profile", default=None, type=str, metavar="DIR",
                        help="write a torch.profiler trace of the run (host "
                             "ops, and the card's kernels) to "
                             "DIR/trace_<pid>.json")
    parser.add_argument("--platform", default="auto",
                        choices=["auto", "cpu", "probe"],
                        help="auto = the GPU (raises when CUDA is absent); "
                             "cpu = the plain PyTorch path on the CPU")
    return parser.parse_args(argv)


def under_torchrun() -> bool:
    """Whether torchrun (or another launcher of its kind) started this
    process: its standard environment is set."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                         "MASTER_PORT"))


def main(argv=None):
    opt = get_args(argv)
    if opt.platform == "probe":
        raise NotImplementedError(
            "not ported: --platform probe, a TPU transport health check")
    cfg = Config(
        data_type=opt.data_type,
        batch_size=opt.batch_size,
        num_epochs=opt.num_epochs,
        seed=opt.seed,
        data_root=opt.data_root,
        fold_index_dir=opt.fold_dir,
        layout=opt.layout,
        mesh_shape=tuple(int(v) for v in opt.mesh.split(",")),
        spmm_impl=opt.spmm,
        compute_dtype=opt.dtype,
        adj_dtype=opt.adj_dtype,
        block_impl=opt.block_impl,
        dense_trunk=opt.dense_trunk,
        multi_dense_min_tile=opt.multi_min_tile,
        learning_rate=opt.lr,
        sort_pool_k=opt.sortpool_k,
        hidden_dims=tuple(int(v) for v in opt.hidden_dims.split(",")),
        dense_dim=opt.dense_dim,
        dropout_rate=opt.dropout,
        num_folds=opt.num_folds,
        sort_pool_percentile=opt.sortpool_percentile,
        opt_flatten=opt.opt_flatten,
        checkpoint_resume=opt.resume,
        checkpoint_every=opt.ckpt_every,
        log_every=opt.log_every,
        tensorboard_dir=opt.tensorboard,
        **(
            {
                "epochs_dir": os.path.join(opt.out_root, "epochs"),
                "statistics_dir": os.path.join(opt.out_root, "statistics"),
            }
            if opt.out_root else {}
        ),
    )
    device = "cpu" if opt.platform == "cpu" else None
    if opt.multihost or opt.coordinator or under_torchrun():
        from dgcnn_tpu_torch.parallel.mesh import initialize_multihost

        initialize_multihost(opt.coordinator, opt.num_processes, opt.process_id,
                             device=device)
    ranks = cfg.mesh_shape[0] * cfg.mesh_shape[1]
    if ranks > 1 and not torch.distributed.is_initialized():
        from dgcnn_tpu_torch.parallel.mesh import LAUNCH_HINT

        raise RuntimeError(f"--mesh {opt.mesh} needs {ranks} processes: {LAUNCH_HINT}")
    ctx = contextlib.nullcontext()
    if opt.profile:
        from dgcnn_tpu_torch.utils.profiling import trace

        ctx = trace(opt.profile)
    with ctx:
        return run_cross_validation(cfg, allow_synthetic=opt.synthetic, device=device)


if __name__ == "__main__":
    main()
