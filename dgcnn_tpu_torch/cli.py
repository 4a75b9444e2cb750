"""Command-line interface — the port of dgcnn_tpu/cli.py, with the same
flags. Runs on the GPU (`cuda`); `--platform cpu` runs the plain PyTorch
path on the CPU. Flags whose paths the port does not serve yet raise
NotImplementedError naming the ROADMAP item that ports them.

    python -m dgcnn_tpu_torch.cli --data_type NCI1 --synthetic --layout dense
    python -m dgcnn_tpu_torch.cli --data_type DD --synthetic   # block layout
"""

from __future__ import annotations

import argparse
import os

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
                        help="batch layout (the port serves dense and "
                             "block; auto picks as the reference does)")
    parser.add_argument("--mesh", default="1,1", type=str,
                        help="device mesh 'data,graph' (not ported: 1,1 only)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host runtime (not ported)")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="multi-host coordinator host:port (not ported)")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="multi-host process count (not ported)")
    parser.add_argument("--process_id", default=None, type=int,
                        help="multi-host rank (not ported)")
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
                        help="COO SpMM kernel (not ported: auto only)")
    parser.add_argument("--sortpool_percentile", default=None, type=float,
                        help="pick SortPooling k as this quantile of graph sizes")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (the port runs float32 only)")
    parser.add_argument("--adj_dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="adjacency storage dtype (auto = float32 here)")
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
                        help="flattened Adam update (not ported)")
    parser.add_argument("--synthetic", action="store_true",
                        help="allow synthetic profile data when the real "
                             "dataset is unavailable offline")
    parser.add_argument("--resume", action="store_true",
                        help="resume a partial run (not ported)")
    parser.add_argument("--ckpt_every", default=0, type=int,
                        help="in-flight resume bundle every N epochs (not ported)")
    parser.add_argument("--log_every", default=0, type=int,
                        help="print metrics every N epochs (0 = per-fold only)")
    parser.add_argument("--out_root", default=None, type=str, metavar="DIR",
                        help="write artifacts under DIR/statistics and DIR/epochs")
    parser.add_argument("--tensorboard", default=None, type=str, metavar="DIR",
                        help="TensorBoard export (not ported)")
    parser.add_argument("--profile", default=None, type=str, metavar="DIR",
                        help="device trace (not ported)")
    parser.add_argument("--platform", default="auto",
                        choices=["auto", "cpu", "probe"],
                        help="auto = the GPU (raises when CUDA is absent); "
                             "cpu = the plain PyTorch path on the CPU")
    return parser.parse_args(argv)


def main(argv=None):
    opt = get_args(argv)
    unserved = []
    if opt.multihost or opt.coordinator or opt.num_processes is not None \
            or opt.process_id is not None:
        unserved.append("multi-host runs (ROADMAP Queue 1 item 12)")
    if opt.profile:
        unserved.append("--profile (ROADMAP Queue 1 item 13)")
    if opt.platform == "probe":
        unserved.append("--platform probe, a TPU transport health check")
    if unserved:
        raise NotImplementedError("not ported yet: " + "; ".join(unserved))
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
    device = "cpu" if opt.platform == "cpu" else "cuda"
    return run_cross_validation(cfg, allow_synthetic=opt.synthetic, device=device)


if __name__ == "__main__":
    main()
