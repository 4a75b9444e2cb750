"""Single-device forward entry point — the port of `entry` in the
repository's `__graft_entry__.py` (:16-32).

`entry(device=None)` builds synthetic NCI1 (64 graphs, seed 0), packs
graphs 0-49 into one COO batch of the worst-case bucket
`compute_bucket(gs, 50)`, draws the flagship DGCNN's weights from a
seeded generator and returns `(forward, (params, batch))`, where
`forward(params, batch)` is the layout-polymorphic `apply`: on the card
the GCN layers' SpMMs run the row CSR kernel (kernels/spmm_pallas.py).
The device is the card unless the caller passes "cpu".

`torch.compile(forward)` accepts it. The row kernel is a ctypes call,
which Dynamo cannot trace; its launch is the operator
`dgcnn_tpu_torch::spmm_rows` (kernels/spmm_pallas.py) with a fake
implementation, so Dynamo traces the forward whole, in one graph, and the
compiled forward launches the kernel (chip_smoke.py counts the launches).

`dryrun_multichip(n_devices, device=None)` is the port of the
multi-device dry run (`__graft_entry__.py:35-235`), with its legs and
gates, over a (data, graph) process grid of n ranks (n_graph = 2 when n
is even, else 1), each rank a process of its own (`dryrun_rank`) that
joins the group through a `FileStore` in a temporary directory:

  * one DP train and one eval epoch of the sharded COO step, both finite;
  * `run_cross_validation` on synthetic MUTAG (4·n_data graphs as the
    reference, but at least 16: below its 8-device mesh that leaves two
    test graphs a fold, and the reference's own dry run fails its gate
    on 2 devices — a deliberate divergence) through the COO, dense
    (`cv_parallel="sequential"`, so that the dense mesh engine runs; on a
    (D, 1) grid `auto` would lockstep its folds) and block mesh engines,
    each ≥ 70 % mean test accuracy, and the halo engine when n_graph > 1;
  * fold-sharded lockstep, 10 folds of 60 graphs: (1, 1) against (n, 1),
    the per-fold test accuracies equal, 10 of them (no pad fold), ≥ 70 %.

With `device="cpu"` the ranks run `gloo` on the CPU; otherwise the cards:
`nccl` with one rank per card, or `gloo` where ranks must share a card
(nccl refuses two ranks on one card). A failed leg raises in its rank,
and `dryrun_multichip` raises with the ranks' output.

    python -m dgcnn_tpu_torch.graft_entry [--platform cpu]
    python -m dgcnn_tpu_torch.graft_entry --dryrun N [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def entry(device=None):
    """(forward, (params, batch)) on NCI1-profile shapes, on `device`."""
    from dgcnn_tpu_torch.batching.packer import batch_to_device, compute_bucket, pack_batch
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, apply, init_params
    from dgcnn_tpu_torch.train.cv import fp32_only, resolve_device

    dev = resolve_device(device)
    fp32_only()
    gs = synthesize_tu_dataset("NCI1", num_graphs=64, seed=0)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    params = init_params(torch.Generator().manual_seed(0), model, dev)
    batch = batch_to_device(pack_batch(gs, np.arange(50), compute_bucket(gs, 50)), dev)

    def forward(params, batch):
        return apply(params, model, batch)

    return forward, (params, batch)


DRYRUN_TIMEOUT = 1800.0  # seconds for all ranks together


def _mesh_cfg(td, **kw):
    """The dry run's CV config: the reference's pads and 20 epochs × 2
    folds, artifacts under `td`."""
    from dgcnn_tpu_torch.config import Config

    base = dict(data_type="MUTAG", num_epochs=20, num_folds=2, node_pad_multiple=64,
                edge_pad_multiple=64, graph_pad_multiple=2, data_root=f"{td}/data",
                epochs_dir=f"{td}/epochs", statistics_dir=f"{td}/statistics")
    return Config(**{**base, **kw})


def _learned(what, result) -> None:
    """The learnability gate: the planted synthetic signal is learnable in
    20 epochs, so a sharded step that computes garbage stays near chance
    (50 %)."""
    acc = result["test_accuracy_mean"]
    if not np.isfinite(acc) or acc < 70.0:
        raise AssertionError(f"{what} stuck near chance: {result}")


def dryrun_legs(n_devices: int, device) -> dict:
    """Every leg of the dry run on this rank (every rank calls it, in one
    order: each grid's groups are made collectively); the mean test
    accuracy of each leg."""
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
    from dgcnn_tpu_torch.parallel import (
        make_dp_eval_epoch, make_dp_train_epoch, make_mesh, pack_epoch_dp, shard_bucket,
    )
    from dgcnn_tpu_torch.parallel.train_dp import local_steps
    from dgcnn_tpu_torch.train.cv import run_cross_validation
    from dgcnn_tpu_torch.train.loop import make_optimizer

    rank = torch.distributed.get_rank()
    n_graph = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_graph
    grid = make_mesh((n_data, n_graph), device)
    dev = grid.device
    # the reference's 4·n_data graphs, at least its 8-device count (16):
    # fewer leave 2 test graphs a fold, and its own dry run on 2 devices
    # fails the 70 % gate there
    gs = synthesize_tu_dataset("MUTAG", num_graphs=4 * max(n_data, 4), seed=0)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model, dev))
    opt = make_optimizer(net, 1e-3)
    batch_size = 2 * n_data
    bucket = shard_bucket(gs, batch_size, n_data, node_multiple=64,
                          edge_multiple=64 * n_graph, graph_multiple=2, n_graph=n_graph)
    batches = pack_epoch_dp(gs, np.arange(gs.num_graphs), batch_size, bucket, n_data,
                            n_graph)
    loss, _ = make_dp_train_epoch(net, opt, grid)(
        batches, torch.Generator(device=dev).manual_seed(1))
    eval_loss, _ = make_dp_eval_epoch(net, grid)(local_steps(batches, grid, dev))
    if not (torch.isfinite(loss) and torch.isfinite(eval_loss)):
        raise AssertionError(f"DP epoch: train loss {float(loss)}, eval {float(eval_loss)}")
    out = {"dp_train_loss": float(loss), "dp_eval_loss": float(eval_loss)}

    legs = [("coo", dict(layout="coo", batch_size=2 * n_data,
                         mesh_shape=(n_data, n_graph))),
            ("dense", dict(layout="dense", batch_size=2 * n_devices,
                           mesh_shape=(n_devices, 1), cv_parallel="sequential")),
            ("block", dict(layout="block", batch_size=2 * n_data,
                           mesh_shape=(n_data, n_graph)))]
    if n_graph > 1:
        legs.append(("halo", dict(layout="halo", batch_size=2 * n_data,
                                  mesh_shape=(n_data, n_graph))))
    for name, kw in legs:
        with tempfile.TemporaryDirectory() as td:
            result = run_cross_validation(_mesh_cfg(td, **kw), dataset=gs, device=dev)
        _learned(f"mesh {name} engine", result)
        out[name] = result["test_accuracy_mean"]

    gs_folds = synthesize_tu_dataset("MUTAG", num_graphs=60, seed=0)
    folds = dict(batch_size=8, num_folds=10, cv_parallel="folds", layout="dense",
                 node_pad_multiple=32, edge_pad_multiple=512)
    with tempfile.TemporaryDirectory() as td:
        sharded = run_cross_validation(_mesh_cfg(td, mesh_shape=(n_devices, 1), **folds),
                                       dataset=gs_folds, device=dev)
    if len(sharded["test_accuracies"]) != 10:  # no pad fold may emit rows
        raise AssertionError(f"fold-sharded run: {sharded['test_accuracies']}")
    _learned("fold-sharded lockstep", sharded)
    out["folds"] = sharded["test_accuracies"]
    if rank == 0:  # one device, no collective: the comparison's other side
        with tempfile.TemporaryDirectory() as td:
            one = run_cross_validation(_mesh_cfg(td, **folds), dataset=gs_folds,
                                       device=dev)
        np.testing.assert_allclose(sharded["test_accuracies"], one["test_accuracies"],
                                   err_msg="fold-sharded lockstep diverged from one "
                                           "device")
    return out


def dryrun_rank(rank: int, n_devices: int, store: str, device: str) -> dict:
    """One rank of the dry run: joins the group of `n_devices` ranks through
    the FileStore `store` and runs `dryrun_legs` on `device` ("cpu", or
    "cuda" for a card per rank where there are enough, else shared)."""
    import datetime

    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
        backend, dev = "gloo", "cpu"
    else:
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError("CUDA is not available; pass device='cpu' (CLI: "
                               "--platform cpu) for the dry run on the CPU")
        backend = "nccl" if n_devices <= cards else "gloo"
        dev = f"cuda:{rank % cards}"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, n_devices), rank=rank,
                            world_size=n_devices, timeout=datetime.timedelta(seconds=600))
    try:
        return dryrun_legs(n_devices, dev)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The dry run over `n_devices` ranks (module docstring), each a process
    of its own; rank 0's accuracies. Raises with every rank's output when a
    rank fails or they outlast `DRYRUN_TIMEOUT`."""
    import time

    where = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    if where == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' (CLI: --platform "
                           "cpu) for the dry run on the CPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"rank{r}.json") for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dgcnn_tpu_torch.graft_entry", "--dryrun-rank", str(r),
             str(n_devices), os.path.join(td, "store"), where, outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=root)
            for r in range(n_devices)]
        deadline = time.monotonic() + DRYRUN_TIMEOUT
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the dry run's ranks outlasted {DRYRUN_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("dry run: a rank failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode})\n{t[-6000:]}"
                for r, (p, t) in enumerate(zip(procs, logs))))
        with open(outs[0]) as f:
            return json.load(f)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--dryrun-rank"]:  # one rank of `dryrun_multichip`
        rank, n, store, where, out = argv[1:6]
        res = dryrun_rank(int(rank), int(n), store, where)
        with open(out, "w") as f:
            json.dump(res, f)
        return 0
    p = argparse.ArgumentParser(description="run the single-device forward entry, or "
                                            "the multi-device dry run")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the GPU (raises when CUDA is absent); cpu = the "
                        "plain PyTorch path on the CPU")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="run dryrun_multichip(N) instead of the forward entry")
    args = p.parse_args(argv)
    if args.dryrun:
        res = dryrun_multichip(args.dryrun, "cpu" if args.platform == "cpu" else None)
        print(json.dumps({"dryrun": args.dryrun, "ok": True, **res}))
        return 0
    fn, fargs = entry("cpu" if args.platform == "cpu" else None)
    lp = fn(*fargs)
    print(json.dumps({"shape": list(lp.shape), "finite": bool(torch.isfinite(lp).all())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
