"""Inference: load a trained fold checkpoint and classify graphs — the
port of dgcnn_tpu/infer.py (`predict_dataset` :29, `load_fold_params`
:66, `main`).

Batch prediction over a GraphSet on the device-resident COO layout,
returning per-graph log-probabilities and labels in dataset order. On
the card the forward of one batch (`gather_coo_batch` → `apply_coo`,
deterministic, the row-parallel CSR SpMM kernel under `spmm_impl="xla"`)
is captured once as a CUDA graph and replayed per batch from a static
index row (train/loop.py `FusedRun`), the counterpart of the reference's
single jitted scan: one host-to-device copy of the order matrix, one
device-to-host copy of the log-probs, no host read in between.

    python -m dgcnn_tpu_torch.infer --data_type MUTAG --checkpoint epochs/MUTAG_1 \\
        [--out predictions.csv] [--synthetic] [--platform cpu]
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.batching.dense import order_matrix
from dgcnn_tpu_torch.batching.device_coo import (
    build_device_graphset, device_graphset_to, gather_coo_batch,
)
from dgcnn_tpu_torch.batching.packer import compute_bucket
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN, DGCNNNet, Params, _map, apply_coo, init_params,
)
from dgcnn_tpu_torch.parity.convert import state_to_params
from dgcnn_tpu_torch.train.cv import fp32_only, resolve_device
from dgcnn_tpu_torch.train.loop import FusedRun, _arrival_counters
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint


def make_infer_run(params: Params, model: DGCNN, dataset: GraphSet,
                   batch_size: int = 50, spmm_impl: str = "xla", device=None,
                   graphs: bool = True) -> Tuple[FusedRun, np.ndarray]:
    """The runner of one batch's forward over `dataset` on `device`
    (default `cuda`, raising when it is absent; `"cpu"` runs the plain
    PyTorch path) and the order matrix [steps, slots] it runs: batches of
    `batch_size` graphs in dataset order in the worst-case bucket's slots
    (`compute_bucket`), as the reference's. The graphset is shipped once.
    Each "epoch" of the runner is one batch: it copies the batch's index
    row into its static `order`, runs the body (on the card: a warm-up,
    then a capture, then one replay a batch) and gathers the log-probs
    [slots, C]. `spmm_impl` is "xla" (the row-parallel kernel) or "onehot"
    (the edge-block kernel); `graphs=False` runs every batch eagerly on
    the card, for comparison only."""
    if spmm_impl not in ("xla", "onehot"):
        raise ValueError(f"spmm_impl {spmm_impl!r}: inference assembles batches on "
                         f"the device, which carry no block-COO structures; use "
                         f"'xla' or 'onehot'")
    device = resolve_device(device)
    fp32_only()
    params = _map(params, lambda t: t.to(device))
    dev = device_graphset_to(build_device_graphset(dataset), device)
    bucket = compute_bucket(dataset, batch_size)
    order2d = order_matrix(np.arange(dataset.num_graphs, dtype=np.int32), batch_size,
                           bucket.num_graphs)
    row = torch.full((bucket.num_graphs,), -1, dtype=torch.int32, device=device)
    out = torch.zeros((bucket.num_graphs, model.num_classes), dtype=torch.float32,
                      device=device)
    held = _arrival_counters(device, nodes=bucket.num_nodes if spmm_impl == "onehot"
                             else 0)

    def body(_held=held):
        with torch.no_grad():
            lp = apply_coo(params, model, gather_coo_batch(dev, row, bucket),
                           deterministic=True, spmm_impl=spmm_impl)
            out.copy_(lp)

    return FusedRun(body, row, out, np.array(True), [], graphs), order2d


def predict_dataset(params: Params, model: DGCNN, dataset: GraphSet,
                    batch_size: int = 50, spmm_impl: str = "xla", device=None,
                    graphs: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Classify every graph (`make_infer_run`'s runner over every batch:
    one host-to-device copy of the order matrix, one device-to-host copy
    of the log-probs). Returns (log_probs [G, C] float32, labels [G]) in
    dataset order."""
    runner, order2d = make_infer_run(params, model, dataset, batch_size, spmm_impl,
                                     device, graphs)
    lps = runner.run_epochs(order2d)  # [steps, slots, C], float64 of the fp32 values
    flat_order = order2d.reshape(-1)
    keep = flat_order >= 0
    log_probs = np.empty((dataset.num_graphs, model.num_classes), np.float32)
    log_probs[flat_order[keep]] = lps.reshape(-1, model.num_classes)[keep]
    return log_probs, log_probs.argmax(axis=-1)


def load_fold_params(checkpoint: str, model: DGCNN) -> Params:
    """The parameters (CPU tensors, the reference-shaped nested dict) of a
    fold bundle (`checkpoint` without its `.npz`): the sequential or the
    lockstep driver's final bundle (params and an Adam state, per-leaf or
    `--opt_flatten`'s vector-shaped one) or a raw params bundle (the
    state dict at its top level). Raises ValueError when its parameters
    are not `model`'s."""
    bundle = load_checkpoint(checkpoint)
    state = bundle["params"] if "params" in bundle else bundle
    want = DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model)).state_dict()
    if set(state) != set(want) or any(np.shape(state[k]) != tuple(want[k].shape)
                                      for k in want):
        raise ValueError(
            f"{checkpoint}: its parameters {sorted((k, np.shape(v)) for k, v in state.items())} "
            f"are not the model's {sorted((k, tuple(v.shape)) for k, v in want.items())}")
    return state_to_params({k: torch.from_numpy(np.array(v, dtype=np.float32))
                            for k, v in state.items()})


def main(argv=None):
    from dgcnn_tpu_torch.config import DATASETS
    from dgcnn_tpu_torch.data.datasets import load_dataset

    p = argparse.ArgumentParser(description="DGCNN batch inference")
    p.add_argument("--data_type", required=True, choices=list(DATASETS))
    p.add_argument("--checkpoint", required=True,
                   help="fold checkpoint path WITHOUT .npz suffix, e.g. "
                        "epochs/MUTAG_1")
    p.add_argument("--data_root", default="data")
    p.add_argument("--batch_size", default=50, type=int)
    p.add_argument("--out", default=None, help="CSV of per-graph predictions")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu", "probe"],
                   help="auto = the GPU (raises when CUDA is absent); cpu = the "
                        "plain PyTorch path on the CPU")
    args = p.parse_args(argv)
    if args.platform == "probe":
        raise NotImplementedError("not ported yet: --platform probe, a TPU transport "
                                  "health check")
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")

    gs, meta = load_dataset(args.data_type, root=args.data_root,
                            allow_synthetic=args.synthetic)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    params = load_fold_params(args.checkpoint, model)
    log_probs, labels = predict_dataset(params, model, gs, args.batch_size,
                                        device=device)

    acc = float((labels == gs.y).mean()) * 100.0
    print(f"predicted {gs.num_graphs} graphs (source={meta.source}); "
          f"accuracy vs dataset labels: {acc:.2f}%")
    if args.out:
        conf = np.exp(log_probs.max(axis=-1))
        with open(args.out, "w") as f:
            f.write("graph,predicted_label,confidence,true_label\n")
            for i, (lab, c, y) in enumerate(zip(labels, conf, gs.y)):
                f.write(f"{i},{lab},{c:.4f},{y}\n")
        print(f"wrote {args.out}")
    return labels


if __name__ == "__main__":
    main()
