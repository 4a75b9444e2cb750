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

The multi-device dry run (`dryrun_multichip` of `__graft_entry__.py`)
is not here: it needs the halo engine and fold-sharded lockstep
(ROADMAP Queue 1 item 12b).

    python -m dgcnn_tpu_torch.graft_entry [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="run the single-device forward entry")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the GPU (raises when CUDA is absent); cpu = the "
                        "plain PyTorch path on the CPU")
    args = p.parse_args(argv)
    fn, fargs = entry("cpu" if args.platform == "cpu" else None)
    lp = fn(*fargs)
    print(json.dumps({"shape": list(lp.shape), "finite": bool(torch.isfinite(lp).all())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
