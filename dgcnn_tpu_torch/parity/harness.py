"""Golden-activation parity harness — the port of
dgcnn_tpu/parity/harness.py (`dump_activations` :22, `compare_dumps` :48,
`_flat_save` :68, `_load_acts` :78, the `dump`/`compare` CLI :83).

Dumps the per-stage activations (gcn1..4, sort_pool, log_probs) of one
(weights, batch) pair, real rows only, and compares two dumps allclose. A
dump holds `act_<stage>` arrays and the weights as `w_<key>` in the
reference PyG model's `state_dict` layout (parity/convert.py
`params_to_torch_state`), the keys and shapes the reference's harness and
parity/pyg_dump.py write, so a dump from either package compares with the
other's:

    python -m dgcnn_tpu_torch.parity.harness dump --data_type MUTAG \\
        --synthetic --out port.npz [--weights ref.npz] [--platform cpu]
    python -m dgcnn_tpu_torch.parity.harness compare port.npz ref.npz

`dump` packs the dataset's first `--num_graphs` graphs into one COO batch
of `compute_bucket(gs, n)`, as the reference's does, and runs `apply` on
the card (`--platform cpu`: the plain path on the CPU). Its weights come
from `init_params` seeded with `--seed`, or from the `w_*` arrays of
`--weights` (any dump, either package's; the reference's dump seeds a JAX
key instead): a port dump of a reference dump's weights is the
like-for-like comparison.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from dgcnn_tpu_torch.parity.convert import (
    params_from_jax, params_to_torch_state, state_to_params, torch_state_to_params,
)


def _params_on(params, device):
    """A reference-shaped tree (NumPy or tensor leaves) → the nested dict
    of fp32 tensors on `device` that `apply` takes."""
    return state_to_params({k: v.to(device) for k, v in params_from_jax(params).items()})


def _batch_on(batch, device):
    from dgcnn_tpu_torch.batching import dense, packer

    if isinstance(batch, dense.DenseGraphBatch):
        return dense.batch_to_device(batch, device)
    return packer.batch_to_device(batch, device)


def dump_activations(params, model, batch, device=None) -> Dict[str, np.ndarray]:
    """Run the port's forward (`apply`) on a host-packed batch, COO or
    dense, and return the per-stage activations restricted to real rows
    (node and graph padding stripped, so dumps are layout-independent).
    `params` is a reference-shaped tree with NumPy or tensor leaves;
    `device` is the card unless the caller passes "cpu"."""
    from dgcnn_tpu_torch.models.dgcnn import apply
    from dgcnn_tpu_torch.train.cv import fp32_only, resolve_device

    dev = resolve_device(device)
    fp32_only()
    with torch.no_grad():
        _, acts = apply(_params_on(params, dev), model, _batch_on(batch, dev),
                        return_activations=True)
    node_mask = np.asarray(batch.node_mask) > 0
    n_real = int(node_mask.sum())
    b_real = int(np.asarray(batch.num_graphs))
    out = {}
    for i in range(len(model.hidden_dims)):
        a = acts[f"gcn{i + 1}"].float().cpu().numpy()
        # dense layout: [B, n, C] → the real rows concatenated; coo: [N, C]
        out[f"gcn{i + 1}"] = a[node_mask] if a.ndim == 3 else a[:n_real]
    out["sort_pool"] = acts["sort_pool"].float().cpu().numpy()[:b_real]
    out["log_probs"] = acts["log_probs"].cpu().numpy()[:b_real]
    return out


def compare_dumps(
    a: Dict[str, np.ndarray],
    b: Dict[str, np.ndarray],
    rtol: float = 1e-4,
    atol: float = 1e-5,
) -> Dict[str, float]:
    """Max abs deviation per stage; raises AssertionError on mismatch."""
    report = {}
    for key in sorted(set(a) & set(b)):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.shape != y.shape:
            raise AssertionError(f"{key}: shape {x.shape} vs {y.shape}")
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=key)
        report[key] = float(np.max(np.abs(x - y))) if x.size else 0.0
    missing = set(a) ^ set(b)
    if missing:
        raise AssertionError(f"stages only in one dump: {sorted(missing)}")
    return report


def _flat_save(path: str, params, model, dump: Dict[str, np.ndarray]) -> None:
    arrays = {f"act_{k}": v for k, v in dump.items()}
    arrays.update({f"w_{k}": v for k, v in params_to_torch_state(params, model).items()})
    np.savez(path, **arrays)


def _load_acts(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k[4:]: z[k] for k in z.files if k.startswith("act_")}


def _load_weights(path: str, model):
    """The `w_*` arrays of a dump → a reference-shaped tree (NumPy)."""
    with np.load(path) as z:
        state = {k[2:]: z[k] for k in z.files if k.startswith("w_")}
    return torch_state_to_params(state, model)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="activation parity harness")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump")
    d.add_argument("--data_type", default="MUTAG")
    d.add_argument("--out", required=True)
    d.add_argument("--num_graphs", type=int, default=50)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--synthetic", action="store_true")
    d.add_argument("--data_root", default="data")
    d.add_argument("--weights", default=None, metavar="NPZ",
                   help="take the weights from this dump's w_* arrays "
                        "instead of seeding them")
    d.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto = the GPU (raises when CUDA is absent); "
                        "cpu = the plain PyTorch path on the CPU")

    c = sub.add_parser("compare")
    c.add_argument("dump_a")
    c.add_argument("dump_b")
    c.add_argument("--rtol", type=float, default=1e-4)
    c.add_argument("--atol", type=float, default=1e-5)

    args = p.parse_args(argv)
    if args.cmd == "dump":
        from dgcnn_tpu_torch.batching.packer import compute_bucket, pack_batch
        from dgcnn_tpu_torch.data.datasets import load_dataset
        from dgcnn_tpu_torch.models.dgcnn import DGCNN, init_params

        gs, meta = load_dataset(args.data_type, root=args.data_root,
                                allow_synthetic=args.synthetic)
        model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
        if args.weights:
            params = _load_weights(args.weights, model)
        else:
            params = init_params(torch.Generator().manual_seed(args.seed), model)
        n = min(args.num_graphs, gs.num_graphs)
        batch = pack_batch(gs, np.arange(n), compute_bucket(gs, n))
        dump = dump_activations(params, model, batch,
                                "cpu" if args.platform == "cpu" else None)
        _flat_save(args.out, params, model, dump)
        print(f"wrote {args.out} (source={meta.source}, graphs={n})")
    else:
        report = compare_dumps(_load_acts(args.dump_a), _load_acts(args.dump_b),
                               rtol=args.rtol, atol=args.atol)
        for k, v in report.items():
            print(f"{k}: max_abs_dev={v:.3e}")
        print("PARITY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
