"""Does one batch give the same bits run after run, on the card and on
the CPU?

    python -m dgcnn_tpu_torch.tools.probe_repeat [--runs 4] [--reps 3]
        [--devices cuda,cpu]

The batch is chip_smoke.py phase 4a's card-vs-CPU lockstep batch:
synthetic NCI1, each of the ten folds' first 50 graphs of its epoch-1
shuffle stacked on the slot axis (560 slots, T=88), through a
`DGCNNFoldsNet` whose fold f has `init_params` from seed 3 + f; the
log-probs and every parameter gradient of the summed per-fold losses.
Each device runs in `--runs` fresh processes, each computing the batch
`--reps` times (each behind an allocation of another size), with fp32
products only (`train/cv.py fp32_only`), the CPU side pinned as
chip_smoke.py pins its own (tools/cpu_pin.py: `THREADS` torch threads
and `MKL_CBWR`, set before torch loads in each child). Prints one JSON line: per device, how many
distinct bit patterns the processes and the repetitions inside one
process gave; for every pair of a distinct card pattern and a distinct
CPU pattern, the worst relative error (max abs error over the tensor's
largest value) and the tensors beyond rtol 1e-4 / atol 1e-6, the
card-vs-CPU check's tolerance; and, on the card, its name and power
limit; and each device's CPU side as its children ran it
(`cpu_pin.describe`). The card is needed only for `cuda`."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from dgcnn_tpu_torch.tools import cpu_pin

FOLDS, SLOTS, BATCH, SEED = 10, 56, 50, 324


def lockstep_batch():
    """The host batch of chip_smoke.py `lockstep_parts` + `stack_batches`."""
    import dataclasses

    from dgcnn_tpu_torch.batching.dense import DenseGraphBatch, dense_tile, pack_dense_batch
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset

    gs = synthesize_tu_dataset("NCI1")
    parts = []
    for f, (tr, _) in enumerate(get_folds(gs.y, "", FOLDS, SEED, data_type="NCI1"),
                                start=1):
        perm = np.random.default_rng(np.random.SeedSequence([SEED, f])).permutation(len(tr))
        parts.append(pack_dense_batch(gs, np.asarray(tr)[perm][:BATCH], dense_tile(gs),
                                      SLOTS))
    batch = DenseGraphBatch(**{
        fld.name: (np.asarray(sum(int(p.num_graphs) for p in parts), np.int32)
                   if fld.name == "num_graphs" else
                   np.concatenate([getattr(p, fld.name) for p in parts]))
        for fld in dataclasses.fields(DenseGraphBatch)})
    return gs, batch


def outputs(gs, host, device):
    """(name, tensor on the CPU) of the log-probs and every gradient."""
    from dgcnn_tpu_torch.batching.dense import batch_to_device
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNFoldsNet, init_params, stack_params
    from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    net = DGCNNFoldsNet(model, stack_params([
        init_params(torch.Generator().manual_seed(3 + f), model, device)
        for f in range(FOLDS)]))
    b = batch_to_device(host, device)
    lp = net(b)
    loss, _ = nll_loss_and_correct(lp, b.y.view(FOLDS, -1), b.graph_mask.view(FOLDS, -1))
    loss.sum().backward()
    return [("log_probs", lp.detach().cpu())] + [(n, p.grad.cpu())
                                                 for n, p in net.named_parameters()]


def digest(outs) -> str:
    h = hashlib.sha256()
    for _, t in outs:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def child(device: str, reps: int, path: str) -> None:
    from dgcnn_tpu_torch.tools.cpu_pin import describe
    from dgcnn_tpu_torch.train.cv import fp32_only

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    fp32_only()
    if device == "cuda":
        from dgcnn_tpu_torch.kernels import _build

        _build.build_all()
    gs, host = lockstep_batch()
    runs = []
    for r in range(reps):  # each repetition behind another allocation
        pad = torch.empty(1 + r * 1_000_003, device=device)
        runs.append(outputs(gs, host, device))
        del pad
    torch.save({"runs": runs, "cpu_side": describe()}, path)


def worst(card, cpu):
    """(worst rel, its tensor, the tensors beyond the check's tolerance)."""
    rows = []
    for (name, a), (_, c) in zip(card, cpu):
        err = (a.double() - c.double()).abs().max().item()
        scale = c.double().abs().max().item()
        rows.append((err / max(scale, 1e-6), name, err <= 1e-6 + 1e-4 * scale))
    rel, name, _ = max(rows)
    return rel, name, [n for _, n, ok in rows if not ok]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--child", nargs=3, metavar=("DEVICE", "REPS", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child[0], int(args.child[1]), args.child[2])
        return 0
    devices = args.devices.split(",")
    if "cuda" in devices and not torch.cuda.is_available():
        print(json.dumps({"error": "CUDA is not available; pass --devices cpu"}))
        return 1
    report, patterns = {}, {}
    env = cpu_pin.pin_environ(dict(os.environ))
    with tempfile.TemporaryDirectory() as tmp:
        for dev in devices:
            runs, sides = [], set()
            for r in range(args.runs):
                path = os.path.join(tmp, f"{dev}_{r}.pt")
                subprocess.run([sys.executable, "-m", __spec__.name, "--child", dev,
                                str(args.reps), path], check=True, env=env)
                saved = torch.load(path)
                runs.append(saved["runs"])
                sides.add(saved["cpu_side"])
            seen = {}
            for outs in (o for run in runs for o in run):
                seen.setdefault(digest(outs), outs)
            patterns[dev] = seen
            report[dev] = {
                "patterns": [[digest(o) for o in run] for run in runs],
                "distinct_across_processes": len({digest(run[0]) for run in runs}),
                "distinct_within_a_process": max(len({digest(o) for o in run})
                                                 for run in runs),
                "cpu_side": sorted(sides),
            }
    if "cuda" in devices and "cpu" in devices:
        report["card_vs_cpu"] = [
            {"card": kc, "cpu": kp, **dict(zip(("worst_rel", "at", "beyond"),
                                              worst(oc, op)))}
            for kc, oc in patterns["cuda"].items() for kp, op in patterns["cpu"].items()]
    if "cuda" in devices:
        from dgcnn_tpu_torch.utils.profiling import card_line

        report["card"] = card_line()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
