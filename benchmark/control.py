"""The readings the limits of `correct` are set from, on the chip at a
cell's own size; the benchmark's runs never run this.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--control 3]
        [--variants tf32,half,train_half,answer]

For every seed, the program's set-up epochs (and in a sequential cell
those of the further folds it switches into) against the reference: the
lower readings, `program`. For the first `--control` seeds, the reference put in the
program's place and computed with TF32 on (`tf32`, the nearest precision
below the configuration's float32 with TF32 off), with each planted
fault of the family's reference (`FAULTS`; DGCNN's: `half`, `train_half`,
`answer`), and with `stale_test` (a fold switch that keeps the first
checked fold's test graphs: in a sequential cell, every fold checked
after a switch evaluated on fold 1's test graphs), each against the fp32
reference: the upper readings. One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import check, drive, family, harness
from benchmark.inputs import make_inputs


def variants_of(cell: str) -> tuple:
    """The control and every fault the cell's family plants."""
    cfg, _ = harness.cell_files(cell)
    return ("tf32",) + tuple(family.of(cfg).reference.FAULTS) + ("stale_test",)


def against(p0: dict, other: dict, ref: dict) -> dict:
    """One fold's readings of `other` (the reference's with TF32 or a
    fault, in the program's place) against the reference's `ref`."""
    a, b = other["traj"], ref["traj"]
    return {"loss": max(check.rel(a["train_loss"][0], b["train_loss"][0]),
                        check.rel(a["test_loss"][0], b["test_loss"][0])),
            "eval": float(np.median([check.rel(x, y)
                                     for x, y in zip(other["evals"], ref["evals"])])),
            **check.state_gaps(p0, a["m1"], a["v1"], a["params"], b)}


def readings(cell: str, seed: int, control: bool, device, num_graphs: int = 0,
             variants=None) -> dict:
    cfg, traffic = harness.cell_files(cell)
    variants = variants_of(cell) if variants is None else variants
    inp = make_inputs(cfg, seed, device, num_graphs)
    prog = drive.Program(inp, traffic, device)
    sus = [drive.set_up(prog)] + drive.check_folds(prog, harness.CHECK_FOLDS)
    rows_for = harness.rows_maps(prog, inp, sus)
    prog.close()
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = harness.reference_readings(inp, sus, rows_for, device)
    rows = harness.program_rows(sus)
    out = {"seed": seed, "program": harness.compared(sus, [base]),
           "reference_s": time.perf_counter() - t0,
           "program_folds": {key: {**r, **check.fold_numbers(rows[key], r)}
                             for key, r in base.items()}}
    if not control:
        return out
    reference = family.of(cfg).reference
    g = reference.Graphs(inp.graphs, device)
    model, train = cfg["model"], cfg["train"]
    first_test = inp.folds[sus[0]["folds"][0]][1]
    for i, f in harness.checked(sus):
        def read(test=inp.folds[f][1], **kw):
            traj = reference.follow(g, model, train, inp.params[f], inp.epoch_ids(f, 1),
                                    test, inp.dropout_seeds[f], rows_for[i, f], **kw)
            return {"traj": traj, "evals": [reference.evaluate(g, model, p[f], test,
                                                               train["batch_size"], **kw)
                                            for p in sus[i]["p"]]}

        ref = read()
        for name in variants:
            if name == "stale_test":
                other = read(first_test) if i else ref
            else:
                other = read(**({"tf32": True} if name == "tf32" else {"fault": name}))
            out.setdefault(name + "_folds", {})[f"{i}:{f}"] = against(
                sus[i]["p0"][f], other, ref)
    for name in variants:
        out[name] = check.numbers(list(out[name + "_folds"].values()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3,
                   help="seeds (the first ones) that also read the control and faults")
    p.add_argument("--variants", default="",
                   help="which of the control and the faults to read (default: all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, s, i < args.control, "cuda",
                                  variants=args.variants.split(",") if args.variants
                                  else None)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
