"""What decides `correct`: the program's set-up epochs against the plain
reference, from the same graphs, weights, shuffles and dropout seeds.

A "step" is one epoch: the call the window drives (`FusedRun.run_epochs`)
runs whole epochs, so the program's state is seen between epochs only.
DGCNN's sort-pooling orders nodes by a computed key, so two correct fp32
programs that round differently can rank a near-tied pair of nodes
differently; training then carries the difference on and amplifies it
from epoch to epoch. So `eval_gap` checks the program from its own state,
and the others follow the reference one epoch from the seed's weights:

  loss_gap    epoch 1's train and test loss (the mean of the batch means),
              program against the reference trained from the same weights,
              |program − reference| / |reference|, the larger of the two;
  grad_gap    Adam's first moment after epoch 1 (the gradients as the
              optimizer got them): |‖program‖ − ‖reference‖| / ‖reference‖
              over all weights;
  eval_gap    each set-up epoch's test loss against the reference's
              evaluation of the program's own weights after that epoch,
              the median over the three epochs (a near-tie ranked the
              other way in one evaluation moves that epoch alone);
  change_gap  the weights' change over epoch 1, measured as grad_gap;
  sq_gap      Adam's second moment after epoch 1, summed over all weights:
              (1 − b2) Σ_i b2^(n−i) ‖g_i‖², nearly the sum of the squared
              gradient norms of the epoch's steps, relative. A trajectory
              that parted from the reference late in the epoch moves it
              little; training on part of each batch, whose gradients are
              noisier, moves it in every fold.

`loss_gap` and `grad_gap` are the best-matching fold's: a sound program
matches the reference to round-off in every fold whose epoch ranked no
near-tie the other way (in lockstep most folds), while the control and
the faults move every fold; a fault confined to some folds shows in the
other three, which are the worst fold. A sequential cell compares fold
1's set-up epochs and, after the window, those of the further folds it
switched into (`drive.check_folds`). A cell compares the numbers its limits file names
(`limits/<cell>.json`). A leaf whose reference moment is under a
thousandth of the median leaf's moves by round-off alone under Adam and is
left out of both norms (by that rule, never by name)."""

from __future__ import annotations

import numpy as np
import torch

NAMES = ("loss_gap", "grad_gap", "eval_gap", "eval_mid", "change_gap", "change_best",
         "sq_best")


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _norm(tensors) -> float:
    return float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in tensors)))


def state_gaps(p0: dict, m1: dict, v1: dict, p1: dict, ref: dict) -> dict:
    """`grad_gap`, `change_gap` and `sq_gap` of one fold: the program's
    moments `m1`, `v1` and weights `p1` after epoch 1 against the
    reference's `follow` output `ref`, both from `p0`, and the leaves left
    out."""
    dev = ref["params"][next(iter(ref["params"]))].device
    ref_m = {n: float(t.double().norm()) for n, t in ref["m1"].items()}
    med = float(np.median(list(ref_m.values())))
    kept = [n for n, v in ref_m.items() if v >= 1e-3 * med]
    dp = {n: p1[n].to(dev) - p0[n].to(dev) for n in kept}
    dr = {n: ref["params"][n] - p0[n].to(dev) for n in kept}
    mp = {n: m1[n].to(dev) for n in kept}
    return {"grad_gap": rel(_norm(mp.values()), _norm(ref["m1"][n] for n in kept)),
            "change_gap": rel(_norm(dp.values()), _norm(dr.values())),
            "sq_gap": rel(sum(float(v1[n].double().sum()) for n in kept),
                          sum(float(ref["v1"][n].double().sum()) for n in kept)),
            "left_out": len(ref_m) - len(kept)}


def fold_numbers(rows, ref: dict) -> dict:
    """One fold's `loss` and `eval` readings: `rows` the program's [epochs,
    ≥2] rows (train loss, test loss, ...), `ref` the reference's epoch-1
    `train_loss` and `test_loss` and its `evals` of the program's weights
    after each epoch."""
    return {"loss": max(rel(rows[0][0], ref["train_loss"]), rel(rows[0][1], ref["test_loss"])),
            "eval": float(np.median([rel(rows[e][1], v) for e, v in enumerate(ref["evals"])]))}


def numbers(folds: list) -> dict:
    """The numbers from every checked fold's readings (`fold_numbers` and
    `state_gaps` together): each fold reading by the best fold, the worst
    or the median over the folds, as its name says."""
    return {"loss_gap": min(f["loss"] for f in folds),
            "grad_gap": min(f["grad_gap"] for f in folds),
            "eval_gap": max(f["eval"] for f in folds),
            "eval_mid": float(np.median([f["eval"] for f in folds])),
            "change_gap": max(f["change_gap"] for f in folds),
            "change_best": min(f["change_gap"] for f in folds),
            "sq_best": min(f["sq_gap"] for f in folds)}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell's limits name is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
