"""Faults planted under the harness for its tests: each breaks the
program's timed path in one way, on the CPU, at a small size."""

import contextlib
import time

import torch

N_GRAPHS = 200


@contextlib.contextmanager
def planted(fault: str):
    """`unchanged`: every optimizer step returns its state unchanged;
    `half`: half of each batch left out, the loss the mean over the rest;
    `train_half`: the same in training only, the evaluation untouched;
    `answer`: the first graph's log-probs altered where they are made;
    `exchange`: the rows of other ranks' folds never reach this rank;
    `stale_test`: a fold switch keeps the first fold's test graphs."""
    from dgcnn_tpu_torch.models import dgcnn
    from dgcnn_tpu_torch.train import cv, loop

    from benchmark import drive

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "unchanged":
        patch(loop.FoldAdam, "step", lambda self, real: None)
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault in ("half", "train_half"):
        nll = loop.nll_loss_and_correct

        def half(log_probs, y, graph_mask):
            if fault == "train_half" and not torch.is_grad_enabled():
                return nll(log_probs, y, graph_mask)  # an evaluation
            n = graph_mask.sum(-1, keepdim=True)
            keep = (torch.cumsum(graph_mask, -1) <= torch.ceil(n / 2)).to(graph_mask.dtype)
            return nll(log_probs, y, graph_mask * keep)

        patch(loop, "nll_loss_and_correct", half)
    elif fault == "answer":
        head = dgcnn._pooled_to_log_probs

        def altered(*args, **kw):
            lp = head(*args, **kw)
            first = lp[..., :1, :].roll(1, dims=-1)
            return torch.cat([first, lp[..., 1:, :]], dim=-2)

        patch(dgcnn, "_pooled_to_log_probs", altered)
    elif fault == "exchange":
        def left_out(local, like, num_folds, grid):
            out = torch.zeros((num_folds,) + tuple(like.shape[1:]), dtype=like.dtype)
            own = drive.fold_block(num_folds, grid)
            if local is not None:
                out[own[0]: own[0] + len(own)] = local.to("cpu")
            return out

        patch(drive, "gather_folds", left_out)
    elif fault == "stale_test":
        for engine in (cv.DenseEngine, cv.MultiDenseEngine, cv.BlockSparseEngine,
                       cv.DeviceCooEngine, cv.CooEngine):
            def begin(self, train_idx, test_idx, _begin=engine.begin_fold):
                self.__dict__.setdefault("first_test", test_idx)
                _begin(self, train_idx, self.first_test)

            patch(engine, "begin_fold", begin)
    elif fault != "none":
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


# at N_GRAPHS the program would train COLLAB's folds in lockstep on the
# dense layout; these keep the cell's own path, folds one after another
# on the multi-tile layout
TRAFFIC = {"collab-folds": {"cv_parallel": "sequential", "layout": "multi",
                            "mesh": [1, 1]}}
# D&D's graphs on the CPU: a shorter protocol, so that the window's chunks
# and a sequential fold's epochs stay few (the set-up epochs checked are
# the same three one-epoch chunks)
TRAIN = {"dgcnn-dd": {"num_epochs": 6, "max_fused_epochs": 2}}
# and fewer of them: the reference pads a batch to its largest graph, and
# D&D's largest at N_GRAPHS (2,685 nodes) takes GBs of the CPU's memory
GRAPHS = {"dgcnn-dd": 120}


@contextlib.contextmanager
def traffic_of(cell: str, traffic=None):
    """The cell's files as the harness loads them, with `traffic` (else
    `TRAFFIC[cell]`, where there is one) in place of the cell's traffic
    and its configuration's protocol cut by `TRAIN`."""
    from benchmark import harness

    load, load_config = harness.load_json, harness.load_config
    w = harness.workload(cell)
    traffic = traffic or TRAFFIC.get(cell)

    def load_json(*parts):
        if traffic and parts == ("traffic", w["traffic"] + ".json"):
            return dict(traffic)
        return load(*parts)

    def cut(name):
        cfg = load_config(name)
        return {**cfg, "train": {**cfg["train"], **TRAIN.get(name, {})}}

    harness.load_json, harness.load_config = load_json, cut
    try:
        yield
    finally:
        harness.load_json, harness.load_config = load, load_config


def run(cell: str, fault: str, seed: int = 31, rank: int = 0, world: int = 1,
        store: str = "", num_graphs=None, traffic=None) -> dict:
    """One run at `num_graphs` graphs (0: the cell's own dataset; None:
    `GRAPHS` of its configuration, else N_GRAPHS), on `traffic` where
    given (`traffic_of`)."""
    from benchmark import harness

    if num_graphs is None:
        num_graphs = GRAPHS.get(harness.workload(cell)["config"], N_GRAPHS)
    with planted(fault), traffic_of(cell, traffic):
        return harness.run_rank(cell, seed, 0.2, False, "cpu", time.time(), rank, world,
                                store, num_graphs=num_graphs)


def rank_main(cell, fault, rank, world, store, queue):
    """One rank of a several-rank run in its own process (spawned)."""
    torch.set_num_threads(1)
    out = run(cell, fault, rank=rank, world=world, store=store)
    if rank == 0:
        queue.put(out)
