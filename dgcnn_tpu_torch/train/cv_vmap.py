"""Fold-lockstep cross-validation — the port of dgcnn_tpu/train/cv_vmap.py
(`fold_shard_devices` :328, `_stacked_orders` :348 and `run_cv_folds_vmap` :368 with its block
branch :444-505, multi-tile branch :505-597 and dense branch :598-620;
the in-flight bundle and resume :653-712; the chunk loop :714-790).

All K folds train at once, on the dense, block-sparse or multi-tile
layout, over the layout's engine (train/cv.py), which holds the dataset
on the device and the run's runner. Each step takes every fold's batch:
the dense layout stacks them on one batch's slot axis (F × slots slots,
fold f's in the f-th run of `slots`) and runs the trunk kernel once over
all of them with K = F weight sets (`apply_dense_folds`); the block
layout packs every fold's work items into one merged stream that each
propagation walks in one kernel call (`apply_block_folds`); the
multi-tile layout runs the trunk once a tile class on the class's
F × S_c slots (`apply_multi_dense_folds`). The per-fold protocol is the
sequential driver's (train/cv.py `run_fold`):

  * fold f keeps the sequential driver's streams: the shuffle
    `default_rng(SeedSequence([seed, f]))`, init from `_stream_seed(seed,
    f, 1)`, dropout from `_stream_seed(seed, f, 2)`; its dropout masks are
    the sequential driver's bits;
  * a fold with fewer train or test batches than the longest fold sees
    all-(−1) rows on the steps past its own: it draws no dropout, takes
    no Adam step and adds nothing to its epoch row (nor items to the
    block layout's merged stream), so it performs exactly its own
    updates;
  * per-fold rows equal the sequential driver's within float tolerance
    (batched products sum in another order; tests/test_torch_lockstep.py,
    tests/test_torch_block_lockstep.py, tests/test_torch_multi_lockstep.py).

Epochs run in chunks of k ≤ `max_fused_epochs`, cut as the reference's
chunk loop cuts them (:714-760, at the checkpoint cadence too;
train/cv.py `chunk_epochs`): the k epochs' orders are drawn from each
fold's shuffle stream and run by the fused runner of the chunk's budget
(train/loop.py `make_dense_lockstep_run`, `make_block_lockstep_run`,
`make_multi_lockstep_run`: on the card one CUDA-graph replay an epoch
after the runner's first), and their rows come back in one transfer. The
dense runner serves the whole run; the block layout's budgets (nb per
fold, W per step over all folds: `block_fold_extents` over the chunk's
orders and the test order) and the multi-tile layout's slot tuple grow
only, as the sequential engines' do, and a grown one gets a new runner
over the same weights and optimizer (the engine's `RunnerSlot`, keyed by
the budget alone).

Artifacts are the sequential driver's (per-fold CSVs, `epochs/` bundles
in its format, the event log); the CSVs and bundles are written at run
end, and the `epoch` events come epoch by epoch, fold by fold, each with
`folds_in_lockstep`, `chunk_epochs` = k and the chunk's seconds over k.
Every `checkpoint_every` epochs the run writes one stacked in-flight
bundle, `epochs/<DS>_lockstep_inflight` (`net_f`'s parameters,
`FoldAdam`'s moments and step counts, every fold's dropout generator
state, the epoch, the [F, n] metric rows and the engine's grow-only
floors); under `checkpoint_resume` the run loads it in place, replays
every fold's shuffle stream and continues.

Over a (D, 1) process grid the folds are sharded (the reference's
`fold_shard_devices` :328 and :368-420): each rank trains its contiguous
block of the padded fold axis (`fold_block`) with the runners above, and
the rows and states reach rank 0 between chunks (`gather_folds`); see
`run_cv_folds_lockstep`.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.batching.dense import order_matrix
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNFoldsNet, init_params, stack_params
from dgcnn_tpu_torch.parallel.mesh import broadcast_from
from dgcnn_tpu_torch.parity.convert import fold_state
from dgcnn_tpu_torch.train.cv import (
    BlockSparseEngine, MultiDenseEngine, _stream_seed, checkpoint_due,
    chunk_epochs, engine_floors, fold_bundle, fold_csv, fp32_only, restore_floors,
    resumed_epoch,
)
from dgcnn_tpu_torch.train.loop import (
    FoldAdam, FusedRun, fold_adam_state, make_block_lockstep_run, make_dense_lockstep_run,
    make_multi_lockstep_run,
)
from dgcnn_tpu_torch.train.metrics import EventLog, FoldMetrics
from dgcnn_tpu_torch.utils.checkpoint import (
    checkpoint_exists, load_checkpoint, load_into, remove_checkpoint, save_checkpoint,
)


def stack_folds(mats: List[np.ndarray], steps: int) -> np.ndarray:
    """[steps, F, w]: the folds' order matrices [steps_f, w] side by side,
    each −1-row padded up to the lockstep step count."""
    return np.stack([np.concatenate([m, np.full((steps - len(m), m.shape[1]), -1,
                                                np.int32)]) for m in mats], axis=1)


def stacked_orders(idx_f: List[np.ndarray], batch_size: int, slots: int,
                   steps: int) -> np.ndarray:
    """[steps, F, slots]: each fold's order matrix of `idx_f[f]` (in that
    order), −1-row padded up to the lockstep step count."""
    return stack_folds([order_matrix(idx, batch_size, slots) for idx in idx_f], steps)


def fold_pattern(n_f: List[int], batch_size: int, steps: int) -> np.ndarray:
    """[steps, F] bool: whether fold f holds a real graph at step s of
    `stacked_orders` — in every epoch, since each fold's batches come
    first and its padding rows after them, so the pattern follows from
    the fold sizes alone."""
    own = np.array([-(-n // batch_size) for n in n_f])
    return np.arange(steps)[:, None] < own[None, :]


def lockstep_chunk(engine, net_f: DGCNNFoldsNet, adam_f: FoldAdam, dropout_gens,
                   ids_k: List[List[np.ndarray]], test_ids: List[np.ndarray]
                   ) -> Tuple[FusedRun, np.ndarray]:
    """The runner and the host orders [k, steps, F, ·] of one chunk of
    lockstep epochs on `engine`'s layout: `ids_k[j][f]` is fold f's
    training graphs in epoch j's order, `test_ids[f]` its test graphs. The
    dense runner is built once; the block layout's runner is keyed by the
    chunk's grow-only budgets (`budget_for(..., folds=True)`), the
    multi-tile layout's by its grow-only slot tuple (`slots_for` over
    every fold's epochs and test graphs), and `engine.runners` drops a
    runner whose key grew."""
    bs = engine.cfg.batch_size
    steps = max(-(-len(ids) // bs) for ids in ids_k[0])
    t_steps = max(-(-len(ids) // bs) for ids in test_ids)
    pattern = fold_pattern([len(ids) for ids in ids_k[0]], bs, steps)
    args = (net_f, adam_f)
    if isinstance(engine, MultiDenseEngine):
        slots = engine.slots_for(*(ids for ids_f in ids_k for ids in ids_f), *test_ids)

        def stacked(ids_f, n):
            return stack_folds([engine.epoch_order(ids, slots) for ids in ids_f], n)

        orders = np.stack([stacked(ids_f, steps) for ids_f in ids_k])
        return engine.runners.get(slots, lambda: make_multi_lockstep_run(
            *args, engine.classes, slots, stacked(test_ids, t_steps), pattern,
            dropout_gens, engine.graphs)), orders
    orders = np.stack([stacked_orders(ids_f, bs, engine.slots, steps) for ids_f in ids_k])
    test = stacked_orders(test_ids, bs, engine.slots, t_steps)
    if isinstance(engine, BlockSparseEngine):
        nb, w = engine.budget_for(orders, test, folds=True)
        return engine.runners.get((nb, w), lambda: make_block_lockstep_run(
            *args, engine.dev, test, nb, w, pattern, dropout_gens, engine.block_impl,
            engine.graphs)), orders
    return engine.runners.get("dense", lambda: make_dense_lockstep_run(
        *args, engine.data, test, pattern, dropout_gens, engine.graphs)), orders


def fold_block(num_folds: int, grid=None) -> List[int]:
    """The 0-based global ids of the folds this rank trains. On a (D, 1)
    grid the fold axis is padded as the reference pads it, to F = ⌈K/D⌉·D,
    and cut into D contiguous blocks of F/D: rank d trains its block's REAL
    folds (none when its block holds only pad folds: K=10, D=8 leaves
    ranks 5-7 empty). Without a grid, all K."""
    if grid is None:
        return list(range(num_folds))
    per = -(-num_folds // grid.n_data)
    return list(range(grid.d * per, min((grid.d + 1) * per, num_folds)))


def gather_folds(local, like: torch.Tensor, num_folds: int, grid) -> torch.Tensor:
    """[K, ...] on every rank of a (D, 1) grid: each rank's `local` [its
    folds, ...] (None on a rank with none), shaped per fold as `like`
    [1, ...], reaches every rank by a broadcast over the data group from
    its owner, one owner after another (the data rank d is the global
    rank d on a (D, 1) grid)."""
    per = -(-num_folds // grid.n_data)
    out = []
    for r in range(grid.n_data):
        buf = torch.zeros((per,) + tuple(like.shape[1:]), dtype=like.dtype,
                          device=grid.device)
        if r == grid.d and local is not None:
            buf[: len(local)] = local
        out.append(broadcast_from(buf, r, grid.data_group))
    return torch.cat(out)[:num_folds]


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def fold_trees(net_f: DGCNNFoldsNet, adam_f: FoldAdam, gens) -> dict:
    """The run's fold-stacked state, every leaf [F, ...]: the parameters,
    Adam's step counts and moments as runs (`FoldAdam.run_tensors`) and
    the dropout generators' states."""
    return {"params_f": dict(net_f.state_dict()), "opt_f": adam_f.run_tensors(),
            "rng_f": torch.stack([g.get_state() for g in gens])}


def gathered_trees(trees, like: dict, num_folds: int, grid) -> dict:
    """`fold_trees` of every real fold, [K, ...] leaves, on every rank
    (`gather_folds` leaf by leaf; `trees` None on a rank with no fold)."""
    if trees is None:
        return _tree_map(lambda lk: gather_folds(None, lk, num_folds, grid), like)
    return _tree_map(lambda t, lk: gather_folds(t.to(grid.device), lk, num_folds, grid),
                     trees, like)


def inflight_bundle(trees: dict, flat_state: bool) -> dict:
    """The stacked in-flight bundle's state leaves from `fold_trees`: the
    moments as `FoldAdam.state_tensors` lays them out (under `flat_state`
    the runs raveled one after another: the flat buffer) and the
    generator states a list."""
    opt = dict(trees["opt_f"])
    if flat_state:
        opt = {"steps": opt["steps"],
               **{k: torch.cat([r.reshape(-1) for r in opt[k]])
                  for k in ("exp_avg", "exp_avg_sq")}}
    return {"params_f": trees["params_f"], "opt_f": opt,
            "rng_f": list(trees["rng_f"])}


def load_own_folds(bundle: dict, num_folds: int, own: List[int], net_f: DGCNNFoldsNet,
                   adam_f: FoldAdam, gens) -> None:
    """Load the folds `own` of a stacked in-flight bundle of `num_folds`
    folds (`inflight_bundle`'s layout) into this rank's live state."""
    sel = np.asarray(own)
    load_into(net_f, {k: v[sel] for k, v in bundle["params_f"].items()})
    opt = bundle["opt_f"]
    own_opt = {"steps": np.asarray(opt["steps"])[sel]}
    for key in ("exp_avg", "exp_avg_sq"):
        shapes = [tuple(r.shape[1:]) for r in adam_f.run_tensors()[key]]
        if adam_f.flat_state:  # the flat buffer: each parameter's [K, ...] run
            flat, off, runs = np.asarray(opt[key]), 0, []
            for shape in shapes:
                n = num_folds * int(np.prod(shape, dtype=np.int64))
                runs.append(flat[off : off + n].reshape((num_folds,) + shape)[sel])
                off += n
            own_opt[key] = np.concatenate([r.reshape(-1) for r in runs])
        else:
            own_opt[key] = [np.asarray(opt[key][str(i)])[sel] for i in range(len(shapes))]
    load_into(adam_f, own_opt)
    for f, gen in zip(own, gens):
        load_into(gen, bundle["rng_f"][str(f)])


def run_cv_folds_lockstep(cfg: Config, dataset: GraphSet, model: DGCNN,
                          folds: List[Tuple[np.ndarray, np.ndarray]],
                          events: EventLog, engine, grid=None
                          ) -> Tuple[List[float], List[float]]:
    """Run the whole K-fold experiment in fold-lockstep on the layout of
    `engine` (a dense, block-sparse or multi-tile engine of train/cv.py,
    whose device and `graphs` the run takes). Returns (train_accs,
    test_accs) and writes the sequential driver's artifact set.

    With `grid` (a (D, 1) process grid; the reference's fold sharding,
    dgcnn_tpu/train/cv_vmap.py:328-420) this rank trains only its
    `fold_block`, in lockstep, through its own single-device engine: a
    process has its own shapes, so the reference's masked pad folds are
    not built (a deliberate divergence), and the fold half being
    embarrassingly parallel, no collective runs inside an epoch (each is
    still a CUDA-graph replay). Everything keyed by a fold takes its
    global id. After every chunk each fold's rows, and at every in-flight
    bundle and at the end its state, reach every rank by broadcasts from
    the fold's owner (`gather_folds`); rank 0 writes the events, the CSVs,
    the bundles and the stacked in-flight bundle of every real fold, with
    each rank's grow-only floors as a row, and a resumed rank loads its
    own folds and floors from it. A rank with no fold still joins every
    collective."""
    fp32_only()  # the trunk's per-weight-set gradient sum is an fp32 product
    device = engine.device
    num_folds = len(folds)
    own = fold_block(num_folds, grid)
    writer = grid is None or grid.writer
    train_idx_f = [np.asarray(tr, np.int32) for tr, _ in folds]
    test_idx_f = [np.asarray(te, np.int32) for _, te in folds]
    n_train_f = [len(t) for t in train_idx_f]
    n_test_f = [len(t) for t in test_idx_f]

    shuffles = {f: np.random.default_rng(np.random.SeedSequence([cfg.seed, f + 1]))
                for f in own}
    net_f = adam_f = None
    dropout_gens = []
    if own:
        net_f = DGCNNFoldsNet(model, stack_params([
            init_params(torch.Generator().manual_seed(_stream_seed(cfg.seed, f + 1, 1)),
                        model, device) for f in own]))
        adam_f = FoldAdam(net_f, cfg.learning_rate, cfg.adam_b1, cfg.adam_b2,
                          cfg.adam_eps, flat_state=cfg.opt_flatten)
        dropout_gens = [torch.Generator(device=device).manual_seed(
            _stream_seed(cfg.seed, f + 1, 2)) for f in own]
    like = None
    if grid is not None:  # one fold's leaves: the shapes every rank gathers
        net1 = DGCNNFoldsNet(model, stack_params([
            init_params(torch.Generator().manual_seed(0), model, device)]))
        like = fold_trees(net1, FoldAdam(net1), [torch.Generator(device=device)])

    def state():  # every real fold's stacked state, on every rank
        local = fold_trees(net_f, adam_f, dropout_gens) if own else None
        return local if grid is None else gathered_trees(local, like, num_folds, grid)

    def floors():  # the engine's floors; on a grid each rank's as a row
        mine = engine_floors(engine)
        if grid is None:
            return mine
        return {n: gather_folds(torch.as_tensor(v, device=device)[None],
                                torch.as_tensor(v)[None], grid.n_data, grid).cpu().numpy()
                for n, v in mine.items()}

    edge_counts = dataset.edge_counts()
    train_edges = int(sum(edge_counts[idx].sum() for idx in train_idx_f))
    metrics_f = [FoldMetrics() for _ in range(num_folds)]
    inflight = os.path.join(cfg.epochs_dir, f"{cfg.data_type}_lockstep_inflight")
    epoch = 1
    if cfg.checkpoint_resume and checkpoint_exists(inflight):
        bundle = load_checkpoint(inflight)
        epoch = resumed_epoch(cfg, inflight, bundle, "run")
        if own:
            load_own_folds(bundle, num_folds, own, net_f, adam_f, dropout_gens)
        saved = bundle.get("floors", {})
        restore_floors(engine, saved if grid is None else
                       {n: np.asarray(v)[grid.d] for n, v in saved.items()})
        for f, m in enumerate(metrics_f):
            m.rows = {c: [float(v) for v in bundle["metrics"][c][f]]
                      for c in FoldMetrics.COLUMNS}
        # replay every fold's shuffle stream: epoch e sees the permutations
        # it would have seen in an uninterrupted run
        for f, rng in shuffles.items():
            for _ in range(epoch - 1):
                rng.permutation(n_train_f[f])
        if writer:
            print(f"[all folds] resumed at epoch {epoch} (lockstep)")
    while epoch <= cfg.num_epochs:
        k = chunk_epochs(cfg, epoch)
        ids_k = [[train_idx_f[f][shuffles[f].permutation(n_train_f[f])] for f in own]
                 for _ in range(k)]
        t0 = time.perf_counter()
        builds = engine.runners.builds
        rows = None
        if own:
            runner, orders = lockstep_chunk(engine, net_f, adam_f, dropout_gens, ids_k,
                                            [test_idx_f[f] for f in own])
            rows = runner.run_epochs(orders)  # [k, F, 4]
        if grid is not None:
            local = None if rows is None else torch.from_numpy(
                np.ascontiguousarray(rows.transpose(1, 0, 2))).to(device)
            rows = gather_folds(local, torch.zeros((1, k, 4), dtype=torch.float64),
                                num_folds, grid).cpu().numpy().transpose(1, 0, 2)
        dt = (time.perf_counter() - t0) / k  # amortized over the chunk
        built = engine.runners.builds != builds
        for j in range(k):
            for f in range(num_folds):
                tr_loss, te_loss, tr_correct, te_correct = rows[j, f]
                train_acc = tr_correct / n_train_f[f] * 100.0
                test_acc = te_correct / n_test_f[f] * 100.0
                metrics_f[f].append(tr_loss, te_loss, train_acc, test_acc)
                events.write(
                    kind="epoch",
                    fold=f + 1,
                    epoch=epoch + j,
                    train_loss=float(tr_loss),
                    test_loss=float(te_loss),
                    train_accuracy=float(train_acc),
                    test_accuracy=float(test_acc),
                    # one lockstep epoch covers every fold's epoch
                    epoch_seconds=dt,
                    edges_per_second=train_edges / dt if dt > 0 else 0.0,
                    chunk_epochs=k,
                    folds_in_lockstep=num_folds,
                    runner_built=built,
                    capture_seconds=getattr(engine.runners.runner, "capture_seconds",
                                            None) if built else None,
                )
            if writer and cfg.log_every and (epoch + j) % cfg.log_every == 0:
                accs = " ".join(f"{rows[j, f, 3] / n_test_f[f] * 100.0:.1f}"
                                for f in range(num_folds))
                print(f"[all folds] epoch {epoch + j}: test% [{accs}] ({dt:.2f}s)")
        epoch += k
        if checkpoint_due(cfg, epoch - 1):
            trees, fl = state(), floors()
            if writer:
                save_checkpoint(inflight, {
                    **inflight_bundle(trees, cfg.opt_flatten),
                    "epoch": np.int64(epoch - 1),
                    "metrics": {c: np.stack([np.asarray(m.rows[c]) for m in metrics_f])
                                for c in FoldMetrics.COLUMNS},
                    "floors": fl})
    engine.end_fold()  # drops the runner and its graph

    trees = state()
    train_accs, test_accs = [], []
    for f in range(num_folds):
        if writer:
            save_checkpoint(fold_bundle(cfg, f + 1), {
                "params": fold_state(trees["params_f"], f),
                "opt_state": fold_adam_state(trees["opt_f"], f, cfg.opt_flatten)})
            metrics_f[f].to_csv(fold_csv(cfg, f + 1))
        train_accs.append(metrics_f[f].last("train_accuracy"))
        test_accs.append(metrics_f[f].last("test_accuracy"))
        if writer:
            print(f"[{f + 1}] Train Acc: {train_accs[-1]:.2f}% "
                  f"Test Acc: {test_accs[-1]:.2f}%")
    if writer:
        remove_checkpoint(inflight)
    return train_accs, test_accs
