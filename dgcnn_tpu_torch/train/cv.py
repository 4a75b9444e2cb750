"""Cross-validation driver — the port of dgcnn_tpu/train/cv.py
(`choose_layout` :141, `_geom_round` :373, `BlockSparseEngine` :434,
`DenseEngine` :521, `run_fold` :1130, `run_cross_validation` :1301).

Protocol: for each fold, fresh weights and a fresh Adam, the fold's
training graphs shuffled each epoch on numpy's
`default_rng(SeedSequence([seed, fold]))` stream (the reference's own, so
both packages see the same batches), train then evaluate every epoch,
and write the per-fold CSV, the `epochs/` bundle, the overall CSV and the
event log under the reference's file names.

The port serves the dense and block-sparse layouts with folds run one
after another. `choose_layout` answers as the reference does; every other
layout, fold-lockstep, meshes, bf16, resume and the other options not
ported yet raise NotImplementedError naming the ROADMAP item that ports
them (`check_supported`).

Randomness: weights come from a CPU `torch.Generator` and dropout from a
generator on the run's device, each seeded from
`SeedSequence([seed, fold, stream])`; the numbers differ from JAX's keys
(tests compare the two packages on shared weights and batches).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from dgcnn_tpu_torch.batching.block_sparse import (
    block_batch_extents,
    block_graphset_bytes,
    block_graphset_to_device,
    build_block_graphset,
    gather_block_batch,
)
from dgcnn_tpu_torch.batching.dense import (
    build_dense_dataset,
    dense_dataset_bytes,
    dense_tile,
    gather_dense_batch,
    order_matrix,
)
from dgcnn_tpu_torch.batching.multi_dense import multi_dense_bytes, plan_tiles
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.datasets import load_dataset
from dgcnn_tpu_torch.data.folds import get_folds
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params, num_params
from dgcnn_tpu_torch.train.loop import make_optimizer, run_epoch
from dgcnn_tpu_torch.train.metrics import EventLog, FoldMetrics, write_overall_csv
from dgcnn_tpu_torch.utils.checkpoint import save_checkpoint


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller asks for the CPU; raises when CUDA is asked
    for (or left to the default) and absent — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --platform cpu) "
            "to run the port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def fp32_only() -> None:
    """Full fp32 products at the entry points: cuDNN runs fp32
    convolutions in TF32 by default, and the port is held to the fp32
    reference. (The readout does not use cuDNN; this pins it anyway.)"""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for every setting this slice does not
    serve, naming the ROADMAP item that ports it."""
    unserved = []
    if cfg.compute_dtype != "float32" or cfg.adj_dtype == "bfloat16":
        unserved.append("bfloat16 compute or adjacency (ROADMAP Queue 1 item 10)")
    if cfg.cv_parallel == "folds":
        unserved.append("cv_parallel='folds', fold-lockstep (ROADMAP Queue 1 item 5)")
    if tuple(cfg.mesh_shape) != (1, 1):
        unserved.append("a device mesh (ROADMAP Queue 1 item 12)")
    if cfg.checkpoint_resume or cfg.checkpoint_every:
        unserved.append("resume and in-flight checkpoints (ROADMAP Queue 1 item 11)")
    if cfg.tensorboard_dir:
        unserved.append("TensorBoard export (ROADMAP Queue 1 item 11)")
    if cfg.opt_flatten:
        unserved.append("opt_flatten (ROADMAP Queue 1 item 11)")
    if cfg.spmm_impl != "auto":
        unserved.append("spmm_impl, the COO SpMM kernels (ROADMAP Queue 2 items 4-6)")
    if unserved:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(unserved)
        )


_LAYOUT_ITEM = {
    "multi": "ROADMAP Queue 1 item 7",
    "coo": "ROADMAP Queue 1 item 8",
    "halo": "ROADMAP Queue 1 item 12",
}


def percentile_sort_pool_k(node_counts: np.ndarray, percentile: float) -> int:
    """Original-paper k: the `percentile`-quantile of graph sizes, floored
    at 10 (muhanzhang/pytorch_DGCNN's sortpooling_k)."""
    sizes = np.sort(np.asarray(node_counts))
    idx = max(0, int(np.ceil(percentile * len(sizes))) - 1)
    return max(10, int(sizes[idx]))


def _model_from_config(cfg: Config, num_features: int, num_classes: int,
                       node_counts: Optional[np.ndarray] = None) -> DGCNN:
    k = cfg.sort_pool_k
    if cfg.sort_pool_percentile is not None:
        if node_counts is None:
            raise ValueError("sort_pool_percentile needs dataset node counts")
        k = percentile_sort_pool_k(node_counts, cfg.sort_pool_percentile)
        print(f"sort_pool_k={k} ({cfg.sort_pool_percentile:.0%} percentile)")
    return DGCNN(
        num_features=num_features,
        num_classes=num_classes,
        hidden_dims=tuple(cfg.hidden_dims),
        sort_pool_k=k,
        conv1d_channels=tuple(cfg.conv1d_channels),
        conv1d_kernel=cfg.conv1d_kernel,
        dense_dim=cfg.dense_dim,
        dropout_rate=cfg.dropout_rate,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fold_shard_devices(mesh_shape, num_folds: int):
    """Mesh data-axis size usable for fold-sharded lockstep, or None (the
    reference's train/cv_vmap.py:328)."""
    d, g = mesh_shape
    if g != 1 or d < 1:
        return None
    return max(d, 1)


def _lockstep_would_engage(cfg: Config, dataset: GraphSet, n_tile: int) -> bool:
    """Whether the reference would train this dataset's folds in lockstep
    on the dense layout (its stacked step under the byte budget)."""
    if cfg.cv_parallel == "folds":
        return True
    if cfg.cv_parallel != "auto":
        return False
    d = fold_shard_devices(cfg.mesh_shape, cfg.num_folds)
    if d is None:
        return False
    slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
    step_bytes = (
        cfg.num_folds * slots * n_tile * (n_tile + dataset.num_features) * 4
    )
    return step_bytes <= cfg.lockstep_max_step_bytes * d


def _batched_lockstep_would_engage(cfg: Config) -> bool:
    if cfg.cv_parallel == "folds":
        return True
    if cfg.cv_parallel != "auto":
        return False
    return fold_shard_devices(cfg.mesh_shape, cfg.num_folds) is not None


def choose_layout(cfg: Config, dataset: GraphSet) -> str:
    """The batch layout the reference picks for this config and dataset:
    single-tile dense when the largest graph and the device footprint
    fit, demoted to the multi-tile ladder when fold-lockstep cannot engage
    and bucketing cuts the expected tile traffic ≥2×; block-sparse for
    heavy-tailed datasets; COO as the memory-safe fallback. The gates are
    the reference's, tuned on its TPU; the port copies their semantics
    until its own measurements set its defaults."""
    if cfg.layout != "auto":
        return cfg.layout
    n_tile = dense_tile(dataset)
    adj_bytes = 2 if (
        cfg.compute_dtype == "bfloat16"
        or cfg.resolved_adj_dtype() == "bfloat16"
    ) else 4
    if (
        n_tile <= cfg.dense_max_nodes
        and dense_dataset_bytes(dataset, n_tile, adj_bytes)
        <= cfg.dense_max_device_bytes
    ):
        multi_runnable = cfg.mesh_shape == (1, 1) or (
            _batched_lockstep_would_engage(cfg)
        )
        if multi_runnable and not _lockstep_would_engage(cfg, dataset, n_tile):
            nc = dataset.node_counts()
            tiles = plan_tiles(nc, cfg.multi_dense_min_tile)
            if len(tiles) > 1:
                tile_of = np.asarray(tiles, dtype=np.float64)[
                    np.searchsorted(np.asarray(tiles), nc, side="left")
                ]
                mean_tile_sq = float((tile_of * tile_of).mean())
                if (
                    n_tile * n_tile >= 2.0 * mean_tile_sq
                    and multi_dense_bytes(dataset, tiles)
                    <= cfg.dense_max_device_bytes
                ):
                    return "multi"
        return "dense"
    if block_graphset_bytes(dataset) <= cfg.dense_max_device_bytes:
        return "block"
    return "coo"


def _geom_round(x: int, multiple: int, ratio: float = 1.3) -> int:
    """Round up onto a geometric grid (ratio steps, multiple-aligned), the
    reference's `DeviceCooEngine._geom_round`: padding waste stays under
    `ratio` while a run sees few distinct budgets."""
    v = multiple
    while v < x:
        v = _round_up(int(v * ratio) + 1, multiple)
    return v


class DenseEngine:
    """The dense layout's epoch engine: the whole dataset lives on the
    device in dense form; an epoch ships one [steps, slots] index matrix
    and batches are gathered on the device."""

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.n_tile = dense_tile(dataset)
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        self.data = build_dense_dataset(dataset, self.n_tile, device)

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_order = self._to_device(
            order_matrix(test_idx, self.cfg.batch_size, self.slots)
        )

    def _to_device(self, order2d: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(order2d).to(self.device)

    def run_epoch(self, net, optimizer, dropout_gen, perm: np.ndarray) -> np.ndarray:
        order2d = order_matrix(
            self._train_idx[perm], self.cfg.batch_size, self.slots
        )
        return run_epoch(net, optimizer,
                         lambda row: gather_dense_batch(self.data, row),
                         self._to_device(order2d), self._test_order, dropout_gen)


class BlockSparseEngine:
    """The block-sparse layout's epoch engine (batching/block_sparse.py):
    the dataset lives on the device as a pool of nonzero 128×128
    normalized-adjacency blocks plus block-row features, shipped once per
    run; a batch is assembled on the device from a [slots] graph-id row,
    and each GCN propagation runs one of the block kernels over its work
    items (`cfg.resolved_block_impl()`). Budgets (block-rows, work items)
    grow only, on a geometric grid (floors 8 and 64), sized by
    `block_batch_extents` over each epoch's order matrix and the fold's
    test order."""

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        host = build_block_graphset(dataset)
        self._nb = host.nb.astype(np.int64)
        self._block_counts = host.block_count.astype(np.int64)
        self.dev = block_graphset_to_device(host, device)
        self.block_impl = cfg.resolved_block_impl()
        self.floor_nb = 8
        self.floor_w = 64

    def budget_for(self, *order_mats: np.ndarray):
        """Grow-only (nb, W) budgets covering every batch row given."""
        nb = w = 1
        for m in order_mats:
            bn, bw = block_batch_extents(self._nb, self._block_counts, m)
            nb, w = max(nb, bn), max(w, bw)
        self.floor_nb = max(self.floor_nb, _geom_round(nb, 8))
        self.floor_w = max(self.floor_w, _geom_round(w, 64))
        return self.floor_nb, self.floor_w

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._test_order = torch.from_numpy(self._test_np).to(self.device)

    def run_epoch(self, net, optimizer, dropout_gen, perm: np.ndarray) -> np.ndarray:
        order2d = order_matrix(
            self._train_idx[perm], self.cfg.batch_size, self.slots
        )
        nb, w = self.budget_for(order2d, self._test_np)
        return run_epoch(
            net, optimizer,
            lambda row: gather_block_batch(self.dev, row, nb, w),
            torch.from_numpy(order2d).to(self.device), self._test_order,
            dropout_gen, pool=self.dev.pool, block_impl=self.block_impl,
        )


def _stream_seed(seed: int, fold: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, fold, stream]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def adam_state(net: DGCNNNet, optimizer: torch.optim.Adam) -> dict:
    """Adam's moments and step counts in `net.parameters()` order."""
    out = {"step": [], "exp_avg": [], "exp_avg_sq": []}
    for p in net.parameters():
        st = optimizer.state.get(p, {})
        for key in out:
            out[key].append(st.get(key, torch.zeros(())))
    return out


def run_fold(cfg: Config, dataset: GraphSet, model: DGCNN, fold_number: int,
             train_idx: np.ndarray, test_idx: np.ndarray, engine,
             events: EventLog) -> FoldMetrics:
    """One fold: fresh weights and optimizer, `cfg.num_epochs` epochs of
    train + eval, then the fold's CSV and `epochs/` bundle."""
    device = engine.device
    n_train, n_test = len(train_idx), len(test_idx)
    train_edges = int(dataset.edge_counts()[np.asarray(train_idx)].sum())
    engine.begin_fold(train_idx, test_idx)

    init_gen = torch.Generator().manual_seed(_stream_seed(cfg.seed, fold_number, 1))
    net = DGCNNNet(model, init_params(init_gen, model, device))
    optimizer = make_optimizer(net, cfg.learning_rate, cfg.adam_b1,
                               cfg.adam_b2, cfg.adam_eps)
    dropout_gen = torch.Generator(device=device).manual_seed(
        _stream_seed(cfg.seed, fold_number, 2)
    )
    shuffle_rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, fold_number])
    )

    metrics = FoldMetrics()
    for epoch in range(1, cfg.num_epochs + 1):
        perm = shuffle_rng.permutation(n_train)
        t0 = time.perf_counter()
        tr_loss, te_loss, tr_correct, te_correct = engine.run_epoch(
            net, optimizer, dropout_gen, perm
        )
        dt = time.perf_counter() - t0
        train_acc = float(tr_correct) / n_train * 100.0
        test_acc = float(te_correct) / n_test * 100.0
        metrics.append(float(tr_loss), float(te_loss), train_acc, test_acc)
        events.write(
            kind="epoch",
            fold=fold_number,
            epoch=epoch,
            train_loss=float(tr_loss),
            test_loss=float(te_loss),
            train_accuracy=train_acc,
            test_accuracy=test_acc,
            epoch_seconds=dt,
            edges_per_second=train_edges / dt if dt > 0 else 0.0,
            chunk_epochs=1,
        )
        if cfg.log_every and epoch % cfg.log_every == 0:
            print(
                f"[fold {fold_number}] epoch {epoch}: "
                f"train {tr_loss:.4f}/{train_acc:.2f}% "
                f"test {te_loss:.4f}/{test_acc:.2f}% ({dt:.2f}s)"
            )

    save_checkpoint(
        os.path.join(cfg.epochs_dir, f"{cfg.data_type}_{fold_number}"),
        {"params": net.state_dict(), "opt_state": adam_state(net, optimizer)},
    )
    metrics.to_csv(
        os.path.join(cfg.statistics_dir, f"{cfg.data_type}_results_{fold_number}.csv")
    )
    return metrics


def run_cross_validation(cfg: Config, dataset: Optional[GraphSet] = None,
                         allow_synthetic: bool = False, device=None):
    """Full experiment on `device` (default `cuda`; `"cpu"` runs the plain
    PyTorch path). Returns per-fold and aggregate accuracies, as the
    reference does."""
    device = resolve_device(device)
    fp32_only()
    check_supported(cfg)
    if dataset is None:
        dataset, meta = load_dataset(
            cfg.data_type, root=cfg.data_root,
            use_node_attr=cfg.use_node_attr, allow_synthetic=allow_synthetic,
        )
        if meta.source == "synthetic":
            print(f"WARNING: using synthetic {cfg.data_type} profile data")

    print(f"num_features={dataset.num_features}, num_classes={dataset.num_classes}")
    model = _model_from_config(
        cfg, dataset.num_features, dataset.num_classes, dataset.node_counts()
    )
    layout = choose_layout(cfg, dataset)
    if layout not in ("dense", "block"):
        raise NotImplementedError(
            f"the {layout!r} layout (chosen for {cfg.data_type}) is not ported "
            f"yet ({_LAYOUT_ITEM[layout]}); the port runs the dense and block "
            f"layouts"
        )
    if layout == "dense" and _lockstep_would_engage(cfg, dataset,
                                                     dense_tile(dataset)):
        print("fold-lockstep is not ported yet (ROADMAP Queue 1 item 5): "
              "folds run sequentially")
    if layout == "block" and _batched_lockstep_would_engage(cfg):
        print("block fold-lockstep is not ported yet (ROADMAP Queue 1 item 9): "
              "folds run sequentially")

    fold_dir = cfg.fold_index_dir or os.path.join(
        cfg.data_root, cfg.data_type, "10fold_idx"
    )
    folds = get_folds(
        dataset.y, fold_dir, cfg.num_folds, cfg.seed, data_type=cfg.data_type
    )
    events = EventLog(
        os.path.join(cfg.statistics_dir, f"{cfg.data_type}_events.jsonl")
    )
    events.write(
        kind="run_start",
        data_type=cfg.data_type,
        num_graphs=dataset.num_graphs,
        num_features=dataset.num_features,
        num_classes=dataset.num_classes,
        layout=layout,
        **({"block_impl": cfg.resolved_block_impl()} if layout == "block" else {}),
        num_params=num_params(init_params(torch.Generator().manual_seed(0), model)),
        device=str(device),
    )
    engine = (BlockSparseEngine if layout == "block" else DenseEngine)(
        cfg, dataset, device
    )

    train_accs, test_accs = [], []
    for fold_number, (train_idx, test_idx) in enumerate(folds, start=1):
        t0 = time.perf_counter()
        metrics = run_fold(cfg, dataset, model, fold_number, train_idx,
                           test_idx, engine, events)
        dt = time.perf_counter() - t0
        train_accs.append(metrics.last("train_accuracy"))
        test_accs.append(metrics.last("test_accuracy"))
        print(
            f"[{fold_number}] Train Acc: {train_accs[-1]:.2f}% "
            f"Test Acc: {test_accs[-1]:.2f}% ({dt:.1f}s)"
        )
    return _finalize_cv(cfg, events, train_accs, test_accs)


def _finalize_cv(cfg: Config, events: EventLog, train_accs, test_accs):
    """Overall CSV, summary line and run_end event."""
    write_overall_csv(
        os.path.join(cfg.statistics_dir, f"{cfg.data_type}_results_overall.csv"),
        train_accs,
        test_accs,
    )
    tr, te = np.array(train_accs), np.array(test_accs)
    print(
        "Overall Training Accuracy: %.2f%% (std: %.2f) Testing Accuracy: %.2f%% (std: %.2f)"
        % (tr.mean(), tr.std(), te.mean(), te.std())
    )
    events.write(
        kind="run_end",
        train_accuracy_mean=float(tr.mean()),
        train_accuracy_std=float(tr.std()),
        test_accuracy_mean=float(te.mean()),
        test_accuracy_std=float(te.std()),
    )
    return {
        "train_accuracies": train_accs,
        "test_accuracies": test_accs,
        "train_accuracy_mean": float(tr.mean()),
        "train_accuracy_std": float(tr.std()),
        "test_accuracy_mean": float(te.mean()),
        "test_accuracy_std": float(te.std()),
    }
