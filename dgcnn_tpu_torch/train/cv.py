"""Cross-validation driver — the port of dgcnn_tpu/train/cv.py
(`choose_layout` :141, `CooEngine` :249, `DeviceCooEngine` :339,
`_geom_round` :373, `BlockSparseEngine` :434, `DenseEngine` :521,
`MultiDenseEngine` :583, the
engine choice of `make_engine` :1067, `run_fold` :1130,
`run_cross_validation` :1301, with its lockstep dispatch :1361-1401,
its resume :1409-1443 and its fold loop :1461-1504, and `_finalize_cv`
:1508).

Protocol: for each fold, fresh weights and a fresh Adam, the fold's
training graphs shuffled each epoch on numpy's
`default_rng(SeedSequence([seed, fold]))` stream (the reference's own, so
both packages see the same batches), train then evaluate every epoch,
and write the per-fold CSV, the `epochs/` bundle, the overall CSV and the
event log under the reference's file names.

Resume (`checkpoint_every`, `checkpoint_resume`, the reference's
:1158-1190, :1196-1207, :1256-1285): chunks are cut at the checkpoint
cadence, and every `checkpoint_every` epochs a fold writes its in-flight
bundle `epochs/<DS>_<fold>_inflight` (parameters, Adam's state, the
dropout generator's state, the epoch, the metric rows, and the engine's
grow-only floors, `engine_floors`); a resumed fold loads it in place,
replays its shuffle stream and continues, its rows the uninterrupted
run's bits; a complete fold (its CSV full and its bundle written) is
skipped, and the fold after it starts from the floors the engine had
after it (`epochs/<DS>_floors`, written at every fold's end, removed at
run end). The lockstep driver keeps one stacked bundle for all folds
(train/cv_vmap.py); a partly complete run that `auto` would lockstep is
demoted to the sequential driver for its missing folds. The run tail
draws the curves (train/plots.py, at chunk boundaries on a throttle and
at run end) and exports TensorBoard events (train/tensorboard.py), both
best-effort on the host.

The port serves the dense, multi-tile dense, block-sparse and COO
layouts. The folds train in lockstep (train/cv_vmap.py, over the
layout's engine) where the reference would lockstep them
(`lockstep_engages`): under `cv_parallel="folds"` on the dense, block
and multi-tile layouts; under "auto" on the dense layout when
`_lockstep_would_engage`, and always on the block layout (on one device
the reference runs multi-tile folds one after another). Otherwise, and
on the COO layout, the folds run one after another. `choose_layout`
answers as the reference does; the halo layout and meshes raise
NotImplementedError naming the ROADMAP item that ports them
(`check_supported`). Each engine stores its data at the
reference's dtypes: the dense and multi-tile datasets at
`store_dtypes(resolved_adj_dtype, compute_dtype)`, the block pool at
`pool_dtype(cfg)`; the COO engines in fp32.

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
    block_fold_extents,
    block_graphset_bytes,
    block_graphset_to_device,
    build_block_graphset,
)
from dgcnn_tpu_torch.batching.dense import (
    build_dense_dataset,
    dense_dataset_bytes,
    dense_tile,
    order_matrix,
)
from dgcnn_tpu_torch.batching.device_coo import (
    batch_extents,
    build_device_graphset,
    device_graphset_to,
)
from dgcnn_tpu_torch.batching.multi_dense import (
    build_multi_dense_on_device,
    class_batch_counts,
    multi_dense_bytes,
    plan_tiles,
    route_order_rows,
)
from dgcnn_tpu_torch.batching.packer import (
    BucketSpec,
    add_blockcoo,
    batch_to_device,
    compute_bucket,
    pack_epoch,
    pad_blockcoo,
    pin_batch,
    resolve_backend,
)
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.datasets import load_dataset
from dgcnn_tpu_torch.data.folds import get_folds
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params, num_params
from dgcnn_tpu_torch.train.loop import (
    make_block_run,
    make_coo_run,
    make_dense_gather_run,
    make_device_coo_run,
    make_multi_dense_run,
    make_optimizer,
)
from dgcnn_tpu_torch.train.metrics import (
    EventLog, FoldMetrics, completed_fold_accuracies, write_overall_csv,
)
from dgcnn_tpu_torch.utils.checkpoint import (
    adam_state, checkpoint_exists, load_checkpoint, load_into, remove_checkpoint,
    save_checkpoint,
)


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
    reference. (The readout does not use cuDNN; this pins it anyway.)
    Under bf16 compute no product runs in bf16: every matmul takes its
    bf16 operands widened to fp32 (`ops/readout.matmul_f32`), so neither
    a bf16 result nor cuBLAS's reduced-precision bf16 reduction
    (`allow_bf16_reduced_precision_reduction`) can enter, and the fp32
    settings here cover them."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for every setting this slice does not
    serve, naming the ROADMAP item that ports it."""
    unserved = []
    if tuple(cfg.mesh_shape) != (1, 1):
        unserved.append("a device mesh (ROADMAP Queue 1 item 12)")
    if unserved:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(unserved)
        )


def pool_dtype(cfg: Config) -> str:
    """The block pool's storage dtype, the reference's rule
    (dgcnn_tpu/train/cv.py:457-469): the compute dtype when it is not
    float32, else the resolved adjacency dtype."""
    return cfg.compute_dtype if cfg.compute_dtype != "float32" else cfg.resolved_adj_dtype()


LOCKSTEP_LAYOUTS = ("dense", "block", "multi")


def check_lockstep_layout(layout: str) -> None:
    """`cv_parallel="folds"` on a layout lockstep never runs on (coo,
    halo): the reference's ValueError."""
    if layout not in LOCKSTEP_LAYOUTS:
        raise ValueError(
            f"cv_parallel='folds' is incompatible with: layout={layout!r} "
            f"(lockstep runs on the dense, block-sparse or multi-tile layout; "
            f"this dataset resolved to {layout!r})")


_LAYOUT_ITEM = {
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
        compute_dtype=cfg.compute_dtype,
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
    """Whether this dataset's folds train in lockstep on the dense layout:
    the reference's gate, semantics copied (its stacked step under the
    byte budget; `cv_parallel="folds"` always, "sequential" never)."""
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
    """Whether the block or multi-tile layout's folds could train in
    lockstep: the reference's gate (no byte budget: these batches scale
    with graph structure, not with the largest tile squared)."""
    if cfg.cv_parallel == "folds":
        return True
    if cfg.cv_parallel != "auto":
        return False
    return fold_shard_devices(cfg.mesh_shape, cfg.num_folds) is not None


def lockstep_engages(cfg: Config, dataset: GraphSet, layout: str) -> bool:
    """Whether the folds train in lockstep on `layout`, as the reference
    decides (dgcnn_tpu/train/cv.py:1361-1401): `cv_parallel="folds"` on
    any lockstep layout; under "auto" the dense layout when its stacked
    step fits the byte budget, the block layout always, and the
    multi-tile layout only over a fold-sharding mesh of more than one
    device (one card runs its folds one after another)."""
    if layout == "dense":
        return _lockstep_would_engage(cfg, dataset, dense_tile(dataset))
    if layout == "block":
        return _batched_lockstep_would_engage(cfg)
    if layout == "multi":
        d = fold_shard_devices(cfg.mesh_shape, cfg.num_folds)
        return cfg.cv_parallel == "folds" or (
            cfg.cv_parallel == "auto" and d is not None and d > 1)
    return False


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


class RunnerSlot:
    """An engine's one fused runner (train/loop.py `FusedRun`), keyed by
    what it was built for: the fold and the budget (in lockstep the
    budget alone). `get(key, make)` returns the runner for `key`; under
    another key it first drops the old runner, and with it its CUDA graph
    and that graph's memory pool, then builds the new one, which warms up
    and captures on its first chunk. Budgets grow only, so a run builds
    one runner a fold (in lockstep one a run) and one more each time a
    budget grows."""

    def __init__(self):
        self.key = self.runner = None

    def get(self, key, make):
        if self.runner is None or key != self.key:
            self.drop()
            self.runner, self.key = make(), key
        return self.runner

    def drop(self) -> None:
        """Release the runner: its graph holds the addresses of the fold's
        net and optimizer."""
        self.key = self.runner = None


class DenseEngine:
    """The dense layout's epoch engine: the whole dataset lives on the
    device in dense form; a chunk of epochs ships one [k, steps, slots]
    index matrix and batches are gathered on the device. A fold's epochs
    run through one fused runner (train/loop.py `make_dense_gather_run`:
    on the card the fold's first epoch warms up, the rest are CUDA-graph
    replays), dropped at the fold's end with its graph. `graphs=False`
    runs every epoch eagerly on the card, for comparison only."""

    FLOORS = ()  # no grow-only budget: one runner a fold

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = device
        self.graphs = graphs
        self.n_tile = dense_tile(dataset)
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        self.data = build_dense_dataset(dataset, self.n_tile, device,
                                        cfg.resolved_adj_dtype(), cfg.compute_dtype)
        self.runners = RunnerSlot()
        self._fold = 0


    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs; host rows [k, 4]."""
        orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                        self.slots) for perm in perms])
        runner = self.runners.get(self._fold, lambda: make_dense_gather_run(
            net, optimizer, self.data, self._test_np, orders.shape[1], dropout_gen,
            self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.drop()


class BlockSparseEngine:
    """The block-sparse layout's epoch engine (batching/block_sparse.py):
    the dataset lives on the device as a pool of nonzero 128×128
    normalized-adjacency blocks plus block-row features, shipped once per
    run; a batch is assembled on the device from a [slots] graph-id row,
    and each GCN propagation runs one of the block kernels over its work
    items (`cfg.resolved_block_impl()`). A chunk of k epochs ships one
    [k, steps, slots] index matrix and runs through the fused runner of
    its budgets (train/loop.py `make_block_run`: on the card one
    CUDA-graph replay an epoch once the runner has captured). The budgets
    (block-rows, work items) are sized once a chunk by
    `block_batch_extents` over the chunk's orders and the fold's test
    order, as the reference's `_budget_for` (dgcnn_tpu/train/cv.py:477),
    and grow only, on a geometric grid (floors 8 and 64), across chunks
    and folds; a grown budget gets a new runner (`RunnerSlot`).
    `graphs=False` runs every epoch eagerly on the card, for comparison
    only."""

    FLOORS = ("floor_nb", "floor_w")

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = device
        self.graphs = graphs
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        host = build_block_graphset(dataset)
        self._nb = host.nb.astype(np.int64)
        self._block_counts = host.block_count.astype(np.int64)
        self.dev = block_graphset_to_device(host, device, pool_dtype(cfg))
        self.block_impl = cfg.resolved_block_impl()
        self.floor_nb = 8
        self.floor_w = 64
        self.runners = RunnerSlot()
        self._fold = 0


    def budget_for(self, *order_mats: np.ndarray, folds: bool = False):
        """Grow-only (nb, W) budgets covering every batch row given; with
        `folds`, every lockstep step [F, slots] of the orders given: nb
        for one fold's batch, W for the step's merged stream
        (`block_fold_extents`, as the reference's lockstep sizes them,
        dgcnn_tpu/train/cv_vmap.py:489)."""
        extents = block_fold_extents if folds else block_batch_extents
        nb = w = 1
        for m in order_mats:
            bn, bw = extents(self._nb, self._block_counts, m)
            nb, w = max(nb, bn), max(w, bw)
        self.floor_nb = max(self.floor_nb, _geom_round(nb, 8))
        self.floor_w = max(self.floor_w, _geom_round(w, 64))
        return self.floor_nb, self.floor_w

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs at the chunk's budgets; host rows [k, 4]."""
        orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                        self.slots) for perm in perms])
        nb, w = self.budget_for(orders, self._test_np)
        runner = self.runners.get((self._fold, nb, w), lambda: make_block_run(
            net, optimizer, self.dev, self._test_np, nb, w, orders.shape[1],
            dropout_gen, self.block_impl, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.drop()


class DeviceCooEngine:
    """The COO layout with batches assembled on the device
    (batching/device_coo.py): the flattened dataset is shipped once, a
    chunk of k epochs ships its [k, steps, slots] int32 order matrix, and
    each batch is gathered on the device from a [slots] graph-id row, the
    chunk's epochs run through the fused runner of its bucket
    (train/loop.py `make_device_coo_run`). The bucket is sized once a
    chunk by `batch_extents` over the chunk's orders and the fold's test
    order, as the reference's `_bucket_for` (dgcnn_tpu/train/cv.py:382),
    and grows only, on its geometric grid (`_geom_round`, multiples of the
    node and edge pad), across chunks and folds; a grown bucket gets a new
    runner (`RunnerSlot`). Each GCN aggregation runs the SpMM kernel
    `cfg.resolved_spmm_impl()` names. `graphs=False` runs every epoch
    eagerly on the card, for comparison only."""

    FLOORS = ("floor_nodes", "floor_edges")

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = device
        self.graphs = graphs
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        self._node_counts = dataset.node_counts().astype(np.int64)
        self._edge_counts = dataset.edge_counts().astype(np.int64)
        self.dev = device_graphset_to(build_device_graphset(dataset), device)
        self.spmm_impl = cfg.resolved_spmm_impl()
        self.floor_nodes = cfg.node_pad_multiple
        self.floor_edges = cfg.edge_pad_multiple
        self.runners = RunnerSlot()
        self._fold = 0


    def bucket_for(self, *order_mats: np.ndarray) -> BucketSpec:
        """Grow-only bucket covering every batch row given."""
        n = e = 1
        for m in order_mats:
            bn, be = batch_extents(self._node_counts, self._edge_counts, m)
            n, e = max(n, bn), max(e, be)
        self.floor_nodes = max(self.floor_nodes,
                               _geom_round(n, self.cfg.node_pad_multiple))
        self.floor_edges = max(self.floor_edges,
                               _geom_round(e, self.cfg.edge_pad_multiple))
        return BucketSpec(num_nodes=self.floor_nodes,
                          num_edges=self.floor_edges, num_graphs=self.slots)

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs in the chunk's bucket; host rows [k, 4]."""
        orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                        self.slots) for perm in perms])
        bucket = self.bucket_for(orders, self._test_np)
        runner = self.runners.get((self._fold, bucket), lambda: make_device_coo_run(
            net, optimizer, self.dev, self._test_np, bucket, orders.shape[1],
            dropout_gen, self.spmm_impl, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.drop()


class CooEngine:
    """The COO layout packed on the host (batching/packer.py), the port of
    the reference's `CooEngine` (dgcnn_tpu/train/cv.py:249): every epoch
    is packed (by the C++ packer, or NumPy without it) into the
    worst-case bucket (`compute_bucket`); the fold's test batches are
    packed and shipped once. A chunk is cut
    into sub-chunks of r = clip(`coo_fuse_bytes` // one packed epoch's
    device bytes, 1, 64) epochs, as the reference cuts it (`_epoch_bytes`,
    :285-310); a sub-chunk's r epochs are packed first, then run through
    the fold's fused runner (train/loop.py `make_coo_run`), which holds
    one packed epoch on the device and stages each epoch into it from
    page-locked host memory before it runs: one host round trip a
    sub-chunk. Under `--spmm pallas` each batch also carries its
    block-pair structure (`add_blockcoo`) for the block-COO kernel, its
    item axes padded to the sub-chunk's budget W: grow-only across
    sub-chunks and folds on the block engine's grid (`_geom_round(·, 64)`)
    over the sub-chunk's largest batch, so that W, and with it the
    runner, changes only between sub-chunks. (The reference pads to
    `blockcoo_item_bound`, one XLA shape a run; the padding appends only
    sentinel items and null slots.) `graphs=False` runs every epoch
    eagerly on the card, for comparison only."""

    FLOORS = ("floor_w",)

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.graphs = graphs
        self.dataset = dataset
        self.slots = _round_up(cfg.batch_size, cfg.graph_pad_multiple)
        self.bucket = compute_bucket(
            dataset, cfg.batch_size, cfg.node_pad_multiple,
            cfg.edge_pad_multiple, cfg.graph_pad_multiple,
        )
        self.spmm_impl = cfg.resolved_spmm_impl()
        self.floor_w = 64
        self.runners = RunnerSlot()
        self._fold = 0
        self._staged = []  # the last sub-chunk's packed epochs, on the host
        self.packed = {"native": 0, "numpy": 0}
        self.pack_seconds = {"pack": 0.0, "blockcoo": 0.0}


    def pack_host(self, ds: GraphSet, order: np.ndarray):
        """`ds` in `order` as one stacked epoch of NumPy arrays, packed by
        the C++ packer when it builds (`resolve_backend("auto")`), else by
        NumPy, structures padded to the epoch's largest batch. Counts the
        epochs each backend packed (`packed`) and the host seconds of the
        packing and of `add_blockcoo` (`pack_seconds`)."""
        backend = resolve_backend("auto")
        t0 = time.perf_counter()
        epoch = pack_epoch(ds, order, self.cfg.batch_size, self.bucket, backend)
        t1 = time.perf_counter()
        self.packed[backend] += 1
        self.pack_seconds["pack"] += t1 - t0
        if self.spmm_impl != "pallas":
            return epoch
        epoch = add_blockcoo(epoch)
        self.pack_seconds["blockcoo"] += time.perf_counter() - t1
        return epoch

    def epoch_bytes(self, n_train: int) -> int:
        """Device bytes of one packed epoch (the reference's `_epoch_bytes`:
        x dominates; the edge and node bookkeeping arrays included)."""
        steps = -(-n_train // self.cfg.batch_size)
        b = self.bucket
        per_step = (b.num_nodes * (self.dataset.num_features * 4 + 8)
                    + b.num_edges * 12 + b.num_graphs * 8 + 4)
        return steps * per_step

    def items_for(self, epochs) -> int:
        """Grow-only block-COO item budget W covering every batch of the
        packed `epochs`."""
        w = max(e.blockcoo[0].ls.shape[1] for e in epochs)
        self.floor_w = max(self.floor_w, _geom_round(w, 64))
        return self.floor_w

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_set = self.dataset.subset(train_idx)
        test_set = self.dataset.subset(test_idx)
        self._test = batch_to_device(
            self.pack_host(test_set, np.arange(test_set.num_graphs)), self.device)
        self.fuse_epochs = int(np.clip(
            self.cfg.coo_fuse_bytes // max(self.epoch_bytes(len(train_idx)), 1), 1, 64))
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs, `fuse_epochs` of them a host round trip; host rows [k, 4]."""
        rows = []
        for i in range(0, len(perms), self.fuse_epochs):
            sub = perms[i:i + self.fuse_epochs]
            epochs = [self.pack_host(self._train_set, p) for p in sub]
            w = 0
            if self.spmm_impl == "pallas":
                w = self.items_for(epochs)
                epochs = [pad_blockcoo(e, w) for e in epochs]
            to_host = pin_batch if self.device.type == "cuda" else (
                lambda e: batch_to_device(e, "cpu"))
            self._staged = [to_host(e) for e in epochs]
            orders = np.stack([order_matrix(p, self.cfg.batch_size, self.slots)
                               for p in sub])
            runner = self.runners.get((self._fold, w), lambda: make_coo_run(
                net, optimizer, lambda j: self._staged[j], self._test, self.slots,
                dropout_gen, self.spmm_impl, self.graphs))
            rows.append(runner.run_epochs(orders))
        return np.concatenate(rows)

    def end_fold(self) -> None:
        self.runners.drop()


class MultiDenseEngine:
    """The multi-tile dense layout's epoch engine (batching/multi_dense.py),
    the port of the reference's `MultiDenseEngine` (dgcnn_tpu/train/cv.py:583):
    every graph lives on the device in dense form at its tile class's tile
    (`plan_tiles` from `multi_dense_min_tile`), built there from the compact
    graphset (`build_multi_dense_on_device`). Each batch is routed into per-
    class index rows (`route_order_rows`), laid side by side in one order
    row [ΣS_c]; a chunk of k epochs ships one [k, steps, ΣS_c] matrix and
    runs through the fused runner of its slot tuple
    (train/loop.py `make_multi_dense_run`: on the card one CUDA-graph replay
    an epoch once the runner has captured), and each class's GCN chain runs
    on the trunk kernel at its own tile and slot count.

    Slot floors, as the reference sets them (:616-640): 4 a class,
    pre-grown over 40 permutations of the whole dataset from
    `default_rng(SeedSequence([seed, 0]))`, capped at the batch size rounded
    up to 4; then, once a chunk, grown only, to the largest class count of
    the chunk's batches and the fold's test batches, rounded up to 4
    (`slots_for`). A grown slot tuple gets a new runner (`RunnerSlot`,
    keyed by fold and slots). `graphs=False` runs every epoch eagerly on
    the card, for comparison only."""

    FLOORS = ("slot_floor",)

    def __init__(self, cfg: Config, dataset: GraphSet, device: torch.device,
                 graphs: bool = True):
        self.cfg = cfg
        self.device = device
        self.graphs = graphs
        self.tiles = plan_tiles(dataset.node_counts(), cfg.multi_dense_min_tile)
        self.classes, self.routing = build_multi_dense_on_device(
            dataset, self.tiles, device, cfg.resolved_adj_dtype(), cfg.compute_dtype)
        self.slot_floor = np.full(len(self.tiles), 4, dtype=np.int64)
        warm_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0]))
        self.slots_for(*(warm_rng.permutation(dataset.num_graphs) for _ in range(40)))
        self.slot_floor = np.minimum(self.slot_floor, _round_up(cfg.batch_size, 4))
        self.runners = RunnerSlot()
        self._fold = 0


    def slots_for(self, *order_seqs: np.ndarray) -> tuple:
        """Grow-only per-class slot counts covering every batch of the
        given graph-id sequences (each cut into batches of the batch size)."""
        need = self.slot_floor
        for ids in order_seqs:
            counts = class_batch_counts(self.routing, ids, self.cfg.batch_size)
            need = np.maximum(need, counts.max(axis=0))
        self.slot_floor = _round_up(need, 4)
        return tuple(int(s) for s in self.slot_floor)

    def epoch_order(self, ids: np.ndarray, slots: tuple) -> np.ndarray:
        """One epoch's graph ids → [steps, ΣS_c]: each batch's per-class
        index rows side by side, in class order."""
        bs = self.cfg.batch_size
        return np.stack([np.concatenate(route_order_rows(self.routing, ids[i:i + bs],
                                                         slots))
                         for i in range(0, len(ids), bs)]).astype(np.int32)

    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int64)
        self._test_idx = np.asarray(test_idx, dtype=np.int64)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs at the chunk's slot tuple; host rows [k, 4]."""
        epoch_ids = [self._train_idx[p] for p in perms]
        slots = self.slots_for(*epoch_ids, self._test_idx)
        orders = np.stack([self.epoch_order(ids, slots) for ids in epoch_ids])
        runner = self.runners.get((self._fold, slots), lambda: make_multi_dense_run(
            net, optimizer, self.classes, slots, self.epoch_order(self._test_idx, slots),
            orders.shape[1], dropout_gen, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.drop()


PORTED_LAYOUTS = ("dense", "multi", "block", "coo")


def make_engine(cfg: Config, dataset: GraphSet, device: torch.device, layout: str,
                graphs: bool = True):
    """The layout's engine; COO picks as the reference's `make_engine`:
    `--spmm pallas` needs host-built structures (CooEngine), otherwise
    `coo_assembly` decides. `graphs` goes to every engine."""
    if layout == "coo":
        host = cfg.resolved_spmm_impl() == "pallas" or cfg.coo_assembly == "host"
        return (CooEngine if host else DeviceCooEngine)(cfg, dataset, device, graphs)
    if layout == "block":
        return BlockSparseEngine(cfg, dataset, device, graphs)
    if layout == "multi":
        return MultiDenseEngine(cfg, dataset, device, graphs)
    return DenseEngine(cfg, dataset, device, graphs)


def _stream_seed(seed: int, fold: int, stream: int) -> int:
    state = np.random.SeedSequence([seed, fold, stream]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def chunk_epochs(cfg: Config, epoch: int) -> int:
    """Epochs k of the chunk that starts at `epoch`: k ≤ `max_fused_epochs`,
    and cut at the checkpoint cadence, so that every in-flight bundle
    falls on a chunk boundary (the reference's chunk loop,
    dgcnn_tpu/train/cv.py:1198-1207)."""
    k = cfg.num_epochs - epoch + 1
    if cfg.max_fused_epochs:
        k = min(k, cfg.max_fused_epochs)
    if cfg.checkpoint_every:
        k = min(k, cfg.checkpoint_every - (epoch - 1) % cfg.checkpoint_every)
    return k


def checkpoint_due(cfg: Config, epochs_done: int) -> bool:
    """Whether an in-flight bundle is written after `epochs_done` epochs."""
    return bool(cfg.checkpoint_every) and epochs_done % cfg.checkpoint_every == 0


def resumed_epoch(cfg: Config, inflight: str, bundle: dict, what: str) -> int:
    """The epoch a resumed `what` (fold or run) continues at; ValueError
    past `num_epochs`, the reference's refusal (:1175-1183)."""
    start = int(bundle["epoch"]) + 1
    if start > cfg.num_epochs:
        raise ValueError(
            f"--resume checkpoint {inflight!r} is at epoch {start - 1}, beyond "
            f"--num_epochs={cfg.num_epochs}: refusing to publish a {start - 1}-epoch "
            f"{what} as a {cfg.num_epochs}-epoch protocol result. Rerun with the "
            f"original --num_epochs or delete the inflight checkpoint.")
    return start


def engine_floors(engine) -> dict:
    """The engine's grow-only budget floors (its `FLOORS`: the block
    layout's nb and W, the device COO layout's bucket, the host COO
    layout's item budget, the multi-tile layout's slot tuple), for an
    in-flight bundle."""
    return {name: np.asarray(getattr(engine, name)) for name in engine.FLOORS}


def restore_floors(engine, saved: dict) -> None:
    """Set the engine's floors to an in-flight bundle's (`engine_floors`),
    so that a resumed run sizes its chunks' budgets as the uninterrupted
    run did: a budget built from the remaining chunks alone could be
    smaller, and another slot count changes the bits (the multi-tile
    trunk's backward sums over the slot axis)."""
    missing = sorted(set(engine.FLOORS) - set(saved))
    if missing:
        raise ValueError(f"the in-flight bundle holds no {missing} for the "
                         f"{type(engine).__name__}")
    for name in engine.FLOORS:
        v = np.asarray(saved[name])
        setattr(engine, name, v.astype(np.int64) if v.ndim else int(v))


class CurveRenderer:
    """The curve PNG redrawn at chunk boundaries, at most once every
    `MIN_SECONDS` (the reference's `_maybe_render_live`,
    dgcnn_tpu/train/cv.py:1114-1127). Best-effort on the host: the first
    failure (matplotlib missing, a CSV mid-write) is printed, the later
    ones are not."""

    MIN_SECONDS = 15.0

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.last: Optional[float] = None
        self.reported = False

    def maybe_render(self) -> None:
        now = time.perf_counter()
        if self.last is not None and now - self.last < self.MIN_SECONDS:
            return
        self.last = now
        try:
            from dgcnn_tpu_torch.train.plots import render_curves

            render_curves(self.cfg.statistics_dir, self.cfg.data_type)
        except Exception as e:  # plotting is best-effort observability
            if not self.reported:
                print(f"(live curve rendering skipped: {e})")
                self.reported = True


def fold_csv(cfg: Config, fold_number: int) -> str:
    return os.path.join(cfg.statistics_dir, f"{cfg.data_type}_results_{fold_number}.csv")


def fold_bundle(cfg: Config, fold_number: int) -> str:
    return os.path.join(cfg.epochs_dir, f"{cfg.data_type}_{fold_number}")


def run_fold(cfg: Config, dataset: GraphSet, model: DGCNN, fold_number: int,
             train_idx: np.ndarray, test_idx: np.ndarray, engine,
             events: EventLog, curves: Optional[CurveRenderer] = None) -> FoldMetrics:
    """One fold: fresh weights and optimizer (`FlatAdam` under
    `opt_flatten`), `cfg.num_epochs` epochs of train + eval in chunks
    (`chunk_epochs`; `engine.run_epochs`, one host round trip a chunk;
    the reference's chunk loop, dgcnn_tpu/train/cv.py:1185-1285), the
    fold's CSV flushed (and the curves redrawn by `curves`) at every chunk
    boundary and its in-flight bundle written at the checkpoint cadence,
    then its final CSV and `epochs/` bundle. Under `checkpoint_resume` a
    fold with an in-flight bundle continues from it."""
    device = engine.device
    n_train, n_test = len(train_idx), len(test_idx)
    train_edges = int(dataset.edge_counts()[np.asarray(train_idx)].sum())
    engine.begin_fold(train_idx, test_idx)

    init_gen = torch.Generator().manual_seed(_stream_seed(cfg.seed, fold_number, 1))
    net = DGCNNNet(model, init_params(init_gen, model, device))
    optimizer = make_optimizer(net, cfg.learning_rate, cfg.adam_b1,
                               cfg.adam_b2, cfg.adam_eps, flat=cfg.opt_flatten)
    dropout_gen = torch.Generator(device=device).manual_seed(
        _stream_seed(cfg.seed, fold_number, 2)
    )
    shuffle_rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, fold_number])
    )
    csv = fold_csv(cfg, fold_number)
    inflight = fold_bundle(cfg, fold_number) + "_inflight"

    metrics = FoldMetrics()
    epoch = 1
    if cfg.checkpoint_resume and checkpoint_exists(inflight):
        bundle = load_checkpoint(inflight)
        epoch = resumed_epoch(cfg, inflight, bundle, "fold")
        load_into(net, bundle["params"])
        load_into(optimizer, bundle["opt_state"])
        load_into(dropout_gen, bundle["rng"])
        restore_floors(engine, bundle.get("floors", {}))
        metrics.rows = {c: [float(v) for v in bundle["metrics"][c]]
                        for c in FoldMetrics.COLUMNS}
        # replay the shuffle stream: epoch e sees the permutation it would
        # have seen in an uninterrupted run
        for _ in range(epoch - 1):
            shuffle_rng.permutation(n_train)
        print(f"[fold {fold_number}] resumed at epoch {epoch}")

    while epoch <= cfg.num_epochs:
        k = chunk_epochs(cfg, epoch)
        perms = np.stack([shuffle_rng.permutation(n_train) for _ in range(k)])
        t0 = time.perf_counter()
        rows = engine.run_epochs(net, optimizer, dropout_gen, perms)
        dt = (time.perf_counter() - t0) / k  # amortized over the chunk
        for j in range(k):
            tr_loss, te_loss, tr_correct, te_correct = rows[j]
            train_acc = float(tr_correct) / n_train * 100.0
            test_acc = float(te_correct) / n_test * 100.0
            metrics.append(float(tr_loss), float(te_loss), train_acc, test_acc)
            events.write(
                kind="epoch",
                fold=fold_number,
                epoch=epoch + j,
                train_loss=float(tr_loss),
                test_loss=float(te_loss),
                train_accuracy=train_acc,
                test_accuracy=test_acc,
                epoch_seconds=dt,
                edges_per_second=train_edges / dt if dt > 0 else 0.0,
                chunk_epochs=k,
            )
            if cfg.log_every and (epoch + j) % cfg.log_every == 0:
                print(
                    f"[fold {fold_number}] epoch {epoch + j}: "
                    f"train {tr_loss:.4f}/{train_acc:.2f}% "
                    f"test {te_loss:.4f}/{test_acc:.2f}% ({dt:.2f}s)"
                )
        epoch += k
        if epoch <= cfg.num_epochs:
            metrics.to_csv(csv)  # the fold so far, at every chunk boundary
            if curves is not None:
                curves.maybe_render()
        if checkpoint_due(cfg, epoch - 1):
            save_checkpoint(inflight, {
                "params": net.state_dict(), "opt_state": adam_state(optimizer),
                "rng": dropout_gen.get_state(), "epoch": np.int64(epoch - 1),
                "metrics": {c: np.asarray(metrics.rows[c]) for c in FoldMetrics.COLUMNS},
                "floors": engine_floors(engine)})
    engine.end_fold()

    save_checkpoint(fold_bundle(cfg, fold_number),
                    {"params": net.state_dict(), "opt_state": adam_state(optimizer)})
    metrics.to_csv(csv)
    remove_checkpoint(inflight)
    return metrics


def _fold_bar(cfg: Config, folds):
    """The numbered folds, under a tqdm bar where tqdm is installed (the
    reference's fold bar, dgcnn_tpu/train/cv.py:1462-1472)."""
    numbered = list(enumerate(folds, start=1))
    try:
        from tqdm import tqdm
    except ImportError:
        return numbered
    return tqdm(numbered, desc=f"processing {cfg.data_type}", unit="fold")


def run_cross_validation(cfg: Config, dataset: Optional[GraphSet] = None,
                         allow_synthetic: bool = False, device=None,
                         graphs: bool = True):
    """Full experiment on `device` (default `cuda`; `"cpu"` runs the plain
    PyTorch path). Returns per-fold and aggregate accuracies, as the
    reference does. On the card every layout runs each epoch after its
    runner's first (a fold's, or a grown budget's; lockstep: the run's) as
    a CUDA-graph replay; `graphs=False` runs them eagerly, for comparison
    only. Under `checkpoint_resume` complete folds are skipped and the
    others continue from their in-flight bundles (the reference's
    :1409-1443, :1483-1491)."""
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
    if cfg.cv_parallel == "folds":
        check_lockstep_layout(layout)
    if layout not in PORTED_LAYOUTS:
        raise NotImplementedError(
            f"the {layout!r} layout (chosen for {cfg.data_type}) is not ported "
            f"yet ({_LAYOUT_ITEM[layout]}); the port runs the dense, multi, "
            f"block and coo layouts"
        )
    use_lockstep = lockstep_engages(cfg, dataset, layout)

    fold_dir = cfg.fold_index_dir or os.path.join(
        cfg.data_root, cfg.data_type, "10fold_idx"
    )
    folds = get_folds(
        dataset.y, fold_dir, cfg.num_folds, cfg.seed, data_type=cfg.data_type
    )
    engine = make_engine(cfg, dataset, device, layout, graphs)
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
        **({"spmm_impl": cfg.resolved_spmm_impl()} if layout == "coo" else {}),
        **({"tiles": list(engine.tiles), "slot_floors": engine.slot_floor.tolist()}
           if layout == "multi" else {}),
        num_params=num_params(init_params(torch.Generator().manual_seed(0), model)),
        device=str(device),
    )
    if use_lockstep and cfg.checkpoint_resume:
        # lockstep writes the fold CSVs at run end: every fold is complete
        # or none is, unless an earlier run was sequential
        done = [completed_fold_accuracies(fold_csv(cfg, f), cfg.num_epochs)
                for f in range(1, len(folds) + 1)]
        if all(d is not None for d in done):
            for f, d in enumerate(done, start=1):
                print(f"[fold {f}] resumed (complete): test {d[1]:.2f}%")
            return _finalize_cv(cfg, events, [d[0] for d in done], [d[1] for d in done])
        if cfg.cv_parallel != "folds" and any(d is not None for d in done):
            # lockstep would retrain the complete folds too: redo only the
            # missing ones, one after another (cv_parallel="folds" keeps
            # lockstep: its folds cannot pause one by one)
            print("[resume] partial run under auto-lockstep: redoing only the "
                  "incomplete folds sequentially")
            use_lockstep = False
    if use_lockstep:
        from dgcnn_tpu_torch.train.cv_vmap import run_cv_folds_lockstep

        train_accs, test_accs = run_cv_folds_lockstep(
            cfg, dataset, model, folds, events, engine)
        return _finalize_cv(cfg, events, train_accs, test_accs)

    curves = CurveRenderer(cfg)
    # the engine's floors after the last complete fold, which a fold begun
    # fresh after a resume starts from, as it would have without the crash
    floors = os.path.join(cfg.epochs_dir, f"{cfg.data_type}_floors")
    skipped = False
    train_accs, test_accs = [], []
    bar = _fold_bar(cfg, folds)
    for fold_number, (train_idx, test_idx) in bar:
        if cfg.checkpoint_resume and checkpoint_exists(fold_bundle(cfg, fold_number)):
            done = completed_fold_accuracies(fold_csv(cfg, fold_number), cfg.num_epochs)
            if done is not None:
                train_accs.append(done[0])
                test_accs.append(done[1])
                print(f"[fold {fold_number}] resumed (complete): test {done[1]:.2f}%")
                skipped = True
                continue
        if skipped and checkpoint_exists(floors):
            restore_floors(engine, load_checkpoint(floors)["floors"])
        skipped = False
        t0 = time.perf_counter()
        metrics = run_fold(cfg, dataset, model, fold_number, train_idx,
                           test_idx, engine, events, curves)
        dt = time.perf_counter() - t0
        if engine.FLOORS:
            save_checkpoint(floors, {"floors": engine_floors(engine)})
        train_accs.append(metrics.last("train_accuracy"))
        test_accs.append(metrics.last("test_accuracy"))
        print(
            f"[{fold_number}] Train Acc: {train_accs[-1]:.2f}% "
            f"Test Acc: {test_accs[-1]:.2f}% ({dt:.1f}s)"
        )
        if hasattr(bar, "set_postfix"):
            bar.set_postfix(test_acc=f"{test_accs[-1]:.2f}%")
    remove_checkpoint(floors)
    return _finalize_cv(cfg, events, train_accs, test_accs)


def _finalize_cv(cfg: Config, events: EventLog, train_accs, test_accs):
    """The run tail, the same for both drivers (the reference's
    :1508-1528): overall CSV, the curve PNG, the TensorBoard export (both
    best-effort on the host), summary line and run_end event."""
    write_overall_csv(
        os.path.join(cfg.statistics_dir, f"{cfg.data_type}_results_overall.csv"),
        train_accs,
        test_accs,
    )
    try:  # the visdom replacement's curves (reference train.py:122-125)
        from dgcnn_tpu_torch.train.plots import render_curves

        render_curves(cfg.statistics_dir, cfg.data_type)
    except Exception as e:  # plotting is best-effort observability
        print(f"(curve rendering skipped: {e})")
    if cfg.tensorboard_dir and events.path:
        try:
            from dgcnn_tpu_torch.train.tensorboard import export_events

            export_events(events.path, cfg.tensorboard_dir)
        except Exception as e:  # so is the TensorBoard export
            print(f"(tensorboard export skipped: {e})")
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
