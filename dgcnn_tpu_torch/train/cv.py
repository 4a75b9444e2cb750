"""Cross-validation driver — the port of dgcnn_tpu/train/cv.py
(`choose_layout` :141, `CooEngine` :249, `DeviceCooEngine` :339,
`_geom_round` :373, `BlockSparseEngine` :434, `DenseEngine` :521,
`MultiDenseEngine` :583, `MeshHaloEngine` :720, the
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

The port serves the dense, multi-tile dense, block-sparse, COO and
halo layouts. The folds train in lockstep (train/cv_vmap.py, over the
layout's engine) where the reference would lockstep them
(`lockstep_engages`): under `cv_parallel="folds"` on the dense, block
and multi-tile layouts; under "auto" on the dense layout when
`_lockstep_would_engage`, always on the block layout, and on the
multi-tile layout over a (D, 1) grid of D > 1 (on one device the
reference runs multi-tile folds one after another). Otherwise, and on
the COO and halo layouts, the folds run one after another.
`choose_layout` answers as the reference does (it never picks halo). On
a mesh (`mesh_shape` ≠ (1, 1); the reference's :675-1037, :1067-1090)
every process is one rank of the (data, graph) grid (parallel/mesh.py):
in lockstep, each rank of a (D, 1) grid trains its block of the folds on
the layout's single-device engine (fold-sharded lockstep,
train/cv_vmap.py); otherwise the folds run one after another through the
layout's mesh engine (`MeshDenseEngine`, `MeshBlockEngine`,
`MeshDeviceCooEngine`, `MeshCooEngine`, `MeshHaloEngine`): under `nccl`
on the card each epoch after a runner's first is a CUDA-graph replay,
under `gloo` every epoch runs eagerly. Rank 0 alone writes the files. Each engine stores its data at the
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
    order_matrix_dp,
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
    map_batch,
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
from dgcnn_tpu_torch.batching.shard_pack import halo_bucket, pack_epoch_halo
from dgcnn_tpu_torch.parallel.halo import grad_groups as halo_grad_groups
from dgcnn_tpu_torch.parallel.halo import halo_steps, make_halo_loss
from dgcnn_tpu_torch.parallel.mesh import make_mesh, sum_over
from dgcnn_tpu_torch.parallel.shard import (
    epoch_rows, local_view, pack_epoch_dp, shard_bucket,
)
from dgcnn_tpu_torch.parallel.train_dp import (
    local_steps, make_block_dp_run, make_dense_dp_run, make_device_coo_dp_run,
    make_local_coo_loss, make_staged_dp_run,
)
from dgcnn_tpu_torch.train.loop import (
    _arrival_counters,
    make_block_run,
    make_coo_run,
    make_dense_gather_run,
    make_device_coo_run,
    make_multi_dense_run,
    make_optimizer,
)
from dgcnn_tpu_torch.train.metrics import (
    SPANS, EventLog, FoldMetrics, completed_fold_accuracies, spanned, write_overall_csv,
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


def on_mesh(cfg: Config) -> bool:
    return tuple(cfg.mesh_shape) != (1, 1)


def pool_dtype(cfg: Config) -> str:
    """The block pool's storage dtype, the reference's rule
    (dgcnn_tpu/train/cv.py:457-469): the compute dtype when it is not
    float32, else the resolved adjacency dtype."""
    return cfg.compute_dtype if cfg.compute_dtype != "float32" else cfg.resolved_adj_dtype()


LOCKSTEP_LAYOUTS = ("dense", "block", "multi")


def check_lockstep_request(cfg: Config, layout: str) -> None:
    """`cv_parallel="folds"` where lockstep cannot run: on a layout it
    never runs on (coo, halo), or over a grid that is not (D, 1) — the
    reference's ValueError (dgcnn_tpu/train/cv.py:1361-1382)."""
    problems = []
    if layout not in LOCKSTEP_LAYOUTS:
        problems.append(
            f"layout={layout!r} (lockstep runs on the dense, block-sparse or "
            f"multi-tile layout; this dataset resolved to {layout!r})")
    if fold_shard_devices(cfg.mesh_shape, cfg.num_folds) is None:
        problems.append(
            f"mesh_shape={tuple(cfg.mesh_shape)} (fold-sharded lockstep needs a "
            f"(D, 1) mesh; D ∤ num_folds is fine)")
    if problems:
        raise ValueError("cv_parallel='folds' is incompatible with: " + "; ".join(problems))


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
    budget grows. `builds` counts the runners built: the drivers mark the
    `epoch` events of a chunk that built one (`runner_built`), whose
    seconds hold the warm-up and the capture. Spans (train/metrics.py
    `SPANS`): `runner.build` around `make()`, `fold.end` around the drop
    at a fold's end (`end_fold`)."""

    def __init__(self):
        self.key = self.runner = None
        self.builds = 0

    def get(self, key, make):
        if self.runner is None or key != self.key:
            self.drop()
            with SPANS.span("runner.build") as s:
                s["key"] = str(key)
                self.runner, self.key = make(), key
            self.builds += 1
        return self.runner

    def drop(self) -> None:
        """Release the runner: its graph holds the addresses of the fold's
        net and optimizer."""
        self.key = self.runner = None

    def end_fold(self) -> None:
        """An engine's fold end: the drop, and in its span the bytes the
        card's allocator holds after it (an allocator count: no sync)."""
        with SPANS.span("fold.end") as s:
            self.drop()
            if s.kept and torch.cuda.is_initialized():
                s["allocated"] = torch.cuda.memory_allocated()


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


    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs; host rows [k, 4]."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                            self.slots) for perm in perms])
        runner = self.runners.get(self._fold, lambda: make_dense_gather_run(
            net, optimizer, self.data, self._test_np, orders.shape[1], dropout_gen,
            self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.end_fold()


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

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs at the chunk's budgets; host rows [k, 4]."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                            self.slots) for perm in perms])
            nb, w = self.budget_for(orders, self._test_np)
        runner = self.runners.get((self._fold, nb, w), lambda: make_block_run(
            net, optimizer, self.dev, self._test_np, nb, w, orders.shape[1],
            dropout_gen, self.block_impl, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.end_fold()


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

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int32)
        self._test_np = order_matrix(test_idx, self.cfg.batch_size, self.slots)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs in the chunk's bucket; host rows [k, 4]."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            orders = np.stack([order_matrix(self._train_idx[perm], self.cfg.batch_size,
                                            self.slots) for perm in perms])
            bucket = self.bucket_for(orders, self._test_np)
        runner = self.runners.get((self._fold, bucket), lambda: make_device_coo_run(
            net, optimizer, self.dev, self._test_np, bucket, orders.shape[1],
            dropout_gen, self.spmm_impl, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.end_fold()


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
        packing and of `add_blockcoo` (`pack_seconds`), each an
        `engine.orders` span of `stage` "pack" or "blockcoo"."""
        backend = resolve_backend("auto")
        with SPANS.span("engine.orders", timed=True) as s:
            s["stage"] = "pack"
            epoch = pack_epoch(ds, order, self.cfg.batch_size, self.bucket, backend)
        self.packed[backend] += 1
        self.pack_seconds["pack"] += s.seconds
        if self.spmm_impl != "pallas":
            return epoch
        with SPANS.span("engine.orders", timed=True) as s:
            s["stage"] = "blockcoo"
            epoch = add_blockcoo(epoch)
        self.pack_seconds["blockcoo"] += s.seconds
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

    @spanned("fold.begin")
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
            with SPANS.span("engine.orders") as s:
                s["stage"] = "pin"
                s["epochs"] = len(sub)
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
        self.runners.end_fold()


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

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int64)
        self._test_idx = np.asarray(test_idx, dtype=np.int64)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs at the chunk's slot tuple; host rows [k, 4]."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            epoch_ids = [self._train_idx[p] for p in perms]
            slots = self.slots_for(*epoch_ids, self._test_idx)
            orders = np.stack([self.epoch_order(ids, slots) for ids in epoch_ids])
        runner = self.runners.get((self._fold, slots), lambda: make_multi_dense_run(
            net, optimizer, self.classes, slots, self.epoch_order(self._test_idx, slots),
            orders.shape[1], dropout_gen, self.graphs))
        return runner.run_epochs(orders)

    def end_fold(self) -> None:
        self.runners.end_fold()


class _MeshEngine:
    """What the five mesh engines share (the reference's
    dgcnn_tpu/train/cv.py:675-1037): the rank's `grid` (parallel/mesh.py),
    its device, `slots = max(1, ⌈batch/D⌉)` graph slots a sub-batch (not
    rounded to `graph_pad_multiple`, as in the reference), and one runner
    a fold, dropped at the fold's end or when a budget grows: a fused
    runner of `dp_epoch_body` (parallel/train_dp.py). Under `nccl` on the
    card (`grid.graphed`) the fold's first epoch warms up and every later
    one is a CUDA-graph replay; under `gloo` every epoch runs the body
    eagerly (a gloo collective cannot be captured). `graphs=False` runs
    every epoch eagerly under `nccl` too, for comparison only."""

    FLOORS = ()

    def __init__(self, cfg: Config, grid, graphs: bool = True):
        self.cfg = cfg
        self.grid = grid
        self.device = grid.device
        self.graphs = graphs
        self.slots = max(1, -(-cfg.batch_size // grid.n_data))
        self.runners = RunnerSlot()
        self._fold = 0

    @property
    def graphed(self) -> bool:
        """Whether this engine's epochs after a runner's first are graph
        replays."""
        return self.graphs and self.grid.graphed

    @property
    def dropout_rank(self) -> int:
        """The index the rank's dropout stream folds in: its data rank (the
        graph ranks of one data group draw the same masks)."""
        return self.grid.d

    @property
    def dropout_ranks(self) -> int:
        """How many distinct dropout streams the grid runs."""
        return self.grid.n_data

    def end_fold(self) -> None:
        self.runners.end_fold()


class _MeshGatherEngine(_MeshEngine):
    """A mesh engine whose dataset lives replicated on every rank's device
    and whose batches are gathered there from a [steps, n_data, slots]
    order: each global batch is dealt to the data ranks by `epoch_order`."""

    def epoch_order(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_idx = np.asarray(train_idx, dtype=np.int64)
        self._test_np = self.epoch_order(np.asarray(test_idx, dtype=np.int64))
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Train + eval one epoch per permutation of the fold's training
        graphs; host rows [k, 4], the same on every rank."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            orders = np.stack([self.epoch_order(self._train_idx[p]) for p in perms])
            key, make = self.runner_for(orders, net, optimizer, dropout_gen,
                                        steps=orders.shape[1], graphs=self.graphs)
        return self.runners.get((self._fold, key), make).run_epochs(orders)


class MeshDenseEngine(_MeshGatherEngine):
    """The dense layout on the grid (the reference's `MeshDenseEngine`,
    :868): the dense dataset replicated on every rank's device, each
    global batch dealt round-robin to the data ranks (`order_matrix_dp`),
    each data rank's sub-batch through the trunk kernel at `slots` slots;
    the graph axis replicates the computation."""

    def __init__(self, cfg: Config, dataset: GraphSet, grid, graphs: bool = True):
        super().__init__(cfg, grid, graphs)
        self.n_tile = dense_tile(dataset)
        self.data = build_dense_dataset(dataset, self.n_tile, self.device,
                                        cfg.resolved_adj_dtype(), cfg.compute_dtype)

    def epoch_order(self, ids: np.ndarray) -> np.ndarray:
        return order_matrix_dp(ids, self.cfg.batch_size, self.grid.n_data, self.slots)

    def runner_for(self, orders, net, optimizer, dropout_gen, **run_kw):
        return None, lambda: make_dense_dp_run(net, optimizer, self.data, self.grid,
                                               self._test_np, dropout_gen, **run_kw)


class MeshBlockEngine(_MeshGatherEngine):
    """The block-sparse layout on the grid (the reference's
    `MeshBlockEngine`, :936): the block graphset replicated, each global
    batch LPT-balanced over the data ranks on stored-block counts (the
    propagation's work), each sub-batch through the block kernel
    `block_impl` names; the budgets (nb, W) sized once a chunk over every
    rank's sub-batch rows, grown only on the block engine's geometric
    grid; the graph axis replicates the computation."""

    FLOORS = ("floor_nb", "floor_w")

    def __init__(self, cfg: Config, dataset: GraphSet, grid, graphs: bool = True):
        super().__init__(cfg, grid, graphs)
        host = build_block_graphset(dataset)
        self._nb = host.nb.astype(np.int64)
        self._block_counts = host.block_count.astype(np.int64)
        self.dev = block_graphset_to_device(host, self.device, pool_dtype(cfg))
        self.block_impl = cfg.resolved_block_impl()
        self.floor_nb = 8
        self.floor_w = 64

    def epoch_order(self, ids: np.ndarray) -> np.ndarray:
        return epoch_rows(self._block_counts, ids, self.cfg.batch_size,
                          self.grid.n_data, self.slots)

    def budget_for(self, *order_mats: np.ndarray):
        nb = w = 1
        for m in order_mats:  # last axis = slots: every rank's sub-batch row
            bn, bw = block_batch_extents(self._nb, self._block_counts, m)
            nb, w = max(nb, bn), max(w, bw)
        self.floor_nb = max(self.floor_nb, _geom_round(nb, 8))
        self.floor_w = max(self.floor_w, _geom_round(w, 64))
        return self.floor_nb, self.floor_w

    def runner_for(self, orders, net, optimizer, dropout_gen, **run_kw):
        nb, w = self.budget_for(orders, self._test_np)
        return (nb, w), lambda: make_block_dp_run(
            net, optimizer, self.dev, self.grid, nb, w, self._test_np, dropout_gen,
            self.block_impl, **run_kw)


class MeshDeviceCooEngine(_MeshGatherEngine):
    """The COO layout assembled on the device, on the grid (the
    reference's `MeshDeviceCooEngine`, :772): the COO graphset replicated,
    each global batch LPT-balanced over the data ranks on node counts,
    each graph rank assembling only its contiguous chunk of its data
    rank's edge stream (`gather_coo_batch(edge_window=...)`), aggregated
    by the SpMM kernel `spmm_impl` names and summed over the graph group.
    The bucket is sized once a chunk, grown only, its edges a multiple of
    `edge_pad_multiple · G` so that the chunks are equal."""

    FLOORS = ("floor_nodes", "floor_edges")

    def __init__(self, cfg: Config, dataset: GraphSet, grid, graphs: bool = True):
        super().__init__(cfg, grid, graphs)
        self._node_counts = dataset.node_counts().astype(np.int64)
        self._edge_counts = dataset.edge_counts().astype(np.int64)
        self.dev = device_graphset_to(build_device_graphset(dataset), self.device)
        self.spmm_impl = cfg.resolved_spmm_impl()
        self.edge_multiple = cfg.edge_pad_multiple * grid.n_graph
        self.floor_nodes = cfg.node_pad_multiple
        self.floor_edges = self.edge_multiple

    def epoch_order(self, ids: np.ndarray) -> np.ndarray:
        return epoch_rows(self._node_counts, ids, self.cfg.batch_size,
                          self.grid.n_data, self.slots)

    def bucket_for(self, *order_mats: np.ndarray) -> BucketSpec:
        n = e = 1
        for m in order_mats:
            bn, be = batch_extents(self._node_counts, self._edge_counts, m)
            n, e = max(n, bn), max(e, be)
        self.floor_nodes = max(self.floor_nodes,
                               _geom_round(n, self.cfg.node_pad_multiple))
        self.floor_edges = max(self.floor_edges, _geom_round(e, self.edge_multiple))
        return BucketSpec(num_nodes=self.floor_nodes, num_edges=self.floor_edges,
                          num_graphs=self.slots)

    def runner_for(self, orders, net, optimizer, dropout_gen, **run_kw):
        bucket = self.bucket_for(orders, self._test_np)
        return bucket, lambda: make_device_coo_dp_run(
            net, optimizer, self.dev, self.grid, bucket, self._test_np, dropout_gen,
            self.spmm_impl, **run_kw)


class MeshCooEngine(_MeshEngine):
    """The COO layout packed on the host, on the grid (the reference's
    `MeshCooEngine`, :675): every epoch packed by `pack_epoch_dp` into the
    worst-case per-shard bucket (`shard_bucket`: LPT-balanced sub-batches,
    edge leaves cut over the graph axis); each rank ships only its own
    selection (`local_view`), one transfer per array an epoch; the fold's
    test epoch is packed and shipped once. No block-COO structures are
    attached: the SpMM runs the edge-stream kernel `spmm_impl` names (the
    row kernel for "pallas"). The fold's fused runner
    (`make_staged_dp_run`) stages each epoch's share from host memory
    (page-locked on the card) into one static device epoch of the
    bucket's shapes."""

    def __init__(self, cfg: Config, dataset: GraphSet, grid, graphs: bool = True):
        super().__init__(cfg, grid, graphs)
        self.dataset = dataset
        self.bucket = shard_bucket(dataset, cfg.batch_size, grid.n_data,
                                   cfg.node_pad_multiple, cfg.edge_pad_multiple,
                                   cfg.graph_pad_multiple, grid.n_graph)
        self.spmm_impl = cfg.resolved_spmm_impl()
        self._staged = []  # the chunk's packed epochs on the host

    def pack(self, ds: GraphSet, order: np.ndarray):
        return pack_epoch_dp(ds, order, self.cfg.batch_size, self.bucket,
                             self.grid.n_data, self.grid.n_graph)

    def host_epoch(self, perm: np.ndarray):
        """This rank's share of the fold's training epoch `perm` on the host,
        page-locked on the card: [steps, ...] leaves."""
        grid = self.grid
        local = local_view(self.pack(self._train_set, perm), grid.d, grid.g,
                           grid.n_data, grid.n_graph, steps=True)
        return pin_batch(local) if self.device.type == "cuda" else batch_to_device(
            local, "cpu")

    @staticmethod
    def map_leaves(batch, fn):
        return map_batch(batch, fn)

    def losses(self):
        """The fold's (train loss, eval loss) of one local step, and the
        groups a gradient is summed over (None: the data group)."""
        return (make_local_coo_loss(self.grid, self.spmm_impl, False),
                make_local_coo_loss(self.grid, self.spmm_impl, True), None)

    def onehot_nodes(self) -> int:
        """The node rows the edge-block kernel's counters cover."""
        return self.bucket.num_nodes

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_set = self.dataset.subset(train_idx)
        test_set = self.dataset.subset(test_idx)
        self._test_steps = local_steps(self.pack(test_set, np.arange(test_set.num_graphs)),
                                       self.grid, self.device)
        self._fold += 1

    def run_epochs(self, net, optimizer, dropout_gen, perms) -> np.ndarray:
        """Pack, stage, train and evaluate one epoch per permutation of the
        fold's training graphs; host rows [k, 4], the same on every rank."""
        with SPANS.span("engine.orders") as s:
            s["epochs"] = len(perms)
            self._staged = [self.host_epoch(p) for p in perms]
            bs = self.cfg.batch_size
            orders = np.stack([order_matrix(p, bs, bs) for p in perms])
        runner = self.runners.get(self._fold, lambda: self._staged_runner(
            net, optimizer, dropout_gen, orders.shape[1:]))
        return runner.run_epochs(orders)

    def _staged_runner(self, net, optimizer, dropout_gen, order_shape):
        """The fold's fused runner over a static device epoch of the first
        staged epoch's shapes (the bucket's: every epoch of the fold has
        them)."""
        def leaves(batch) -> list:
            out = []
            self.map_leaves(batch, out.append)
            return out

        stack = self.map_leaves(self._staged[0], lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=self.device))
        steps = [self.map_leaves(stack, lambda a, s=s: a[s])
                 for s in range(stack.y.shape[0])]
        dst = leaves(stack)

        def stage(j):
            for d, src in zip(dst, leaves(self._staged[j])):
                d.copy_(src, non_blocking=True)

        train_loss, eval_loss, groups = self.losses()
        held = _arrival_counters(self.device, nodes=self.onehot_nodes()
                                 if self.spmm_impl == "onehot" else 0)
        return make_staged_dp_run(net, optimizer, train_loss, eval_loss, steps,
                                  self._test_steps, stage, order_shape, dropout_gen,
                                  self.grid, groups, self.graphs, held)


class MeshHaloEngine(MeshCooEngine):
    """The halo layout on the grid (the reference's `MeshHaloEngine`,
    :720): each sub-batch's packed node axis SHARDED over the graph ranks
    (batching/shard_pack.py), each GCN layer exchanging H boundary rows
    with the two neighbouring shards (parallel/halo.py) instead of
    replicating the node block. Every epoch is packed on the host into the
    worst-case `halo_bucket`, each rank packing only its own sub-batch and
    keeping its own shard, and staged as `MeshCooEngine`'s; the fold's test epoch is packed and shipped once.
    The gradients are summed over all D·G ranks, and dropout folds in the
    rank (d·G + g), as the reference's `fold_in(rng, g + G·d)`."""

    def __init__(self, cfg: Config, dataset: GraphSet, grid, graphs: bool = True):
        _MeshEngine.__init__(self, cfg, grid, graphs)
        self.dataset = dataset
        self.bucket = halo_bucket(dataset, cfg.batch_size, grid.n_data, grid.n_graph,
                                  cfg.node_pad_multiple, cfg.edge_pad_multiple,
                                  cfg.graph_pad_multiple)
        self.spmm_impl = cfg.resolved_spmm_impl()
        self._staged = []

    @property
    def dropout_rank(self) -> int:
        return self.grid.rank

    @property
    def dropout_ranks(self) -> int:
        return self.grid.n_data * self.grid.n_graph

    def pack_host(self, ds: GraphSet, order: np.ndarray):
        """This rank's shard of the epoch `order` of `ds`, on the host."""
        grid = self.grid
        return pack_epoch_halo(ds, order, self.cfg.batch_size, grid.n_data, grid.n_graph,
                               self.bucket, rank=(grid.d, grid.g))

    def pack(self, ds: GraphSet, order: np.ndarray):
        """This rank's steps of the epoch `order` of `ds`, on its device."""
        return halo_steps(self.pack_host(ds, order), self.device)

    def host_epoch(self, perm: np.ndarray):
        cuda = self.device.type == "cuda"
        return self.pack_host(self._train_set, perm).map(
            lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory() if cuda
            else torch.from_numpy(a))

    @staticmethod
    def map_leaves(batch, fn):
        return batch.map(fn)

    def losses(self):
        return (make_halo_loss(self.grid, self.spmm_impl, False),
                make_halo_loss(self.grid, self.spmm_impl, True), halo_grad_groups(self.grid))

    def onehot_nodes(self) -> int:
        return self.bucket.shard_nodes + 2 * self.bucket.halo

    @spanned("fold.begin")
    def begin_fold(self, train_idx: np.ndarray, test_idx: np.ndarray) -> None:
        self._train_set = self.dataset.subset(train_idx)
        test_set = self.dataset.subset(test_idx)
        self._test_steps = self.pack(test_set, np.arange(test_set.num_graphs))
        self._fold += 1


MESH_ENGINES = (MeshDenseEngine, MeshBlockEngine, MeshDeviceCooEngine, MeshCooEngine,
                MeshHaloEngine)


def make_engine(cfg: Config, dataset: GraphSet, device: torch.device, layout: str,
                graphs: bool = True, grid=None, lockstep: bool = False):
    """The layout's engine; COO picks as the reference's `make_engine`:
    `--spmm pallas` needs host-built structures (CooEngine), otherwise
    `coo_assembly` decides. `graphs` goes to every single-device engine.
    On a mesh (`mesh_shape` ≠ (1, 1)) the reference's mesh branch
    (:1067-1090): the mesh engine of the layout over `grid` (made here
    when None), the COO one by `coo_assembly` alone; the multi-tile layout
    is single-device only (ValueError), and the halo layout needs a mesh
    (ValueError). Under fold-sharded `lockstep` each rank of a (D, 1) grid
    runs its folds on the layout's single-device engine, on its device.
    The engine's construction (its data on the device, routing, floors) is
    the span `engine.build`."""
    if layout == "halo" and not on_mesh(cfg):
        raise ValueError(
            "layout='halo' shards the node axis over the mesh 'graph' "
            "axis — pass --mesh D,G with G>1 (or D·G>1); on one device "
            "use layout='coo'")
    if on_mesh(cfg) and lockstep:
        device = (grid if grid is not None else make_mesh(cfg.mesh_shape, device)).device
    elif on_mesh(cfg):
        if layout == "multi":
            raise ValueError(
                f"layout={layout!r} is single-chip only; use layout='dense', "
                "'block', 'halo' or 'coo' (or 'auto') with a mesh")
        if grid is None:
            grid = make_mesh(cfg.mesh_shape, device)
        cls = {"dense": MeshDenseEngine, "block": MeshBlockEngine,
               "halo": MeshHaloEngine}.get(layout)
        if cls is None:
            cls = MeshDeviceCooEngine if cfg.coo_assembly == "device" else MeshCooEngine
        with SPANS.span("engine.build") as s:
            s["layout"] = layout
            return cls(cfg, dataset, grid, graphs)
    if layout == "coo":
        host = cfg.resolved_spmm_impl() == "pallas" or cfg.coo_assembly == "host"
        cls = CooEngine if host else DeviceCooEngine
    else:
        cls = {"block": BlockSparseEngine, "multi": MultiDenseEngine}.get(layout, DenseEngine)
    with SPANS.span("engine.build") as s:
        s["layout"] = layout
        return cls(cfg, dataset, device, graphs)


def _stream_seed(seed: int, fold: int, stream: int, *more: int) -> int:
    state = np.random.SeedSequence([seed, fold, stream, *more]).generate_state(2)
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


def dropout_states(dropout_gen: torch.Generator, engine=None) -> torch.Tensor:
    """The dropout generator's state for an in-flight bundle; on a mesh
    engine one row per dropout stream, [engine.dropout_ranks, ·] (the data
    ranks; on the halo layout every rank), each rank's own row summed over
    the grid's groups (every rank calls this), since rank 0 writes the
    bundle and each rank resumes from its own row."""
    state = dropout_gen.get_state()
    grid = getattr(engine, "grid", None)
    if grid is None:
        return state
    rows = torch.zeros((engine.dropout_ranks, state.numel()), dtype=torch.int32,
                       device=grid.device)
    rows[engine.dropout_rank] = state.to(device=grid.device, dtype=torch.int32)
    sum_over(rows, grid.data_group)
    if engine.dropout_ranks > grid.n_data:
        sum_over(rows, grid.graph_group)
    return rows.cpu().to(torch.uint8)


def runner_seconds(runner, built: bool) -> dict:
    """An `epoch` event's `warmup_seconds` and `capture_seconds`: those of
    the runner a chunk built (null for a chunk that built none, and for a
    runner that ran eagerly)."""
    return {key: getattr(runner, key, None) if built else None
            for key in ("warmup_seconds", "capture_seconds")}


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
    fold with an in-flight bundle continues from it.

    On a mesh engine (`engine.grid`) every rank trains the same replica:
    the same weights and shuffle, dropout seeded by the data rank as well
    (the graph ranks of one data group draw the same masks), and rank 0
    alone writes the files, which every rank reads on a resume; at the
    fold's end the ranks' parameters must be bitwise equal
    (`ProcessGrid.check_replicas`), or the fold raises.

    Each chunk's `epoch` events carry its amortized seconds, whether it
    built a runner (`runner_built`) and, if so, the runner's warm-up and
    capture seconds (`warmup_seconds`, `capture_seconds`: its
    `runner.warmup` and `runner.capture` spans; null when it ran
    eagerly)."""
    device = engine.device
    grid = getattr(engine, "grid", None)
    writer = grid is None or grid.writer
    n_train, n_test = len(train_idx), len(test_idx)
    train_edges = int(dataset.edge_counts()[np.asarray(train_idx)].sum())
    engine.begin_fold(train_idx, test_idx)

    init_gen = torch.Generator().manual_seed(_stream_seed(cfg.seed, fold_number, 1))
    net = DGCNNNet(model, init_params(init_gen, model, device))
    optimizer = make_optimizer(net, cfg.learning_rate, cfg.adam_b1,
                               cfg.adam_b2, cfg.adam_eps, flat=cfg.opt_flatten)
    dropout_gen = torch.Generator(device=device).manual_seed(
        _stream_seed(cfg.seed, fold_number, 2,
                     *(() if grid is None else (engine.dropout_rank,)))
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
        load_into(dropout_gen,
                  bundle["rng"] if grid is None else bundle["rng"][engine.dropout_rank])
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
        builds = engine.runners.builds
        rows = engine.run_epochs(net, optimizer, dropout_gen, perms)
        dt = (time.perf_counter() - t0) / k  # amortized over the chunk
        built = engine.runners.builds != builds
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
                runner_built=built,
                **runner_seconds(engine.runners.runner, built),
            )
            if cfg.log_every and (epoch + j) % cfg.log_every == 0:
                print(
                    f"[fold {fold_number}] epoch {epoch + j}: "
                    f"train {tr_loss:.4f}/{train_acc:.2f}% "
                    f"test {te_loss:.4f}/{test_acc:.2f}% ({dt:.2f}s)"
                )
        epoch += k
        if epoch <= cfg.num_epochs and writer:
            metrics.to_csv(csv)  # the fold so far, at every chunk boundary
            if curves is not None:
                curves.maybe_render()
        if checkpoint_due(cfg, epoch - 1):
            rng = dropout_states(dropout_gen, engine)  # a collective on a mesh
        if checkpoint_due(cfg, epoch - 1) and writer:
            save_checkpoint(inflight, {
                "params": net.state_dict(), "opt_state": adam_state(optimizer),
                "rng": rng, "epoch": np.int64(epoch - 1),
                "metrics": {c: np.asarray(metrics.rows[c]) for c in FoldMetrics.COLUMNS},
                "floors": engine_floors(engine)})
    engine.end_fold()
    if grid is not None:
        grid.check_replicas(net.parameters(), f"fold {fold_number}'s parameters")

    if writer:
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
                         graphs: bool = True, grid=None):
    """Full experiment on `device` (default `cuda`; `"cpu"` runs the plain
    PyTorch path). Returns per-fold and aggregate accuracies, as the
    reference does. On the card every layout runs each epoch after its
    runner's first (a fold's, or a grown budget's; lockstep: the run's) as
    a CUDA-graph replay; `graphs=False` runs them eagerly, for comparison
    only. Under `checkpoint_resume` complete folds are skipped and the
    others continue from their in-flight bundles (the reference's
    :1409-1443, :1483-1491).

    With `mesh_shape` ≠ (1, 1) this process is one rank of the (data,
    graph) grid: `grid`, or `make_mesh(cfg.mesh_shape, device)` over the
    initialised process group (parallel/mesh.py; `device` None means
    `cuda:LOCAL_RANK`). Every rank runs this function; the folds run one
    after another through the layout's mesh engine, graphed under `nccl`
    on the card and eagerly under `gloo` (`run_start`'s `graphs` says
    which), and rank 0 alone writes the CSVs, the event log and the
    `epochs/` bundles. A resume waits for every rank (a
    barrier), then each reads rank 0's files."""
    mesh = on_mesh(cfg)
    if not mesh:
        device = resolve_device(device)
    fp32_only()
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
    use_lockstep = lockstep_engages(cfg, dataset, layout)
    if cfg.cv_parallel == "folds":
        check_lockstep_request(cfg, layout)
    if mesh:
        grid = grid if grid is not None else make_mesh(cfg.mesh_shape, device)
        device = grid.device
    writer = grid is None or grid.writer

    fold_dir = cfg.fold_index_dir or os.path.join(
        cfg.data_root, cfg.data_type, "10fold_idx"
    )
    folds = get_folds(
        dataset.y, fold_dir, cfg.num_folds, cfg.seed, data_type=cfg.data_type
    )
    if mesh and cfg.checkpoint_resume:
        grid.barrier()  # every rank reads rank 0's files as they stand
    done = None
    if use_lockstep and cfg.checkpoint_resume:
        # lockstep writes the fold CSVs at run end: every fold is complete
        # or none is, unless an earlier run was sequential
        done = [completed_fold_accuracies(fold_csv(cfg, f), cfg.num_epochs)
                for f in range(1, len(folds) + 1)]
        if (cfg.cv_parallel != "folds" and any(d is not None for d in done)
                and not all(d is not None for d in done)):
            # lockstep would retrain the complete folds too: redo only the
            # missing ones, one after another (cv_parallel="folds" keeps
            # lockstep: its folds cannot pause one by one)
            print("[resume] partial run under auto-lockstep: redoing only the "
                  "incomplete folds sequentially")
            use_lockstep = False
    engine = make_engine(cfg, dataset, device, layout, graphs, grid, use_lockstep)
    events = EventLog(
        os.path.join(cfg.statistics_dir, f"{cfg.data_type}_events.jsonl")
        if writer else None
    )
    events.write(
        kind="run_start",
        data_type=cfg.data_type,
        num_graphs=dataset.num_graphs,
        num_features=dataset.num_features,
        num_classes=dataset.num_classes,
        layout=layout,
        cv_parallel="folds" if use_lockstep else "sequential",
        **({"block_impl": cfg.resolved_block_impl()} if layout == "block" else {}),
        **({"spmm_impl": cfg.resolved_spmm_impl()} if layout in ("coo", "halo") else {}),
        **({"tiles": list(engine.tiles), "slot_floors": engine.slot_floor.tolist()}
           if layout == "multi" else {}),
        **({"mesh_shape": list(grid.shape), "engine": type(engine).__name__,
            "graphs": bool(graphs) and (use_lockstep or engine.graphed),
            **({"fold_shards": grid.n_data} if use_lockstep else {})} if mesh else {}),
        num_params=num_params(init_params(torch.Generator().manual_seed(0), model)),
        device=str(device),
    )
    if done is not None and all(d is not None for d in done):
        for f, d in enumerate(done, start=1):
            print(f"[fold {f}] resumed (complete): test {d[1]:.2f}%")
        return _finalize_cv(cfg, events, [d[0] for d in done], [d[1] for d in done],
                            writer)
    if use_lockstep:
        from dgcnn_tpu_torch.train.cv_vmap import run_cv_folds_lockstep

        train_accs, test_accs = run_cv_folds_lockstep(
            cfg, dataset, model, folds, events, engine, grid)
        return _finalize_cv(cfg, events, train_accs, test_accs, writer)

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
        if engine.FLOORS and writer:
            save_checkpoint(floors, {"floors": engine_floors(engine)})
        train_accs.append(metrics.last("train_accuracy"))
        test_accs.append(metrics.last("test_accuracy"))
        print(
            f"[{fold_number}] Train Acc: {train_accs[-1]:.2f}% "
            f"Test Acc: {test_accs[-1]:.2f}% ({dt:.1f}s)"
        )
        if hasattr(bar, "set_postfix"):
            bar.set_postfix(test_acc=f"{test_accs[-1]:.2f}%")
    if writer:
        remove_checkpoint(floors)
    return _finalize_cv(cfg, events, train_accs, test_accs, writer)


def _finalize_cv(cfg: Config, events: EventLog, train_accs, test_accs,
                 writer: bool = True):
    """The run tail, the same for both drivers (the reference's
    :1508-1528): overall CSV, the curve PNG, the TensorBoard export (both
    best-effort on the host), summary line and run_end event. Only the
    `writer` (a mesh's rank 0) writes files."""
    if writer:
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
