"""Training and evaluation loops — the port of dgcnn_tpu/train/loop.py
(`nll_loss_and_correct` :38, the step :58-86, the fused multi-epoch
runner `_fused_run` :89 with `make_coo_run` :177,
`make_multi_dense_run` :201, `make_device_coo_run` :236,
`make_block_run` :270 and `make_dense_gather_run` :373), and the
fold-lockstep step and epoch of dgcnn_tpu/train/cv_vmap.py:58
`_make_lockstep_body` (`masked_update` :86, `real_folds` :97, the step
and epoch reductions :106-152, run over k epochs by `make_dense_vmap_run`
:167, `make_block_vmap_run` :207 and `make_multi_vmap_run` :270).

Contract with the reference:
  * loss per batch = NLL mean over the batch's real graphs; the epoch
    metric is the mean of per-batch means (a smaller final batch is
    over-weighted, as in the reference);
  * train accuracy is measured during training, with dropout active;
  * Adam with optax.adam's formula: torch.optim.Adam computes
    lr·m̂/(√v̂ + ε) with bias-corrected moments and ε outside the root.

One epoch body per driver: `epoch_body` (one model) and
`lockstep_epoch_body` (F folds) train over the rows of an order, each
assembled into a batch by a `batch_fn`, evaluate over the fixed test
order and write the epoch's row into a device rows buffer. A body moves
nothing between host and device and never waits for the device (no
`.item()`, no `nonzero`, no boolean-mask indexing, no host tensor), as
long as its `batch_fn` does not: the dense, block and device-COO
gathers do not, and the host-packed COO layout's `batch_step` only takes
views of a static stack. `epoch_rows` runs one eager epoch of
`epoch_body`.

The fused runner (`FusedRun`) runs k epochs of a body per host round
trip, as the reference's `_fused_run` runs k epochs in one program:
`run_epochs` ships the chunk's k orders in one copy, runs each epoch
from the static order buffer, gathers the k rows on the device and
brings them back in one copy. On the card the first epoch a runner sees
runs eagerly on the runner's own stream (the warm-up: kernel builds, the
optimizer's state, cuBLAS set-up, the kernels' scratch); the body is
then captured once as a `torch.cuda.CUDAGraph`, every dropout generator
registered with it, and every later epoch is one replay. On the CPU
every epoch runs the body eagerly. The kernels and the order of
operations are the same either way, so the rows are the eager loop's
bits. One runner factory per layout, each named after the reference's:
`make_dense_gather_run` and `make_dense_lockstep_run` (dense),
`make_multi_dense_run` and `make_multi_lockstep_run` (multi-tile dense,
at one slot tuple), `make_block_run` and `make_block_lockstep_run`
(block-sparse, at one (nb, W) budget),
`make_device_coo_run` (COO assembled on the device, at one bucket) and
`make_coo_run` (COO packed on the host: the body reads a static device
stack of one epoch, which the runner's `stage(j)` fills with epoch j
before it runs). A runner serves one budget: an engine whose budget
grows drops it, with its graph, and builds another (train/cv.py).

Fold-lockstep: F folds train as one model of fold-stacked parameters
(`DGCNNFoldsNet`). A step backpropagates the sum of the F per-fold mean
losses, so each fold's gradient is its own, and `FoldAdam` updates only
the folds with a real graph in the step; a fold whose row is all −1 (it
has fewer steps than the longest fold) draws no dropout, takes no Adam
step and adds nothing to its epoch row. Which folds are real at each
step depends only on the fold sizes (`stacked_orders` pads each fold at
its end), so one captured graph serves every epoch; the runner refuses
an order whose pattern differs from the one it was built for.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.batching.block_sparse import (
    BlockGraphSet, gather_block_batch, gather_block_batch_folds,
)
from dgcnn_tpu_torch.batching.dense import DenseDataset, gather_dense_batch
from dgcnn_tpu_torch.batching.device_coo import DeviceGraphSet, gather_coo_batch
from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch
from dgcnn_tpu_torch.batching.packer import (
    BucketSpec, GraphBatch, batch_arrays, batch_step, empty_batch_like,
)
from dgcnn_tpu_torch.kernels import block_csr, block_resident, dense_trunk
from dgcnn_tpu_torch.kernels import spmm_block_coo, spmm_pallas
from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, DGCNNNet
from dgcnn_tpu_torch.train.metrics import SPANS


def nll_loss_and_correct(
    log_probs: torch.Tensor, y: torch.Tensor, graph_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked NLL (mean over real graphs) and correct-prediction count. The
    label pick is a one-hot product, as in the reference (the one-hot is
    a comparison with the class ids: `F.one_hot` reads the labels back to
    the host on the CPU); `argmax` takes the first index among equal
    maxima. Log-probs [F, S, C] with y and graph_mask [F, S] give each
    fold's pair, [F] and [F]."""
    n = graph_mask.sum(dim=-1).clamp(min=1.0)
    classes = torch.arange(log_probs.shape[-1], device=log_probs.device)
    onehot = (y.long()[..., None] == classes).to(log_probs.dtype)
    ll = (log_probs * onehot).sum(dim=-1)
    loss = -(ll * graph_mask).sum(dim=-1) / n
    pred = torch.argmax(log_probs, dim=-1)
    correct = ((pred == y.long()).to(torch.float32) * graph_mask).sum(dim=-1)
    return loss, correct


def make_optimizer(net: DGCNNNet, lr: float = 1e-3, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8,
                   flat: bool = False) -> torch.optim.Adam:
    """torch's Adam (`flat`: `FlatAdam`, `--opt_flatten`). On CUDA
    parameters it is `capturable`: the step counts and bias corrections
    stay on the device, so an epoch graph can hold the update, and the
    eager epochs run the same update and give the same bits. torch
    refuses `capturable` on the CPU."""
    cuda = next(net.parameters()).is_cuda
    if flat:
        return FlatAdam(net, lr=lr, betas=(b1, b2), eps=eps, capturable=cuda)
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(b1, b2), eps=eps,
                            capturable=cuda)


class FlatAdam(torch.optim.Adam):
    """`--opt_flatten`, the port of dgcnn_tpu/train/flat_opt.py:28
    `flatten_optimizer`: one Adam update over the raveled parameter
    vector. The net's parameters become views of one flat parameter
    (`parameters()` order) and `step` updates it from the concatenated
    gradients, as torch's Adam over that one tensor: the same per-element
    formula as the per-leaf Adam of `make_optimizer` (its CPU or its
    capturable foreach path), so the parameters are the per-leaf run's
    bits, and capturable inside an epoch graph. Its state is one step
    count and vector-shaped moments [P]: bundles written with it do not
    load into a per-leaf Adam, nor the other way (utils/checkpoint.py
    `load_into` raises). Build it before the first forward: it moves the
    parameters' storage."""

    def __init__(self, net: torch.nn.Module, **adam_kw):
        self.leaves = list(net.parameters())
        flat = torch.nn.Parameter(torch.cat([p.detach().reshape(-1)
                                             for p in self.leaves]))
        off = 0
        for p in self.leaves:  # each parameter becomes a view of its run of `flat`
            p.data = flat.data[off : off + p.numel()].view(p.shape)
            off += p.numel()
        super().__init__([flat], **adam_kw)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.leaves:
            p.grad = None
        super().zero_grad(set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        flat = self.param_groups[0]["params"][0]
        flat.grad = torch.cat([p.grad.reshape(-1) for p in self.leaves])
        return super().step(closure)


def train_step(
    net: DGCNNNet,
    optimizer: torch.optim.Optimizer,
    batch,
    dropout_gen: Optional[torch.Generator],
    **fwd_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update: forward with dropout → masked NLL → backward → Adam.
    `fwd_kw` goes to the forward (the block layout's `pool` and
    `block_impl`, the COO layout's `spmm_impl`). Returns the batch's
    (loss, correct) as device scalars."""
    optimizer.zero_grad(set_to_none=True)
    log_probs = net(batch, deterministic=False, dropout_gen=dropout_gen, **fwd_kw)
    loss, correct = nll_loss_and_correct(log_probs, batch.y, batch.graph_mask)
    loss.backward()
    optimizer.step()
    return loss.detach(), correct


BatchFn = Callable[[object], object]


def epoch_body(net, optimizer, batch_fn: BatchFn, order2d, test_order2d,
               dropout_gen, rows: torch.Tensor, **fwd_kw) -> None:
    """One epoch of train + eval over any layout (the epoch of the
    reference's `_fused_run(batch_fn, ...)`): train over the rows of
    `order2d` (a [steps, slots] index matrix on the device, or any
    sequence of rows), each row assembled into a batch by `batch_fn`, then
    evaluate over `test_order2d` with dropout off and no gradients;
    `fwd_kw` goes to the forward. Writes (train_loss, test_loss,
    train_correct, test_correct) into `rows` [4] on the device: the losses
    are means of batch means, the counts sums."""
    net.train()
    losses, corrects = [], []
    for row in order2d:
        loss, correct = train_step(net, optimizer, batch_fn(row), dropout_gen,
                                   **fwd_kw)
        losses.append(loss)
        corrects.append(correct)
    tr_loss, tr_correct = torch.stack(losses).mean(), torch.stack(corrects).sum()
    net.eval()
    with torch.no_grad():
        if len(test_order2d) == 0:
            te_loss = te_correct = torch.zeros((), device=rows.device)
        else:
            losses, corrects = [], []
            for row in test_order2d:
                batch = batch_fn(row)
                loss, correct = nll_loss_and_correct(
                    net(batch, deterministic=True, **fwd_kw), batch.y,
                    batch.graph_mask)
                losses.append(loss)
                corrects.append(correct)
            te_loss, te_correct = torch.stack(losses).mean(), torch.stack(corrects).sum()
        rows.copy_(torch.stack([tr_loss, te_loss, tr_correct, te_correct]))


def epoch_rows(net, optimizer, batch_fn: BatchFn, order2d, test_order2d,
               dropout_gen, **fwd_kw) -> torch.Tensor:
    """One eager `epoch_body`; its row [4] on the net's device."""
    rows = torch.empty(4, dtype=torch.float32, device=next(net.parameters()).device)
    epoch_body(net, optimizer, batch_fn, order2d, test_order2d, dropout_gen, rows,
               **fwd_kw)
    return rows


# -- fold-lockstep --------------------------------------------------------


class FoldAdam:
    """Adam over a `DGCNNFoldsNet`'s fold-stacked parameters: one update
    of the whole flat buffer for all F folds, with a step count per fold.
    The formula is that of the `torch.optim.Adam` the sequential driver
    runs (`make_optimizer`), written out:

        m ← lerp(m, g, 1 − b1);  v ← v·b2 + (1 − b2)·g²
        p ← p − (lr / (1 − b1^t)) · m / (√v / √(1 − b2^t) + eps)

    with the bias corrections taken in float64 from each fold's count t.
    `step(real)` applies it to the folds whose `real` [F] entry is True
    and leaves the others' parameters, moments and counts untouched (a
    `where`, not a zero gradient: Adam would still decay the moments and
    move the weights). The update is the same under `--opt_flatten`
    (`flat_state`); only the bundles' layout follows it: vector-shaped
    moments, as `FlatAdam`'s."""

    def __init__(self, net_f: DGCNNFoldsNet, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, flat_state: bool = False):
        self.params = list(net_f.parameters())
        self.flat = net_f.flat
        self.flat_state = flat_state
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        f, dev = net_f.num_folds, self.flat.device
        self.steps = torch.zeros(f, dtype=torch.float32, device=dev)
        self.exp_avg = torch.zeros_like(self.flat)
        self.exp_avg_sq = torch.zeros_like(self.flat)
        # the fold of every element of the flat buffer
        folds = torch.arange(f, device=dev)[:, None]
        self.fold_of = torch.cat([folds.expand(f, p[0].numel()).reshape(-1)
                                  for p in self.params])

    @torch.no_grad()
    def step(self, real: torch.Tensor) -> None:
        grad = torch.cat([p.grad.reshape(-1) for p in self.params])
        self.steps.add_(real.to(self.steps.dtype))
        t = self.steps.double()
        step_size = (self.lr / (1.0 - self.b1 ** t)).float()[self.fold_of]
        bc2_sqrt = (1.0 - self.b2 ** t).sqrt().float()[self.fold_of]
        m = self.exp_avg.lerp(grad, 1.0 - self.b1)
        v = self.exp_avg_sq.mul(self.b2).addcmul_(grad, grad, value=1.0 - self.b2)
        denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
        p = self.flat - step_size * m / denom
        keep = real[self.fold_of]
        self.flat.copy_(torch.where(keep, p, self.flat))
        self.exp_avg.copy_(torch.where(keep, m, self.exp_avg))
        self.exp_avg_sq.copy_(torch.where(keep, v, self.exp_avg_sq))

    def _runs(self, buf: torch.Tensor) -> list:
        """`buf`'s run of each parameter, [F, ...] views in `parameters()`
        order."""
        out, off = [], 0
        for p in self.params:
            out.append(buf[off : off + p.numel()].view(p.shape))
            off += p.numel()
        return out

    def fold_state(self, fold: int) -> dict:
        """Fold `fold`'s (0-based) moments and step counts in the layout of
        the sequential driver's `adam_state` (`fold_adam_state`)."""
        return fold_adam_state(self.run_tensors(), fold, self.flat_state)

    def run_tensors(self) -> dict:
        """The per-fold step counts and the moments as [F, ...] runs a
        parameter (views of the live buffers)."""
        return {"steps": self.steps, "exp_avg": self._runs(self.exp_avg),
                "exp_avg_sq": self._runs(self.exp_avg_sq)}

    def state_tensors(self) -> dict:
        """The live state, for the lockstep run's in-flight bundle
        (utils/checkpoint.py `load_into`): `run_tensors`, or under
        `flat_state` the flat buffers."""
        if self.flat_state:
            return {"steps": self.steps, "exp_avg": self.exp_avg,
                    "exp_avg_sq": self.exp_avg_sq}
        return self.run_tensors()


def fold_adam_state(runs: dict, fold: int, flat_state: bool = False) -> dict:
    """Fold `fold`'s (0-based) moments and step count from `runs`
    (`FoldAdam.run_tensors`' layout, [F, ...] leaves) in the layout of the
    sequential driver's `adam_state`: a list per key in `parameters()`
    order; under `flat_state` one step count and the fold's moments
    raveled in that order, as `FlatAdam`'s."""
    out = {key: [r[fold].cpu() for r in runs[key]] for key in ("exp_avg", "exp_avg_sq")}
    if flat_state:
        out = {key: [torch.cat([t.reshape(-1) for t in ts])] for key, ts in out.items()}
    out["step"] = [runs["steps"][fold].cpu()] * len(out["exp_avg"])
    return out


def lockstep_train_step(net_f: DGCNNFoldsNet, adam_f: FoldAdam, batch,
                        real: torch.Tensor, dropout_gens, **fwd_kw
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lockstep update of all folds: forward with dropout (fold f
    draws from `dropout_gens[f]`, None for a fold with no real graph) →
    per-fold masked NLL → backward of their sum → `FoldAdam` on the `real`
    folds; `fwd_kw` goes to the forward (the block layout's `pool` and
    `block_impl`). Returns the per-fold (loss [F], correct [F]) on the
    device."""
    net_f.zero_grad(set_to_none=True)
    log_probs = net_f(batch, deterministic=False, dropout_gens=dropout_gens, **fwd_kw)
    f = log_probs.shape[0]
    loss_f, correct_f = nll_loss_and_correct(
        log_probs, batch.y.view(f, -1), batch.graph_mask.view(f, -1))
    loss_f.sum().backward()
    adam_f.step(real)
    return loss_f.detach(), correct_f


def _fold_means(losses, corrects, real) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-fold (mean loss over its real steps, correct count) from the
    per-step [steps, F] values."""
    rf = real.to(torch.float32)
    loss = (torch.stack(losses) * rf).sum(0) / rf.sum(0).clamp(min=1.0)
    return loss, (torch.stack(corrects) * rf).sum(0)


def lockstep_epoch_body(net_f, adam_f, batch_fn: BatchFn, order3d: torch.Tensor,
                        test_order3d: torch.Tensor, step_gens: Sequence[list],
                        rows: torch.Tensor, **fwd_kw) -> None:
    """One lockstep epoch of train + eval for every fold: train over the
    device [steps, F, slots] index matrix `order3d` (−1 padded; a fold's
    all-(−1) row is a step it skips), each step's flattened [F·slots] row
    assembled by `batch_fn`, step s drawing fold f's dropout from
    `step_gens[s][f]` (None where the fold skips the step); then evaluate
    over `test_order3d`; `fwd_kw` goes to the forward. Writes the
    per-fold rows [F, 4] (train_loss, test_loss, train_correct,
    test_correct; each fold's means over its own real steps) into `rows`
    on the device."""
    if len(step_gens) != order3d.shape[0]:
        raise ValueError(f"{len(step_gens)} steps of generators for "
                         f"{order3d.shape[0]} train steps")
    net_f.train()
    real = (order3d >= 0).any(dim=-1)  # [steps, F]
    losses, corrects = [], []
    for s, gens in enumerate(step_gens):
        loss_f, correct_f = lockstep_train_step(
            net_f, adam_f, batch_fn(order3d[s].reshape(-1)), real[s], gens, **fwd_kw)
        losses.append(loss_f)
        corrects.append(correct_f)
    tr_loss, tr_correct = _fold_means(losses, corrects, real)
    net_f.eval()
    with torch.no_grad():
        te_real = (test_order3d >= 0).any(dim=-1)
        losses, corrects = [], []
        for row in test_order3d:
            batch = batch_fn(row.reshape(-1))
            log_probs = net_f(batch, deterministic=True, **fwd_kw)
            f = log_probs.shape[0]
            loss_f, correct_f = nll_loss_and_correct(
                log_probs, batch.y.view(f, -1), batch.graph_mask.view(f, -1))
            losses.append(loss_f)
            corrects.append(correct_f)
        te_loss, te_correct = _fold_means(losses, corrects, te_real)
        rows.copy_(torch.stack([tr_loss, te_loss, tr_correct, te_correct], dim=-1))


# -- the fused runner -----------------------------------------------------

# every kernel wrapper's launch counter, by kernel name; a graph replay
# adds what its capture counted to each
KERNEL_COUNTERS = {
    "dense_trunk": dense_trunk.launches, "block_csr": block_csr.launches,
    "block_resident": block_resident.launches,
    "spmm_block_coo": spmm_block_coo.launches,
    "spmm_rows": spmm_pallas.rows_launches,
    "spmm_edge_block": spmm_pallas.edge_block_launches,
}


class CountedGraph:
    """A CUDA graph and the kernels' launch counters (objects whose
    attributes are plain int counts). A wrapper counts when Python calls
    it, which for a graph is once, at capture: `capture()` takes the
    counters' difference over the capture and puts the counters back (the
    capture launched nothing), and each `replay()` adds that difference."""

    def __init__(self, graph, counters=tuple(KERNEL_COUNTERS.values())):
        self.graph = graph
        self.counters = counters
        self.per_replay = None

    @contextlib.contextmanager
    def capture(self):
        before = [dict(vars(c)) for c in self.counters]
        try:
            yield self.graph
        finally:
            self.per_replay = [{k: v - b[k] for k, v in vars(c).items()}
                               for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                vars(c).update(b)

    def replay(self) -> None:
        self.graph.replay()
        for c, diff in zip(self.counters, self.per_replay):
            for k, v in diff.items():
                setattr(c, k, getattr(c, k) + v)


class FusedRun:
    """k epochs of one epoch body per host round trip (see the module
    docstring). `body()` reads the static device buffer `order` [steps,
    (F,) slots] (a mesh runner's: [steps, n_data, slots]) and writes the
    epoch's row into `rows` [(F,) 4]; `pattern` [steps(, F)] is which
    steps (of which folds) hold a real graph in every epoch; `generators`
    are the dropout generators the body draws from; `stage(j)`, when
    given, fills the body's other static inputs with epoch j of the chunk
    before it runs (on the current stream, after the order's copy).
    `graphs=False` runs every epoch eagerly: on the card for comparison,
    or on a `gloo` mesh, whose collectives cannot be captured; on the CPU
    every epoch is eager. A capture or replay that fails raises.

    The capture's error mode is "thread_local": in a process of an `nccl`
    group (the mesh engines, fold-sharded lockstep) the process group's
    watchdog thread queries the events of collectives still in flight from
    the warm-up or between chunks, which the "global" mode forbids any
    thread to do while a capture runs."""

    def __init__(self, body: Callable[[], None], order: torch.Tensor,
                 rows: torch.Tensor, pattern: np.ndarray,
                 generators: Sequence[torch.Generator], graphs: bool = True,
                 stage: Optional[Callable[[int], None]] = None):
        self.body = body
        self.stage = stage
        self.order = order
        self.rows = rows
        self.pattern = np.asarray(pattern, dtype=bool)
        self.generators = list(generators)
        self.graphs = graphs and order.is_cuda
        self.stream = torch.cuda.Stream(order.device) if self.graphs else None
        self.graph: Optional[CountedGraph] = None
        self.warmup_seconds: Optional[float] = None
        self.capture_seconds: Optional[float] = None

    def _check(self, orders_k: np.ndarray) -> None:
        """Raise unless `orders_k` [k, steps, (F,) ...] fits the order
        buffer and every epoch's real steps (those with a graph id left in
        their rows) are the runner's pattern."""
        if tuple(orders_k.shape[1:]) != tuple(self.order.shape):
            raise ValueError(f"orders {tuple(orders_k.shape)} do not fit the "
                             f"order buffer {tuple(self.order.shape)}")
        real = (orders_k >= 0).reshape(len(orders_k), *self.pattern.shape, -1).any(-1)
        for j, r in enumerate(real):
            if not np.array_equal(r, self.pattern):
                raise ValueError(
                    f"epoch {j} of the chunk has real steps {r.astype(int).tolist()}, "
                    f"not the runner's {self.pattern.astype(int).tolist()}")

    def run_epochs(self, orders_k: np.ndarray) -> np.ndarray:
        """Run the epochs of a chunk of host orders [k, *order.shape];
        returns the host rows [k, (F,) 4] in float64. Spans
        (train/metrics.py `SPANS`): `runner.stage` (the check and the
        orders' copy), `runner.replay` a replay, with its device time."""
        dev = self.order.device
        with SPANS.span("runner.stage"):
            orders_k = np.ascontiguousarray(orders_k, dtype=np.int32)
            self._check(orders_k)
            orders = torch.from_numpy(orders_k).to(dev)  # the chunk's one host-to-device copy
            out = torch.empty((len(orders_k), *self.rows.shape), dtype=self.rows.dtype,
                              device=dev)
        for j in range(len(orders_k)):
            self.order.copy_(orders[j])
            if self.stage is not None:
                self.stage(j)
            if not self.graphs:
                self.body()
            elif self.graph is None:
                self._warm_up_and_capture()
            else:
                with SPANS.span("runner.replay", device=dev):
                    self.graph.replay()
            out[j].copy_(self.rows)
        rows = out.cpu().double().numpy()  # the chunk's one device-to-host copy
        SPANS.chunk_done()
        return rows

    def _warm_up_and_capture(self) -> None:
        """The eager warm-up epoch on the runner's stream (span
        `runner.warmup`, with its device time: `warmup_seconds`), then the
        capture (span `runner.capture`: `capture_seconds`)."""
        main = torch.cuda.current_stream(self.order.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream), SPANS.span(
                "runner.warmup", device=self.order.device, timed=True) as warm:
            self.body()
        self.warmup_seconds = warm.seconds
        main.wait_stream(self.stream)
        with SPANS.span("runner.capture", timed=True) as cap:
            graph = CountedGraph(torch.cuda.CUDAGraph())
            for g in self.generators:
                graph.graph.register_generator_state(g)
            with graph.capture(), torch.cuda.graph(graph.graph, stream=self.stream,
                                                   capture_error_mode="thread_local"):
                self.body()
        self.graph = graph
        self.capture_seconds = cap.seconds


def _gather_run(net: DGCNNNet, optimizer, batch_fn: BatchFn, test_order2d: np.ndarray,
                steps: int, dropout_gen, graphs: bool, held=(), **fwd_kw) -> FusedRun:
    """The fused runner of one fold's `epoch_body` over batches gathered on
    the device from [slots] graph-id rows by `batch_fn`: `steps` train
    steps an epoch, every one holding a real graph, and the fold's fixed
    test order [t_steps, slots]; `fwd_kw` goes to the forward. The body
    keeps `held` (tensors a graph reads by address) alive."""
    dev = next(net.parameters()).device
    order = torch.full((steps, test_order2d.shape[1]), -1, dtype=torch.int32,
                       device=dev)
    test = torch.from_numpy(np.ascontiguousarray(test_order2d)).to(dev)
    rows = torch.zeros(4, dtype=torch.float32, device=dev)

    def body(_held=held):
        epoch_body(net, optimizer, batch_fn, order, test, dropout_gen, rows, **fwd_kw)

    return FusedRun(body, order, rows, np.ones(steps, dtype=bool), [dropout_gen],
                    graphs)


def make_dense_gather_run(net: DGCNNNet, optimizer, data: DenseDataset,
                          test_order2d: np.ndarray, steps: int, dropout_gen,
                          graphs: bool = True) -> FusedRun:
    """The port of `make_dense_gather_run` (dgcnn_tpu/train/loop.py:373):
    the fused runner of one fold's `epoch_body` over a dense dataset on
    the device, `steps` train steps an epoch, the fold's fixed test order
    [t_steps, slots]."""
    return _gather_run(net, optimizer, functools.partial(gather_dense_batch, data),
                       test_order2d, steps, dropout_gen, graphs)


def make_multi_dense_run(net: DGCNNNet, optimizer, classes: Sequence[DenseDataset],
                         slots: Sequence[int], test_order2d: np.ndarray, steps: int,
                         dropout_gen, graphs: bool = True) -> FusedRun:
    """The port of `make_multi_dense_run` (dgcnn_tpu/train/loop.py:201): the
    fused runner of one fold's `epoch_body` over the multi-tile dense
    layout, `classes` one `DenseDataset` a tile class on the device. An
    order row holds the classes' index rows side by side, [ΣS_c] with class
    c's `slots[c]` at a static offset (−1 padded; train/cv.py
    `MultiDenseEngine.epoch_order`); the batch gathers each class's slice
    from its dataset (`gather_dense_batch`) into a `MultiDenseBatch`, and
    the model runs the trunk once a class (`apply_multi_dense`). `steps`
    train steps an epoch, the fold's fixed test order [t_steps, ΣS_c]."""
    bounds = np.concatenate([[0], np.cumsum(slots)]).tolist()

    def batch_fn(row):
        return MultiDenseBatch(tuple(
            gather_dense_batch(d, row[a:b])
            for d, a, b in zip(classes, bounds[:-1], bounds[1:])))

    return _gather_run(net, optimizer, batch_fn, test_order2d, steps, dropout_gen,
                       graphs)


def _lockstep_run(net_f: DGCNNFoldsNet, adam_f: FoldAdam, batch_fn: BatchFn,
                  test_order3d: np.ndarray, pattern: np.ndarray, dropout_gens,
                  graphs: bool, held=(), **fwd_kw) -> FusedRun:
    """The fused runner of the lockstep epoch, the port of the epoch scan
    of `_make_lockstep_body` (dgcnn_tpu/train/cv_vmap.py:106-152):
    `lockstep_epoch_body` over steps [F, ·] rows, each step's flattened row
    assembled by `batch_fn`, the folds' fixed test order [t_steps, F, ·],
    `pattern` [steps, F] the folds' real train steps (`train/cv_vmap.py
    fold_pattern`), fold f's dropout from `dropout_gens[f]`; `fwd_kw` goes
    to the forward. The body keeps `held` alive."""
    dev = net_f.flat.device
    order = torch.full((len(pattern), *test_order3d.shape[1:]), -1,
                       dtype=torch.int32, device=dev)
    test = torch.from_numpy(np.ascontiguousarray(test_order3d)).to(dev)
    rows = torch.zeros((net_f.num_folds, 4), dtype=torch.float32, device=dev)
    step_gens = [[g if r else None for g, r in zip(dropout_gens, row)]
                 for row in pattern]

    def body(_held=held):
        lockstep_epoch_body(net_f, adam_f, batch_fn, order, test, step_gens, rows,
                            **fwd_kw)

    return FusedRun(body, order, rows, pattern, dropout_gens, graphs)


def make_dense_lockstep_run(net_f: DGCNNFoldsNet, adam_f: FoldAdam,
                            data: DenseDataset, test_order3d: np.ndarray,
                            pattern: np.ndarray, dropout_gens,
                            graphs: bool = True) -> FusedRun:
    """The fused runner of the dense lockstep epoch, as `make_dense_vmap_run`
    (dgcnn_tpu/train/cv_vmap.py:167) runs it: each step's [F·slots] row
    gathered from the dense dataset on the device (`_lockstep_run`)."""
    return _lockstep_run(net_f, adam_f, functools.partial(gather_dense_batch, data),
                         test_order3d, pattern, dropout_gens, graphs)


def make_multi_lockstep_run(net_f: DGCNNFoldsNet, adam_f: FoldAdam,
                            classes: Sequence[DenseDataset], slots: Sequence[int],
                            test_order3d: np.ndarray, pattern: np.ndarray,
                            dropout_gens, graphs: bool = True) -> FusedRun:
    """The port of `make_multi_vmap_run` (dgcnn_tpu/train/cv_vmap.py:270):
    the fused runner of the lockstep epoch on the multi-tile dense layout
    at one slot tuple. A step's order row is [F, ΣS_c], each fold's row
    laid out as `make_multi_dense_run`'s; class c gathers its [F, S_c]
    slice, flattened fold-major, from its dataset into one batch of F·S_c
    slots, and the model runs the trunk once a class for all folds
    (`apply_multi_dense_folds`); the folds' fixed test order [t_steps, F,
    ΣS_c]."""
    bounds = np.concatenate([[0], np.cumsum(slots)]).tolist()
    f = net_f.num_folds

    def batch_fn(row):
        per_fold = row.view(f, -1)
        return MultiDenseBatch(tuple(
            gather_dense_batch(d, per_fold[:, a:b].reshape(-1))
            for d, a, b in zip(classes, bounds[:-1], bounds[1:])), num_folds=f)

    return _lockstep_run(net_f, adam_f, batch_fn, test_order3d, pattern, dropout_gens,
                         graphs)


def _arrival_counters(device: torch.device, block_rows: int = 0,
                      nodes: int = 0) -> list:
    """The arrival counters the CSR block kernel (`block_rows`) and the
    edge-block SpMM kernel (`nodes`) need at a runner's budget, sized when
    the runner is built: a counter buffer first allocated inside a capture
    would come from the graph's private pool. The runner's body holds
    them, so that a graph's counters outlive a larger budget's."""
    if device.type != "cuda":
        return []
    held = []
    if block_rows:
        held.append(block_csr._counters(device, block_rows))
    if nodes:
        held.append(spmm_pallas._counters(device, nodes))
    return held


def make_block_run(net: DGCNNNet, optimizer, dev: BlockGraphSet,
                   test_order2d: np.ndarray, nb_budget: int, w_budget: int,
                   steps: int, dropout_gen, block_impl: str = "pallas",
                   graphs: bool = True) -> FusedRun:
    """The port of `make_block_run` (dgcnn_tpu/train/loop.py:270): the
    fused runner of one fold's `epoch_body` over a block-sparse graphset on
    the device, every batch assembled by `gather_block_batch` at the
    budgets (nb, W), `steps` train steps an epoch, the fold's fixed test
    order [t_steps, slots]; each propagation runs the kernel `block_impl`
    names over the resident pool."""
    held = _arrival_counters(dev.pool.device,
                             block_rows=nb_budget if block_impl == "pallas" else 0)
    return _gather_run(
        net, optimizer, lambda row: gather_block_batch(dev, row, nb_budget, w_budget),
        test_order2d, steps, dropout_gen, graphs, held, pool=dev.pool,
        block_impl=block_impl)


def make_block_lockstep_run(net_f: DGCNNFoldsNet, adam_f: FoldAdam,
                            dev: BlockGraphSet, test_order3d: np.ndarray,
                            nb_budget: int, w_budget: int, pattern: np.ndarray,
                            dropout_gens, block_impl: str = "pallas",
                            graphs: bool = True) -> FusedRun:
    """The port of `make_block_vmap_run` (dgcnn_tpu/train/cv_vmap.py:207):
    the fused runner of the lockstep epoch on the block-sparse layout at
    the budgets (nb per fold, W per step over all folds): each step's
    [F, slots] row assembled by `gather_block_batch_folds`, every layer's
    propagation one call of the kernel `block_impl` names over the folds'
    merged stream of F·nb block-rows (`apply_block_folds`), the folds'
    fixed test order [t_steps, F, slots]."""
    f = net_f.num_folds
    held = _arrival_counters(dev.pool.device,
                             block_rows=f * nb_budget if block_impl == "pallas" else 0)
    return _lockstep_run(
        net_f, adam_f,
        lambda row: gather_block_batch_folds(dev, row.view(f, -1), nb_budget, w_budget),
        test_order3d, pattern, dropout_gens, graphs, held, pool=dev.pool,
        block_impl=block_impl)


def make_device_coo_run(net: DGCNNNet, optimizer, dev: DeviceGraphSet,
                        test_order2d: np.ndarray, bucket: BucketSpec, steps: int,
                        dropout_gen, spmm_impl: str = "xla",
                        graphs: bool = True) -> FusedRun:
    """The port of `make_device_coo_run` (dgcnn_tpu/train/loop.py:236): the
    fused runner of one fold's `epoch_body` over a COO graphset on the
    device, every batch assembled by `gather_coo_batch` into `bucket`,
    `steps` train steps an epoch, the fold's fixed test order [t_steps,
    slots]; each aggregation runs the SpMM kernel `spmm_impl` names."""
    held = _arrival_counters(dev.x.device,
                             nodes=bucket.num_nodes if spmm_impl == "onehot" else 0)
    return _gather_run(
        net, optimizer, lambda row: gather_coo_batch(dev, row, bucket), test_order2d,
        steps, dropout_gen, graphs, held, spmm_impl=spmm_impl)


def make_coo_run(net: DGCNNNet, optimizer, source: Callable[[int], GraphBatch],
                 test: GraphBatch, slots: int, dropout_gen, spmm_impl: str = "xla",
                 graphs: bool = True) -> FusedRun:
    """The port of `make_coo_run` (dgcnn_tpu/train/loop.py:177): the fused
    runner of one fold's `epoch_body` over host-packed COO epochs. The
    device holds one packed epoch in a static stack of `source(0)`'s
    shapes; `stage(j)` copies `source(j)`, epoch j of the chunk as CPU
    tensors (page-locked on the card), into it, and the body takes step s
    of the stack, then of the fold's packed test stack `test` on the
    device, by `batch_step`. The order buffer [steps, slots] carries the
    epoch's graph ids, which the stack holds packed. Each aggregation runs
    the SpMM kernel `spmm_impl` names, the block-COO kernel on the
    structures the stacks carry."""
    device = test.x.device
    stack = empty_batch_like(source(0), device)
    steps = stack.y.shape[0]
    order = torch.full((steps, slots), -1, dtype=torch.int32, device=device)
    rows = torch.zeros(4, dtype=torch.float32, device=device)
    held = _arrival_counters(device, nodes=stack.x.shape[1] if spmm_impl == "onehot"
                             else 0)
    train_steps = [(stack, s) for s in range(steps)]
    test_steps = [(test, s) for s in range(test.y.shape[0])]

    def batch_fn(step):
        return batch_step(*step)

    def body(_held=held):
        epoch_body(net, optimizer, batch_fn, train_steps, test_steps, dropout_gen,
                   rows, spmm_impl=spmm_impl)

    def stage(j):
        for dst, src in zip(batch_arrays(stack), batch_arrays(source(j))):
            dst.copy_(src, non_blocking=True)

    return FusedRun(body, order, rows, np.ones(steps, dtype=bool), [dropout_gen],
                    graphs, stage=stage)
