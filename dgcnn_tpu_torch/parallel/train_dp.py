"""Training over the (data, graph) process grid — the port of
dgcnn_tpu/parallel/train_dp.py (`_loss_terms` :35, `make_sharded_loss`
:43, the dense, device-COO and block DP losses :128, :289, :361, and the
epoch runner `_make_fused_dp_run` :214).

The training protocol is the single-device one: one global batch per
optimizer step, the loss the mean NLL over that batch's real graphs. The
grid changes only where the work runs:

  * each "data" rank computes the forward and backward of its
    LPT-balanced sub-batch; `Σ_d loss_sum / max(Σ_d count, 1)` over the
    data group is the global-batch mean (`global_terms`). Its backward
    is the rank's own share, and one `all_reduce(SUM)` of the gradients
    over the data group after `backward()` (`reduce_gradients`) gives
    every rank the global-batch gradient; the optimizer step is then
    replicated;
  * each "graph" rank aggregates its contiguous chunk of the sub-batch's
    edge stream; one sum over the graph group per GCN layer rebuilds the
    aggregate, and the SpMM's backward sums the cotangent of h over the
    group (ops/spmm.py `edge_group`), so every graph rank holds the full
    forward and the full gradient. The graph axis carries no work on the
    dense and block layouts: there it only replicates the computation.

Dropout folds in the data rank alone (the reference's
`fold_in(rng, axis_index("data"))`): the engines seed each rank's
generator from (seed, fold, stream, d), so the graph ranks of one data
group draw the same masks. Every rank starts from the same weights, sees
the same shuffle and gets the same summed gradients, so the replicas stay
bitwise equal.

The epochs run eagerly (`DPRun`): a collective of the `gloo` backend
cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch

from dgcnn_tpu_torch.batching.block_sparse import BlockGraphSet, gather_block_batch
from dgcnn_tpu_torch.batching.dense import DenseDataset, gather_dense_batch
from dgcnn_tpu_torch.batching.device_coo import DeviceGraphSet, gather_coo_batch
from dgcnn_tpu_torch.batching.packer import (
    BucketSpec, GraphBatch, batch_step, batch_to_device,
)
from dgcnn_tpu_torch.parallel.mesh import ProcessGrid, sum_over
from dgcnn_tpu_torch.parallel.shard import local_view


def _loss_terms(log_probs, y, graph_mask):
    """(summed NLL over the real graphs, correct count) of one sub-batch."""
    classes = torch.arange(log_probs.shape[-1], device=log_probs.device)
    onehot = (y.long()[..., None] == classes).to(log_probs.dtype)
    loss_sum = -((log_probs * onehot).sum(-1) * graph_mask).sum()
    pred = torch.argmax(log_probs, dim=-1)
    correct = ((pred == y.long()).to(torch.float32) * graph_mask).sum()
    return loss_sum, correct


class _GroupSum(torch.autograd.Function):
    """Sum over a group's ranks forward; the identity backward, so that a
    rank's backward is its own share of a summed loss."""

    @staticmethod
    def forward(ctx, t, group):
        return sum_over(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_terms(loss_sum, count, correct, *groups):
    """(global mean loss, global correct count) from one rank's terms, one
    collective over each of `groups` in turn (the data group; the halo
    layout's graph group, then its data group)."""
    s = torch.stack([loss_sum, count, correct])
    for group in groups:
        s = _GroupSum.apply(s, group)
    return s[0] / s[1].clamp(min=1.0), s[2].detach()


def reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Every parameter's gradient summed over `group` (one collective)."""
    if group is None:
        return
    params = [p for p in params if p.grad is not None]
    flat = sum_over(torch.cat([p.grad.reshape(-1) for p in params]), group)
    off = 0
    for p in params:
        p.grad.copy_(flat[off : off + p.numel()].view_as(p.grad))
        off += p.numel()


def _sub_batch_loss(batch_fn: Callable, grid: ProcessGrid, deterministic: bool,
                    **fwd_kw) -> Callable:
    """(net, idx_rows [n_data, slots] on the device, dropout_gen) → (global
    mean loss, correct): this rank assembles its own row's sub-batch with
    `batch_fn` and runs the forward with `fwd_kw`."""

    def f(net, idx_rows, dropout_gen=None):
        if idx_rows.shape[0] != grid.n_data:
            raise ValueError(
                f"the order block has {idx_rows.shape[0]} rows; the order matrix must "
                f"carry exactly the grid's {grid.n_data} data ranks per step — other "
                f"rows would be dropped without a word")
        batch = batch_fn(idx_rows[grid.d])
        lp = net(batch, deterministic=deterministic,
                 dropout_gen=None if deterministic else dropout_gen, **fwd_kw)
        loss_sum, correct = _loss_terms(lp, batch.y, batch.graph_mask)
        return global_terms(loss_sum, batch.graph_mask.sum(), correct, grid.data_group)

    return f


def make_dense_dp_loss(data: DenseDataset, grid: ProcessGrid,
                       deterministic: bool) -> Callable:
    """The dense layout's DP loss (the reference's `_make_dense_dp_loss`):
    each data rank gathers its sub-batch from the replicated dataset."""
    return _sub_batch_loss(functools.partial(gather_dense_batch, data), grid,
                           deterministic)


def make_device_coo_dp_loss(dev: DeviceGraphSet, grid: ProcessGrid, bucket: BucketSpec,
                            spmm_impl: str, deterministic: bool) -> Callable:
    """The device-COO DP loss (`_make_device_coo_dp_loss`): each data rank
    assembles its sub-batch from the replicated graphset, and each graph
    rank only its contiguous chunk of the sub-batch's edge stream
    (`edge_window`), aggregated over the graph group."""
    if bucket.num_edges % grid.n_graph:
        raise ValueError(f"bucket edges {bucket.num_edges} % n_graph {grid.n_graph}")
    chunk = bucket.num_edges // grid.n_graph
    window = (grid.g * chunk, chunk)
    return _sub_batch_loss(
        lambda row: gather_coo_batch(dev, row, bucket, edge_window=window), grid,
        deterministic, spmm_impl=spmm_impl, edge_group=grid.graph_group)


def make_block_dp_loss(dev: BlockGraphSet, grid: ProcessGrid, nb_budget: int,
                       w_budget: int, deterministic: bool,
                       block_impl: str = "pallas") -> Callable:
    """The block layout's DP loss (`_make_block_dp_loss`): each data rank
    assembles its sub-batch from the replicated block graphset at the
    budgets and runs the block kernel `block_impl` names."""
    return _sub_batch_loss(
        lambda row: gather_block_batch(dev, row, nb_budget, w_budget), grid,
        deterministic, pool=dev.pool, block_impl=block_impl)


def make_local_coo_loss(grid: ProcessGrid, spmm_impl: str = "xla",
                        deterministic: bool = False) -> Callable:
    """(net, local, dropout_gen) → (global mean loss, correct count) for
    this rank's own COO sub-batch `local` on the device (its edge leaves
    its chunk of the stream), aggregated over the graph group."""

    def f(net, local: GraphBatch, dropout_gen=None):
        lp = net(local, deterministic=deterministic,
                 dropout_gen=None if deterministic else dropout_gen,
                 spmm_impl=spmm_impl, edge_group=grid.graph_group)
        loss_sum, correct = _loss_terms(lp, local.y, local.graph_mask)
        return global_terms(loss_sum, local.graph_mask.sum(), correct, grid.data_group)

    return f


def make_sharded_loss(grid: ProcessGrid, spmm_impl: str = "xla",
                      deterministic: bool = False) -> Callable:
    """(net, step_batch, dropout_gen) → (global mean loss, correct count)
    for a host-packed step laid out as `shard_batch_for_dp` packs it
    ([n_data(, n_graph), ...] leaves, NumPy or tensors): this rank takes
    its `local_view`, moves it to the net's device and runs the COO
    forward over its edge chunk. `backward()` of the loss gives this
    rank's share; `reduce_gradients` over the data group completes it."""
    local_loss = make_local_coo_loss(grid, spmm_impl, deterministic)

    def f(net, step_batch: GraphBatch, dropout_gen=None):
        local = local_view(step_batch, grid.d, grid.g, grid.n_data, grid.n_graph)
        if not isinstance(local.x, torch.Tensor):
            local = batch_to_device(local, next(net.parameters()).device)
        return local_loss(net, local, dropout_gen)

    return f


def dp_train_pass(net, optimizer, train_loss: Callable, steps, dropout_gen,
                  grid: ProcessGrid, grad_groups=None):
    """Train over `steps` on the grid: for each, the DP loss
    (`train_loss(net, step, dropout_gen)`), its backward, the gradients
    summed over each of `grad_groups` in turn (default: the data group),
    the replicated Adam step. Returns (mean of the global batch means,
    summed correct count) on the device."""
    if grad_groups is None:
        grad_groups = (grid.data_group,)
    net.train()
    losses, corrects = [], []
    for step in steps:
        optimizer.zero_grad(set_to_none=True)
        loss, correct = train_loss(net, step, dropout_gen)
        loss.backward()
        for group in grad_groups:
            reduce_gradients(net.parameters(), group)
        optimizer.step()
        losses.append(loss.detach())
        corrects.append(correct.detach())
    return torch.stack(losses).mean(), torch.stack(corrects).sum()


def dp_eval_pass(net, eval_loss: Callable, steps, device):
    """Evaluate over `steps` with dropout off and no gradients: (mean loss,
    correct count); an empty stream gives zeros (the reference's
    `has_eval`)."""
    net.eval()
    with torch.no_grad():
        if len(steps) == 0:
            zero = torch.zeros((), device=device)
            return zero, zero
        losses, corrects = zip(*(eval_loss(net, step) for step in steps))
        return torch.stack(losses).mean(), torch.stack(corrects).sum()


def dp_epoch_body(net, optimizer, train_loss: Callable, eval_loss: Callable,
                  train_steps, test_steps, dropout_gen, grid: ProcessGrid,
                  rows: torch.Tensor) -> None:
    """One epoch of train + eval on the grid (`dp_train_pass`, then
    `dp_eval_pass`); writes (train_loss, test_loss, train_correct,
    test_correct) into `rows` [4]."""
    tr_loss, tr_correct = dp_train_pass(net, optimizer, train_loss, train_steps,
                                        dropout_gen, grid)
    te_loss, te_correct = dp_eval_pass(net, eval_loss, test_steps, rows.device)
    rows.copy_(torch.stack([tr_loss, te_loss, tr_correct, te_correct]))


def local_steps(batches: GraphBatch, grid: ProcessGrid, device) -> list:
    """This rank's steps of a packed epoch (`pack_epoch_dp`'s layout) on
    `device`: its `local_view`, one transfer per array, then a view a
    step."""
    local = batch_to_device(
        local_view(batches, grid.d, grid.g, grid.n_data, grid.n_graph, steps=True),
        device)
    return [batch_step(local, s) for s in range(local.y.shape[0])]


def make_dp_train_epoch(net, optimizer, grid: ProcessGrid,
                        spmm_impl: str = "xla") -> Callable:
    """The port of `make_dp_train_epoch` (:82): `train_epoch(batches,
    dropout_gen) → (mean loss, correct)` over a host-packed epoch laid out
    by `pack_epoch_dp`, updating `net` in place."""
    loss = make_local_coo_loss(grid, spmm_impl, deterministic=False)
    device = next(net.parameters()).device

    def train_epoch(batches: GraphBatch, dropout_gen):
        return dp_train_pass(net, optimizer, loss, local_steps(batches, grid, device),
                             dropout_gen, grid)

    return train_epoch


def make_dp_eval_epoch(net, grid: ProcessGrid, spmm_impl: str = "xla") -> Callable:
    """The port of `make_dp_eval_epoch` (:108): `eval_epoch(steps) → (mean
    loss, correct)` over this rank's `local_steps` of a packed epoch."""
    loss = make_local_coo_loss(grid, spmm_impl, deterministic=True)
    device = next(net.parameters()).device
    return lambda steps: dp_eval_pass(net, loss, steps, device)


class DPRun:
    """k epochs of `dp_epoch_body` per host round trip, eagerly (the mesh
    counterpart of train/loop.py `FusedRun`, and of the reference's
    `_make_fused_dp_run`): `run_epochs` ships the chunk's k orders
    [k, steps, n_data, slots] in one copy, runs each epoch and brings the
    k rows back in one copy."""

    def __init__(self, net, optimizer, train_loss: Callable, eval_loss: Callable,
                 test_steps, dropout_gen, grid: ProcessGrid):
        self.net, self.optimizer = net, optimizer
        self.train_loss, self.eval_loss = train_loss, eval_loss
        self.test_steps = test_steps
        self.dropout_gen = dropout_gen
        self.grid = grid
        self.device = next(net.parameters()).device

    def run_epochs(self, orders_k: np.ndarray) -> np.ndarray:
        orders = torch.from_numpy(np.ascontiguousarray(orders_k, dtype=np.int32)).to(
            self.device)
        out = torch.empty((len(orders_k), 4), dtype=torch.float32, device=self.device)
        for j in range(len(orders_k)):
            dp_epoch_body(self.net, self.optimizer, self.train_loss, self.eval_loss,
                          orders[j], self.test_steps, self.dropout_gen, self.grid, out[j])
        return out.cpu().double().numpy()


def _test_rows(test_order3d: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(test_order3d, dtype=np.int32)).to(device)


def make_dense_dp_run(net, optimizer, data: DenseDataset, grid: ProcessGrid,
                      test_order3d: np.ndarray, dropout_gen) -> DPRun:
    """The port of `make_dense_dp_run` (:271): epochs over the replicated
    dense dataset, orders [k, steps, n_data, slots], the fold's fixed
    test order [t_steps, n_data, slots]."""
    return DPRun(net, optimizer, make_dense_dp_loss(data, grid, False),
                 make_dense_dp_loss(data, grid, True),
                 _test_rows(test_order3d, data.adj.device), dropout_gen, grid)


def make_device_coo_dp_run(net, optimizer, dev: DeviceGraphSet, grid: ProcessGrid,
                           bucket: BucketSpec, test_order3d: np.ndarray, dropout_gen,
                           spmm_impl: str = "xla") -> DPRun:
    """The port of `make_device_coo_dp_run` (:345): epochs over the
    replicated device COO graphset in one bucket."""
    return DPRun(net, optimizer,
                 make_device_coo_dp_loss(dev, grid, bucket, spmm_impl, False),
                 make_device_coo_dp_loss(dev, grid, bucket, spmm_impl, True),
                 _test_rows(test_order3d, dev.x.device), dropout_gen, grid)


def make_block_dp_run(net, optimizer, dev: BlockGraphSet, grid: ProcessGrid,
                      nb_budget: int, w_budget: int, test_order3d: np.ndarray,
                      dropout_gen, block_impl: str = "pallas") -> DPRun:
    """The port of `make_block_dp_run` (:416): epochs over the replicated
    block graphset at the budgets (nb, W)."""
    return DPRun(net, optimizer,
                 make_block_dp_loss(dev, grid, nb_budget, w_budget, False, block_impl),
                 make_block_dp_loss(dev, grid, nb_budget, w_budget, True, block_impl),
                 _test_rows(test_order3d, dev.pool.device), dropout_gen, grid)
