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

The epoch runners (`make_dense_dp_run`, `make_device_coo_dp_run`,
`make_block_dp_run`, `make_staged_dp_run`) are each a `FusedRun`
(train/loop.py) of `dp_epoch_body`, as the reference's
`_make_fused_dp_run` is one jitted program. Whether it is graphed is
chosen once, when it is built, from the grid's backend and device
(`ProcessGrid.graphed`): under `nccl` on the card the first epoch runs
eagerly (it also creates every communicator the body uses), the body is
then captured, collectives included, and every later epoch is one
CUDA-graph replay. A collective of the `gloo` backend cannot be
captured, so under `gloo` every epoch runs the body eagerly. The body is
the same either way: every rank runs every collective of every step, in
one order, whether or not its sub-batch holds a real graph, and nothing
in it reads the device from the host.
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
from dgcnn_tpu_torch.train.loop import FusedRun, _arrival_counters


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
                  rows: torch.Tensor, grad_groups=None) -> None:
    """One epoch of train + eval on the grid (`dp_train_pass`, then
    `dp_eval_pass`); writes (train_loss, test_loss, train_correct,
    test_correct) into `rows` [4]."""
    tr_loss, tr_correct = dp_train_pass(net, optimizer, train_loss, train_steps,
                                        dropout_gen, grid, grad_groups)
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


def graphed_dp_run(net, optimizer, train_loss: Callable, eval_loss: Callable,
                   test_order3d: np.ndarray, steps: int, dropout_gen,
                   grid: ProcessGrid, graphs: bool = True, held=()) -> FusedRun:
    """The fused runner of `dp_epoch_body` over the gather engines' orders:
    the body reads the static order buffer [`steps`, n_data, slots] and the
    fold's fixed test order [t_steps, n_data, slots]. It is graphed where
    `graphs` asks for it and the grid captures (`ProcessGrid.graphed`):
    the first epoch warms up, the body is captured with the rank's dropout
    generator registered, and every later epoch is one replay; otherwise
    every epoch runs the body eagerly. The body keeps `held` (tensors the
    graph reads by address) alive."""
    dev = next(net.parameters()).device
    order = torch.full((steps, *test_order3d.shape[1:]), -1, dtype=torch.int32,
                       device=dev)
    test = torch.from_numpy(np.ascontiguousarray(test_order3d, dtype=np.int32)).to(dev)
    rows = torch.zeros(4, dtype=torch.float32, device=dev)

    def body(_held=held):
        dp_epoch_body(net, optimizer, train_loss, eval_loss, order, test, dropout_gen,
                      grid, rows)

    return FusedRun(body, order, rows, np.ones(steps, dtype=bool), [dropout_gen],
                    graphs and grid.graphed)


def make_dense_dp_run(net, optimizer, data: DenseDataset, grid: ProcessGrid,
                      test_order3d: np.ndarray, dropout_gen, *, steps: int,
                      graphs: bool = True) -> FusedRun:
    """The port of `make_dense_dp_run` (:271): epochs over the replicated
    dense dataset, orders [k, steps, n_data, slots], the fold's fixed
    test order [t_steps, n_data, slots]; graphed or eager as
    `graphed_dp_run` chooses."""
    return graphed_dp_run(net, optimizer, make_dense_dp_loss(data, grid, False),
                          make_dense_dp_loss(data, grid, True), test_order3d, steps,
                          dropout_gen, grid, graphs)


def make_device_coo_dp_run(net, optimizer, dev: DeviceGraphSet, grid: ProcessGrid,
                           bucket: BucketSpec, test_order3d: np.ndarray, dropout_gen,
                           spmm_impl: str = "xla", *, steps: int,
                           graphs: bool = True) -> FusedRun:
    """The port of `make_device_coo_dp_run` (:345): epochs over the
    replicated device COO graphset in one bucket."""
    held = _arrival_counters(dev.x.device,
                             nodes=bucket.num_nodes if spmm_impl == "onehot" else 0)
    return graphed_dp_run(net, optimizer,
                          make_device_coo_dp_loss(dev, grid, bucket, spmm_impl, False),
                          make_device_coo_dp_loss(dev, grid, bucket, spmm_impl, True),
                          test_order3d, steps, dropout_gen, grid, graphs, held)


def make_block_dp_run(net, optimizer, dev: BlockGraphSet, grid: ProcessGrid,
                      nb_budget: int, w_budget: int, test_order3d: np.ndarray,
                      dropout_gen, block_impl: str = "pallas", *, steps: int,
                      graphs: bool = True) -> FusedRun:
    """The port of `make_block_dp_run` (:416): epochs over the replicated
    block graphset at the budgets (nb, W)."""
    held = _arrival_counters(dev.pool.device,
                             block_rows=nb_budget if block_impl == "pallas" else 0)
    return graphed_dp_run(
        net, optimizer,
        make_block_dp_loss(dev, grid, nb_budget, w_budget, False, block_impl),
        make_block_dp_loss(dev, grid, nb_budget, w_budget, True, block_impl),
        test_order3d, steps, dropout_gen, grid, graphs, held)


def make_staged_dp_run(net, optimizer, train_loss: Callable, eval_loss: Callable,
                       train_steps: list, test_steps, stage: Callable[[int], None],
                       order_shape, dropout_gen, grid: ProcessGrid, grad_groups=None,
                       graphs: bool = True, held=()) -> FusedRun:
    """The fused runner of the host-packed mesh engines (`MeshCooEngine`,
    `MeshHaloEngine`), as train/loop.py `make_coo_run`: the body trains
    over `train_steps`, views of a static device stack of one packed
    epoch, which `stage(j)` fills with epoch j of the chunk before it
    runs, then evaluates over the fold's device `test_steps`; gradients
    summed over `grad_groups` (default: the data group). The order buffer
    [`order_shape`] carries the epoch's graph ids, which the stack holds
    packed. Graphed or eager as `graphed_dp_run` chooses."""
    dev = next(net.parameters()).device
    order = torch.full(tuple(order_shape), -1, dtype=torch.int32, device=dev)
    rows = torch.zeros(4, dtype=torch.float32, device=dev)

    def body(_held=held):
        dp_epoch_body(net, optimizer, train_loss, eval_loss, train_steps, test_steps,
                      dropout_gen, grid, rows, grad_groups)

    return FusedRun(body, order, rows, np.ones(order_shape[0], dtype=bool),
                    [dropout_gen], graphs and grid.graphed, stage=stage)
