"""The halo layout's forward, loss and epochs — the port of
dgcnn_tpu/parallel/halo.py (`_exchange` :45, `apply_halo` :59,
`make_halo_loss` :107, `make_halo_train_epoch` :150,
`make_halo_eval_epoch` :177).

The node axis is sharded over the grid's graph axis
(batching/shard_pack.py). Per GCN layer, each rank:

  1. computes `H = XΘ` for its OWN node shard,
  2. scales the rows by its local d̂^{-½} (the sym-norm's source side),
  3. exchanges H boundary rows with both neighbours (`HaloExchange`),
  4. aggregates its local, dst-sorted edge chunk over the extended
     [H | S | H] window through the SpMM kernel `spmm_impl` names
     (ops/spmm.py: the row kernel for "xla" and "pallas" — halo batches
     carry no block-COO structure — the edge-block kernel for "onehot");
     every destination is local, so no reduction collective is needed.

SortPooling runs shard-locally on owned graphs (each graph's owner sees
it whole in its extended window), after one more exchange of the
concatenated layer outputs; the loss is summed over the graph group,
then over the data group.

The transport (`exchange_for`): as the reference's two `ppermute`s, one
`batch_isend_irecv` with the two neighbours, 2·H·F elements out of a
rank (H·F at a chain's end), under `nccl` on CUDA tensors and under
`gloo` on CPU tensors. `gloo` serves only `all_reduce` and `broadcast` on
CUDA tensors (parallel/mesh.py), so there one exchange is one
`all_reduce(SUM)` over the graph group of a zeroed [G, 2, H, F] buffer in
which each rank wrote its first and last H rows: O(G·H·F) moved, exact
(it adds only zeros). Both give the same values; the transport is chosen
by the backend and the tensors' device, never as a fall back.

Gradients: on this layout each graph rank owns different graphs and the
exchange's backward carries cross-shard terms, so a parameter's
gradient is the sum of its share on all D·G ranks (`GRAD_GROUPS`: the
graph group, then the data group), where the other mesh engines sum
over the data group alone.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from dgcnn_tpu_torch.batching.shard_pack import HaloBatch
from dgcnn_tpu_torch.models.dgcnn import DGCNN, Params, _pooled_to_log_probs
from dgcnn_tpu_torch.ops.gcn import gcn_degree
from dgcnn_tpu_torch.ops.readout import matmul_f32
from dgcnn_tpu_torch.ops.sort_pool import sort_pool
from dgcnn_tpu_torch.ops.spmm import edge_order, spmm
from dgcnn_tpu_torch.parallel.mesh import ProcessGrid, sum_over
from dgcnn_tpu_torch.parallel.train_dp import _loss_terms, dp_eval_pass, dp_train_pass, global_terms


def _swap_by_all_reduce(top: torch.Tensor, bottom: torch.Tensor, group, g: int,
                        n: int):
    """(the left neighbour's `bottom`, the right neighbour's `top`), zeros
    where a rank has no neighbour: one all_reduce(SUM) over `group` of a
    zeroed [n, 2, H, F] buffer holding each rank's (top, bottom) in its
    slot."""
    buf = top.new_zeros((n, 2) + tuple(top.shape))
    buf[g, 0] = top
    buf[g, 1] = bottom
    sum_over(buf, group)
    left = buf[g - 1, 1] if g > 0 else torch.zeros_like(top)
    right = buf[g + 1, 0] if g < n - 1 else torch.zeros_like(top)
    return left, right


def _swap_point_to_point(top: torch.Tensor, bottom: torch.Tensor, group, g: int,
                         n: int):
    """The same pair from one `batch_isend_irecv` with the two neighbours
    (the reference's two `ppermute`s): `top` goes to the left neighbour and
    `bottom` to the right one; the left neighbour's `bottom` and the right
    one's `top` come back. Peers are the neighbours' global ranks, the
    graph group's members in grid order (`mesh.device_grid`)."""
    left, right = torch.zeros_like(top), torch.zeros_like(top)
    ops = []
    for nb, send, recv in ((g - 1, top, left), (g + 1, bottom, right)):
        if 0 <= nb < n:
            peer = dist.get_global_rank(group, nb)
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return left, right


def exchange_for(group, t: torch.Tensor) -> Callable:
    """The exchange's transport for `t` over `group`: point to point, but
    the all-reduce for CUDA tensors under `gloo` (and for no group: one
    rank, nothing to exchange)."""
    if group is None or (t.is_cuda and dist.get_backend(group) == "gloo"):
        return _swap_by_all_reduce
    return _swap_point_to_point


class HaloExchange(torch.autograd.Function):
    """[S, F] → [H | S | H, F]: the left neighbour's LAST H rows, the rank's
    own rows, the right neighbour's FIRST H rows (zeros at the chain's
    ends, exactly what out-of-batch halo rows must be), moved by `swap`
    (`exchange_for`). The backward is the reverse exchange by the same
    transport: the left halo's cotangent goes back, added, to the left
    neighbour's last H rows, the right halo's to the right neighbour's
    first H rows."""

    @staticmethod
    def forward(ctx, arr, h: int, group, g: int, n: int, swap: Callable):
        ctx.h, ctx.group, ctx.g, ctx.n, ctx.swap = h, group, g, n, swap
        left, right = swap(arr[:h], arr[-h:], group, g, n)
        return torch.cat([left, arr, right], dim=0)

    @staticmethod
    def backward(ctx, grad):
        h, g, n = ctx.h, ctx.g, ctx.n
        s = grad.shape[0] - 2 * h
        # this rank's left-halo cotangent goes to its left neighbour, its
        # right-halo cotangent to its right one; it receives the left
        # neighbour's right-halo cotangent (its own first H rows) and the
        # right neighbour's left-halo cotangent (its last H rows)
        from_left, from_right = ctx.swap(grad[:h], grad[h + s:], ctx.group, g, n)
        d = grad[h : h + s].clone()
        if g > 0:
            d[:h] += from_left
        if g < n - 1:
            d[s - h :] += from_right
        return d, None, None, None, None, None


def halo_exchange(arr: torch.Tensor, h: int, group, g: int, n: int) -> torch.Tensor:
    """`HaloExchange` of `arr` by `exchange_for`'s transport (fp32 on the
    wire: a bf16 array goes out widened and comes back rounded, which is
    exact)."""
    swap = exchange_for(group, arr)
    if arr.dtype == torch.float32:
        return HaloExchange.apply(arr, h, group, g, n, swap)
    return HaloExchange.apply(arr.float(), h, group, g, n, swap).to(arr.dtype)


def apply_halo(
    params: Params,
    model: DGCNN,
    batch: HaloBatch,  # one rank's view: tensors, no shard axis
    *,
    group=None,
    g: int = 0,
    n_graph: int = 1,
    deterministic: bool = True,
    dropout_gen: Optional[torch.Generator] = None,
    spmm_impl: str = "xla",
) -> torch.Tensor:
    """Shard-local forward → log-probs [B_s, C] of the OWNED graphs (padded
    slots garbage, masked by `batch.graph_mask`); `group` is the graph
    group of `n_graph` ranks in which this rank is `g`. Under bf16 compute
    x, each W_i at its product and each layer's output are bf16, the
    products summed in fp32 and the aggregation fp32, as the reference
    casts."""
    h = batch.halo
    s = batch.x.shape[0]
    n_ext = s + 2 * h
    num_slots = batch.y.shape[0]
    dt = model.dtype

    # local in-degree over the dst-partitioned edge chunk + the re-added
    # self-loop; every destination is local, so no collective
    deg_hat = gcn_degree(batch.edge_dst_loc, batch.edge_mask, s)
    dinv = torch.rsqrt(deg_hat)[:, None]
    # the aggregation over the extended window: destinations shifted by H
    # stay sorted (the padding's dst S−1 has mask 0)
    dst_ext = batch.edge_dst_loc + h
    order = None
    if batch.x.is_cuda:
        order = edge_order(batch.edge_src_ext, dst_ext, n_ext,
                           edge_mask=batch.edge_mask, dst_sorted=True)
    x = batch.x.to(dt)
    mask = batch.node_mask[:, None]

    layer_outs = []
    for layer in params["gcn"]:
        hw = matmul_f32(x, layer["w"].to(dt))
        # the source side of the sym-norm folded into the exchanged rows
        hw_ext = halo_exchange(hw * dinv, h, group, g, n_graph)
        agg = spmm(batch.edge_src_ext, dst_ext, batch.edge_mask, hw_ext, n_ext,
                   impl=spmm_impl, order=order)[h : h + s] * dinv
        x = (torch.tanh(agg + hw * (1.0 / deg_hat)[:, None] + layer["b"]) * mask).to(dt)
        layer_outs.append(x)

    cat = torch.cat(layer_outs, dim=-1)
    cat_ext = halo_exchange(cat, h, group, g, n_graph)
    pooled = sort_pool(cat_ext, batch.node_graph_ext, num_slots, model.sort_pool_k)
    return _pooled_to_log_probs(params, model, pooled, deterministic, dropout_gen, {})


def grad_groups(grid: ProcessGrid) -> tuple:
    """The groups a halo parameter gradient is summed over, in order: the
    graph group, then the data group (all D·G ranks)."""
    return (grid.graph_group, grid.data_group)


def make_halo_loss(grid: ProcessGrid, spmm_impl: str = "xla",
                   deterministic: bool = False) -> Callable:
    """(net, local, dropout_gen) → (global mean loss, correct count) of one
    step, `local` this rank's HaloBatch view on the net's device: the
    summed NLL and counts over the graph group, then the data group,
    divided by the global count of real graphs. `backward()` gives this
    rank's share; the sum over `grad_groups` completes it."""

    def f(net, local: HaloBatch, dropout_gen=None):
        lp = apply_halo(net.params(), net.model, local, group=grid.graph_group,
                        g=grid.g, n_graph=grid.n_graph, deterministic=deterministic,
                        dropout_gen=None if deterministic else dropout_gen,
                        spmm_impl=spmm_impl)
        loss_sum, correct = _loss_terms(lp, local.y, local.graph_mask)
        return global_terms(loss_sum, local.graph_mask.sum(), correct,
                            grid.graph_group, grid.data_group)

    return f


def halo_steps(batches: HaloBatch, device) -> list:
    """A rank's packed epoch ([steps, ...] leaves, `pack_epoch_halo(...,
    rank=...)`) on `device`: one transfer per array, then a view a step."""
    dev = batches.map(lambda a: torch.from_numpy(a).to(device))
    return [dev.map(lambda a, s=s: a[s]) for s in range(dev.y.shape[0])]


def make_halo_train_epoch(net, optimizer, grid: ProcessGrid,
                          spmm_impl: str = "xla") -> Callable:
    """`train_epoch(steps, dropout_gen) → (mean loss, correct)` over this
    rank's `halo_steps`, updating `net` in place: each step's loss, its
    backward, the gradients summed over all D·G ranks, the replicated Adam
    step; the loss is the mean of the steps' global means (the
    reference's per-batch-mean contract)."""
    loss = make_halo_loss(grid, spmm_impl, deterministic=False)
    return lambda steps, dropout_gen: dp_train_pass(
        net, optimizer, loss, steps, dropout_gen, grid, grad_groups(grid))


def make_halo_eval_epoch(net, grid: ProcessGrid, spmm_impl: str = "xla") -> Callable:
    """`eval_epoch(steps) → (mean loss, correct)` with dropout off and no
    gradients."""
    loss = make_halo_loss(grid, spmm_impl, deterministic=True)
    device = next(net.parameters()).device
    return lambda steps: dp_eval_pass(net, loss, steps, device)
