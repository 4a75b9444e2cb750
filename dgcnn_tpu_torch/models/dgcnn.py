"""DGCNN — the port of dgcnn_tpu/models/dgcnn.py (`DGCNN` :41,
`init_params` :88, the head :134, `apply_coo` :178, `_dense_trunk` :260,
`apply_dense` :344, `apply_block` :930, the layout dispatch of `apply`
:1035):

    4 × [GCNConv → tanh] with dims (F→32→32→32→1), skip-concat (97)
    SortPooling k=30
    Conv1d(1,16,97,97) → ReLU → MaxPool1d(2,2) → Conv1d(16,32,5,1) → ReLU
    Linear(352,128) → ReLU → Dropout(0.5) → Linear(128,C) → log_softmax

Parameters keep the reference's layout — weights [in, out], conv6 'HIO',
the readout flattened time-major — so weights carry over by copy
(parity/convert.py) and activations compare like with like. The
functional `apply_dense` / `apply_block` / `apply_coo(params, ...)` work
on a nested dict of tensors shaped like the reference's pytree;
`DGCNNNet` is the `nn.Module` that owns those tensors as parameters and
dispatches on the batch's layout.

fp32 only: bfloat16 compute is ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from dgcnn_tpu_torch.batching.block_sparse import BlockBatch
from dgcnn_tpu_torch.batching.dense import DenseGraphBatch
from dgcnn_tpu_torch.batching.packer import GraphBatch
from dgcnn_tpu_torch.kernels.block_csr import block_propagate_csr
from dgcnn_tpu_torch.kernels.block_csr import make_plan as block_csr_plan
from dgcnn_tpu_torch.kernels.block_resident import block_propagate_resident
from dgcnn_tpu_torch.kernels.block_resident import make_plan as block_resident_plan
from dgcnn_tpu_torch.kernels.dense_trunk import gcn_trunk
from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_order
from dgcnn_tpu_torch.ops.gcn import gcn_conv, gcn_degree
from dgcnn_tpu_torch.ops.readout import conv1d_readout
from dgcnn_tpu_torch.ops.spmm import edge_order
from dgcnn_tpu_torch.ops.sort_pool import sort_pool, sort_pool_dense

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DGCNN:
    """Architecture hyperparameters (the reference's defaults)."""

    num_features: int
    num_classes: int
    hidden_dims: Tuple[int, ...] = (32, 32, 32, 1)
    sort_pool_k: int = 30
    conv1d_channels: Tuple[int, int] = (16, 32)
    conv1d_kernel: int = 5
    dense_dim: int = 128
    dropout_rate: float = 0.5

    @property
    def concat_dim(self) -> int:
        return sum(self.hidden_dims)

    @property
    def flat_dim(self) -> int:
        t = self.sort_pool_k // 2 - self.conv1d_kernel + 1
        return t * self.conv1d_channels[1]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * 2.0 - 1.0) * bound


def init_params(gen: torch.Generator, model: DGCNN, device="cpu") -> Params:
    """Fresh parameters from a CPU `torch.Generator` (so a seed gives the
    same weights on every device), then moved to `device`. The bounds are
    the reference's: PyG glorot U(±√(6/(fan_in+fan_out))) for the GCN
    weights, zero GCN biases, and torch's kaiming-uniform(a=√5)
    U(±1/√fan_in) for conv5, conv6, lin1 and lin2."""
    gcn = []
    in_dim = model.num_features
    for out_dim in model.hidden_dims:
        a = math.sqrt(6.0 / (in_dim + out_dim))
        gcn.append({
            "w": _uniform(gen, (in_dim, out_dim), a),
            "b": torch.zeros(out_dim, dtype=torch.float32),
        })
        in_dim = out_dim

    c5, c6 = model.conv1d_channels
    cat = model.concat_dim
    width = model.conv1d_kernel
    flat = model.flat_dim

    def kaiming(shape, fan_in):
        return _uniform(gen, shape, 1.0 / math.sqrt(float(fan_in)))

    params = {
        "gcn": gcn,
        "conv5": {"w": kaiming((cat, c5), cat), "b": kaiming((c5,), cat)},
        "conv6": {
            "w": kaiming((width, c5, c6), c5 * width),
            "b": kaiming((c6,), c5 * width),
        },
        "lin1": {
            "w": kaiming((flat, model.dense_dim), flat),
            "b": kaiming((model.dense_dim,), flat),
        },
        "lin2": {
            "w": kaiming((model.dense_dim, model.num_classes), model.dense_dim),
            "b": kaiming((model.num_classes,), model.dense_dim),
        },
    }
    return _map(params, lambda t: t.to(device))


def _map(params: Params, fn) -> Params:
    return {
        "gcn": [{n: fn(t) for n, t in layer.items()} for layer in params["gcn"]],
        **{
            name: {n: fn(t) for n, t in params[name].items()}
            for name in ("conv5", "conv6", "lin1", "lin2")
        },
    }


def leaves(params: Params):
    """The parameter tensors in the reference pytree's leaf order (sorted
    keys: conv5, conv6, gcn, lin1, lin2; b before w)."""
    out = []
    for name in ("conv5", "conv6", "gcn", "lin1", "lin2"):
        groups = params[name] if name == "gcn" else [params[name]]
        out += [t for g in groups for t in (g["b"], g["w"])]
    return out


def num_params(params: Params) -> int:
    return sum(t.numel() for t in leaves(params))


class DGCNNNet(nn.Module):
    """The model as an `nn.Module`: owns the parameters (state_dict keys
    `gcn.<i>.w`, `gcn.<i>.b`, `conv5.w`, … in the reference layout) and
    runs `apply_dense`, `apply_block` for a `BlockBatch` or `apply_coo`
    for a `GraphBatch` in `forward`."""

    def __init__(self, model: DGCNN, params: Params):
        super().__init__()
        self.model = model

        def pd(d):
            return nn.ParameterDict({n: nn.Parameter(t) for n, t in d.items()})

        self.gcn = nn.ModuleList([pd(layer) for layer in params["gcn"]])
        self.conv5 = pd(params["conv5"])
        self.conv6 = pd(params["conv6"])
        self.lin1 = pd(params["lin1"])
        self.lin2 = pd(params["lin2"])

    def params(self) -> Params:
        """The parameters as the reference-shaped nested dict."""
        return {
            "gcn": [{"w": layer["w"], "b": layer["b"]} for layer in self.gcn],
            **{
                name: {"w": getattr(self, name)["w"], "b": getattr(self, name)["b"]}
                for name in ("conv5", "conv6", "lin1", "lin2")
            },
        }

    def forward(self, batch, *, deterministic: bool = True,
                dropout_gen: Optional[torch.Generator] = None,
                return_activations: bool = False,
                pool: Optional[torch.Tensor] = None,
                block_impl: str = "pallas", spmm_impl: str = "xla"):
        """`batch` is a DenseGraphBatch, a BlockBatch or a GraphBatch; a
        BlockBatch also needs the engine's adjacency block `pool` and the
        `block_impl` that propagates over it, a GraphBatch the `spmm_impl`
        that aggregates its edges."""
        kw = dict(deterministic=deterministic, dropout_gen=dropout_gen,
                  return_activations=return_activations)
        if isinstance(batch, GraphBatch):
            return apply_coo(self.params(), self.model, batch,
                             spmm_impl=spmm_impl, **kw)
        if isinstance(batch, BlockBatch):
            if pool is None:
                raise ValueError("a BlockBatch needs the block pool")
            return apply_block(self.params(), self.model, batch, pool,
                               block_impl=block_impl, **kw)
        return apply_dense(self.params(), self.model, batch, **kw)


def _pooled_to_log_probs(
    params: Params,
    model: DGCNN,
    pooled: torch.Tensor,  # [B, k, C]
    deterministic: bool,
    dropout_gen: Optional[torch.Generator],
    acts: dict,
) -> torch.Tensor:
    """conv1d readout → MLP head → log_softmax."""
    feats = conv1d_readout(
        pooled,
        params["conv5"]["w"], params["conv5"]["b"],
        params["conv6"]["w"], params["conv6"]["b"],
    )
    acts["readout"] = feats
    h = torch.relu(torch.matmul(feats, params["lin1"]["w"]) + params["lin1"]["b"])
    if not deterministic:
        if dropout_gen is None:
            raise ValueError("dropout_gen required when deterministic=False")
        keep = 1.0 - model.dropout_rate
        mask = torch.rand(h.shape, generator=dropout_gen, device=h.device) < keep
        h = torch.where(mask, h / keep, torch.zeros_like(h))
    logits = torch.matmul(h, params["lin2"]["w"]) + params["lin2"]["b"]
    log_probs = torch.log_softmax(logits, dim=-1)
    acts["log_probs"] = log_probs
    return log_probs


def _dense_trunk(params: Params, model: DGCNN, batch: DenseGraphBatch,
                 acts: dict) -> torch.Tensor:
    """GCN stack + SortPooling → pooled [S, k, Σdims]. `x @ W1` is a plain
    matmul; the adjacency-coupled chain runs in `gcn_trunk` (the CUDA
    kernel on the card, its plain version on the CPU)."""
    gcn = params["gcn"]
    dims = tuple(model.hidden_dims)
    hw1 = torch.matmul(batch.x, gcn[0]["w"])
    wsel = torch.zeros(batch.adj.shape[0], dtype=torch.int32,
                       device=batch.adj.device)
    ws = tuple(layer["w"].unsqueeze(0) for layer in gcn[1:])
    bs = tuple(layer["b"].unsqueeze(0) for layer in gcn)
    cat = gcn_trunk(dims, batch.adj, hw1, batch.node_mask, wsel, ws, bs)
    off = 0
    for i, d in enumerate(dims):
        acts[f"gcn{i + 1}"] = cat[:, :, off : off + d]
        off += d
    pooled = sort_pool_dense(cat, batch.node_mask, model.sort_pool_k)
    acts["sort_pool"] = pooled
    return pooled


def apply_dense(
    params: Params,
    model: DGCNN,
    batch: DenseGraphBatch,
    *,
    deterministic: bool = True,
    dropout_gen: Optional[torch.Generator] = None,
    return_activations: bool = False,
):
    """Forward pass on the dense layout → log-probabilities [S, C].
    Padded slots give rows that the loss masks with `batch.graph_mask`.
    With `return_activations=True` also returns the per-stage tensors
    (`gcn1..L`, `sort_pool`, `readout`, `log_probs`)."""
    acts: dict = {}
    pooled = _dense_trunk(params, model, batch, acts)
    log_probs = _pooled_to_log_probs(
        params, model, pooled, deterministic, dropout_gen, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs


# block_impl → propagation: "pallas" is the CSR kernel (the port of
# block_pallas), "xla" the item-parallel kernel (the reference's "per-item
# products, then a destination-sorted segment-sum", written as a kernel).
# Each kernel walks its own per-batch plan (kernels/block_prop.py),
# built once here and shared by the four layers, forward and backward.
BLOCK_PROPAGATE = {
    "pallas": (block_propagate_csr, block_csr_plan),
    "xla": (block_propagate_resident, block_resident_plan),
}


def apply_block(
    params: Params,
    model: DGCNN,
    batch: BlockBatch,
    pool: torch.Tensor,
    *,
    deterministic: bool = True,
    dropout_gen: Optional[torch.Generator] = None,
    return_activations: bool = False,
    block_impl: str = "pallas",
):
    """Forward pass on the block-sparse layout (batching/block_sparse.py)
    → log-probabilities [slots, C]. Each GCN layer is `hw = h @ W` (a plain
    matmul, as the reference leaves it to XLA), the block propagation
    over the batch's work items (`block_impl`: "pallas" the CSR kernel,
    "xla" the item-parallel kernel; on CPU tensors both run the plain
    version) over the kernel's plan, built once per batch here, then bias,
    tanh and the node mask. SortPooling is the global
    lexicographic sort with the row-block prefilter (row_block = bs)."""
    if block_impl not in BLOCK_PROPAGATE:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    propagate, make_plan = BLOCK_PROPAGATE[block_impl]
    bs = pool.shape[1]
    s_nodes = batch.x.shape[0]
    nb = s_nodes // bs
    num_slots = batch.y.shape[0]
    mask = batch.node_mask[:, None]

    items = (batch.item_pool, batch.item_row, batch.item_col,
             batch.item_permT, batch.item_colT)
    plan = make_plan(*items, nb)

    acts: dict = {}
    h = batch.x
    layer_outs = []
    for i, layer in enumerate(params["gcn"]):
        hb = torch.matmul(h, layer["w"]).reshape(nb, bs, -1)
        agg = propagate(hb, pool, *items, batch.num_items, plan)
        h = torch.tanh(agg.reshape(s_nodes, -1) + layer["b"]) * mask
        layer_outs.append(h)
        acts[f"gcn{i + 1}"] = h

    cat = torch.cat(layer_outs, dim=-1)
    pooled = sort_pool(cat, batch.node_graph, num_slots, model.sort_pool_k,
                       row_block=bs)
    acts["sort_pool"] = pooled
    log_probs = _pooled_to_log_probs(
        params, model, pooled, deterministic, dropout_gen, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs


def apply_coo(
    params: Params,
    model: DGCNN,
    batch: GraphBatch,
    *,
    deterministic: bool = True,
    dropout_gen: Optional[torch.Generator] = None,
    return_activations: bool = False,
    spmm_impl: str = "xla",
):
    """Forward pass on the COO layout (batching/packer.py,
    batching/device_coo.py) → log-probabilities [slots, C]. Degrees and
    d̂^{-1/2} are computed once; each layer is `gcn_conv` in its node-scale
    form (the SpMM weighted by the edge mask) → tanh → node mask. The SpMM
    runs the kernel `spmm_impl` names (ops/spmm.py); one `EdgeOrder` of
    the batch (padded edges left out) serves the four layers' SpMMs,
    forward and backward, and a block-pair structure the packer attached
    serves "pallas", with its slot order (`block_coo_order`) built once
    here. SortPooling is the global lexicographic sort."""
    num_nodes = batch.x.shape[0]
    num_slots = batch.y.shape[0]
    deg_hat = gcn_degree(batch.edge_dst, batch.edge_mask, num_nodes)
    dinv_sqrt = torch.rsqrt(deg_hat)
    structure = w_pad = w_padT = None
    if batch.blockcoo is not None and spmm_impl == "pallas":
        structure, w_pad, w_padT = batch.blockcoo
    order = None
    if batch.x.is_cuda:
        order = (edge_order(batch.edge_src, batch.edge_dst, num_nodes,
                            edge_mask=batch.edge_mask, dst_sorted=True)
                 if structure is None else block_coo_order(structure, num_nodes))
    mask = batch.node_mask[:, None]

    acts: dict = {}
    x = batch.x
    layer_outs = []
    for i, layer in enumerate(params["gcn"]):
        x = torch.tanh(gcn_conv(
            x, layer["w"], layer["b"], batch.edge_src, batch.edge_dst,
            batch.edge_mask, deg_hat, impl=spmm_impl, node_scale=dinv_sqrt,
            structure=structure, w_pad=w_pad, w_padT=w_padT, order=order,
        )) * mask
        layer_outs.append(x)
        acts[f"gcn{i + 1}"] = x

    cat = torch.cat(layer_outs, dim=-1)
    pooled = sort_pool(cat, batch.node_graph, num_slots, model.sort_pool_k)
    acts["sort_pool"] = pooled
    log_probs = _pooled_to_log_probs(
        params, model, pooled, deterministic, dropout_gen, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs
