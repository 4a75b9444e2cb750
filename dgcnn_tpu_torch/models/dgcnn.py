"""DGCNN — the port of dgcnn_tpu/models/dgcnn.py (`DGCNN` :41,
`init_params` :88, the head :134, `apply_coo` :178, `_dense_trunk` :260,
`apply_dense` :344, `apply_multi_dense` :367, `apply_multi_dense_folds`
:683, `apply_block_folds` :864, `apply_block` :930, the layout dispatch of
`apply` :1035; the dense fold-lockstep forward, `apply` under `jax.vmap`
in dgcnn_tpu/train/cv_vmap.py:180-203):

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

Fold-lockstep: F folds' batches run through F sets of weights (every
leaf with a leading fold axis), the readout and head as batched products
over the fold axis. `apply_dense_folds` stacks the folds on one dense
batch's slot axis: one trunk-kernel call with K = F weight sets picked
per slot by `wsel`; `apply_multi_dense_folds` does so once per tile
class; `apply_block_folds` runs every fold's propagation as one call of
the block kernel over the folds' merged work-item stream.
`DGCNNFoldsNet` owns the stacked parameters and dispatches on the batch.

Mixed precision, the reference's policy (`DGCNN.compute_dtype`,
dgcnn_tpu/models/dgcnn.py:53-57): parameters, biases, the loss, Adam and
log_softmax stay fp32; under compute_dtype="bfloat16" node features,
weights at their products and each layer's output run in bf16, every
product multiplies its operands widened to fp32 with fp32 sums (the
reference's `preferred_element_type=float32`; `ops/readout.matmul_f32`),
and the propagation dtype is bf16 whenever the compute or the stored
adjacency (dense) or pool (block) is bf16 (:275-283, :967-973): the
trunk kernel and the block kernels then run their bf16 modes. The dense
layouts keep the trunk kernel under bf16 compute, with its `round_h`
flag, where the reference runs its einsum chain. The COO layout rounds
at the reference's points (dgcnn_tpu/models/dgcnn.py:213, :226, :244):
x at entry, each W_i at its product and each layer's masked output;
`h = x @ W` and all that follows it up to that rounding (the SpMM, the
self-loop term, the bias, tanh, the mask) stay fp32, as the reference's
`gcn_conv` keeps them (dgcnn_tpu/ops/gcn.py:126), so the SpMM kernels
run fp32 under either compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from dgcnn_tpu_torch.batching.block_sparse import BlockBatch, FoldBlockBatch
from dgcnn_tpu_torch.batching.dense import DenseGraphBatch
from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch
from dgcnn_tpu_torch.batching.packer import GraphBatch
from dgcnn_tpu_torch.kernels.block_csr import block_propagate_csr
from dgcnn_tpu_torch.kernels.block_csr import make_plan as block_csr_plan
from dgcnn_tpu_torch.kernels.block_resident import block_propagate_resident
from dgcnn_tpu_torch.kernels.block_resident import make_plan as block_resident_plan
from dgcnn_tpu_torch.kernels.dense_trunk import gcn_trunk
from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_order
from dgcnn_tpu_torch.ops.gcn import gcn_conv, gcn_degree
from dgcnn_tpu_torch.ops.readout import conv1d_readout, linear, matmul_f32
from dgcnn_tpu_torch.ops.spmm import edge_order
from dgcnn_tpu_torch.ops.sort_pool import sort_pool, sort_pool_dense, sort_pool_folds
from dgcnn_tpu_torch.parity.convert import fold_state

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
    # matmul operands and layer outputs in this dtype, products summed in
    # fp32; parameters, biases, softmax and the loss stay fp32
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    def prop_dtype(self, stored: torch.dtype) -> torch.dtype:
        """The propagation dtype next to an adjacency or pool stored in
        `stored`: bf16 when either it or the compute dtype is."""
        return (torch.bfloat16 if torch.bfloat16 in (stored, self.dtype)
                else torch.float32)

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


def stack_params(per_fold) -> Params:
    """F folds' parameter dicts → one dict whose leaves carry a leading
    fold axis [F, ...]."""
    first = per_fold[0]
    return {
        "gcn": [
            {n: torch.stack([p["gcn"][i][n] for p in per_fold]) for n in ("w", "b")}
            for i in range(len(first["gcn"]))
        ],
        **{
            name: {n: torch.stack([p[name][n] for p in per_fold]) for n in ("w", "b")}
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
    runs `apply_dense`, `apply_multi_dense` for a `MultiDenseBatch`,
    `apply_block` for a `BlockBatch` or `apply_coo` for a `GraphBatch` in
    `forward`."""

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
        return _module_params(self)

    def forward(self, batch, *, deterministic: bool = True,
                dropout_gen: Optional[torch.Generator] = None,
                return_activations: bool = False,
                pool: Optional[torch.Tensor] = None,
                block_impl: str = "pallas", spmm_impl: str = "xla"):
        """`batch` is a DenseGraphBatch, a MultiDenseBatch, a BlockBatch or
        a GraphBatch; a BlockBatch also needs the engine's adjacency block
        `pool` and the `block_impl` that propagates over it, a GraphBatch
        the `spmm_impl` that aggregates its edges. A MultiDenseBatch gives
        the log-probs of its classes' slots in class order, the order of
        its `y` and `graph_mask`."""
        kw = dict(deterministic=deterministic, dropout_gen=dropout_gen,
                  return_activations=return_activations)
        if isinstance(batch, MultiDenseBatch):
            return apply_multi_dense(self.params(), self.model, batch.classes, **kw)
        if isinstance(batch, GraphBatch):
            return apply_coo(self.params(), self.model, batch,
                             spmm_impl=spmm_impl, **kw)
        if isinstance(batch, BlockBatch):
            if pool is None:
                raise ValueError("a BlockBatch needs the block pool")
            return apply_block(self.params(), self.model, batch, pool,
                               block_impl=block_impl, **kw)
        return apply_dense(self.params(), self.model, batch, **kw)


def _module_params(mod: nn.Module) -> Params:
    return {
        "gcn": [{"w": layer["w"], "b": layer["b"]} for layer in mod.gcn],
        **{
            name: {"w": getattr(mod, name)["w"], "b": getattr(mod, name)["b"]}
            for name in ("conv5", "conv6", "lin1", "lin2")
        },
    }


class DGCNNFoldsNet(nn.Module):
    """F folds' models in one module, for fold-lockstep: `DGCNNNet`'s
    parameters, each with a leading fold axis
    (state_dict keys as `DGCNNNet`'s, shapes [F, ...]). Every parameter is
    a view of one flat buffer, `flat`, holding the parameters one after
    another in `parameters()` order, each a contiguous [F, ...] run, so
    that the fold-stacked Adam (train/loop.py `FoldAdam`) updates all of
    them in one pass. Build the module on its device: `.to` would copy
    the parameters out of `flat`."""

    def __init__(self, model: DGCNN, params_f: Params):
        super().__init__()
        self.model = model
        self.num_folds = int(params_f["gcn"][0]["w"].shape[0])

        def pd(d):
            return nn.ParameterDict({n: nn.Parameter(t.detach()) for n, t in d.items()})

        self.gcn = nn.ModuleList([pd(layer) for layer in params_f["gcn"]])
        self.conv5 = pd(params_f["conv5"])
        self.conv6 = pd(params_f["conv6"])
        self.lin1 = pd(params_f["lin1"])
        self.lin2 = pd(params_f["lin2"])
        params = list(self.parameters())
        self.flat = torch.cat([p.detach().reshape(-1) for p in params])
        off = 0
        for p in params:  # each parameter becomes a view of its run of `flat`
            p.data = self.flat[off : off + p.numel()].view(p.shape)
            off += p.numel()

    def params(self) -> Params:
        """The stacked parameters as the reference-shaped nested dict."""
        return _module_params(self)

    def fold_state_dict(self, fold: int) -> Dict[str, torch.Tensor]:
        """Fold `fold` (0-based) as a `DGCNNNet` state dict (copies)."""
        return fold_state(self.state_dict(), fold)

    def forward(self, batch, *, deterministic: bool = True, dropout_gens=None,
                return_activations: bool = False, pool: Optional[torch.Tensor] = None,
                block_impl: str = "pallas"):
        """`batch` holds every fold's step: a DenseGraphBatch of F × slots
        slots, a MultiDenseBatch of `num_folds` F, or a FoldBlockBatch,
        which also needs the engine's block `pool` and the `block_impl`
        that propagates over it. Log-probs [F, slots, C]."""
        kw = dict(deterministic=deterministic, dropout_gens=dropout_gens,
                  return_activations=return_activations)
        if isinstance(batch, MultiDenseBatch):
            if batch.num_folds != self.num_folds:
                raise ValueError(f"a batch of {batch.num_folds} folds for "
                                 f"{self.num_folds} folds' weights")
            return apply_multi_dense_folds(self.params(), self.model, batch.classes,
                                           self.num_folds, **kw)
        if isinstance(batch, FoldBlockBatch):
            if pool is None:
                raise ValueError("a FoldBlockBatch needs the block pool")
            return apply_block_folds(self.params(), self.model, batch, pool,
                                     block_impl=block_impl, **kw)
        return apply_dense_folds(self.params(), self.model, batch, self.num_folds, **kw)


def _fold_uniform(h: torch.Tensor, gens) -> torch.Tensor:
    """U[0, 1) noise shaped like h [F, B, D]: fold f's [B, D] drawn from
    gens[f] (the bits `torch.rand` gives that generator), zeros for a fold
    whose generator is None (it draws nothing)."""
    u = torch.zeros_like(h)
    for f, gen in enumerate(gens):
        if gen is not None:
            u[f].uniform_(0.0, 1.0, generator=gen)
    return u


def _pooled_to_log_probs(
    params: Params,
    model: DGCNN,
    pooled: torch.Tensor,  # [B, k, C]
    deterministic: bool,
    dropout_gen: Optional[torch.Generator],
    acts: dict,
) -> torch.Tensor:
    """conv1d readout → MLP head → log_softmax. With fold-stacked
    parameters `pooled` is [F, B, k, C] and `dropout_gen` a list of F
    generators (None for a fold that draws nothing). Runs in `pooled`'s
    dtype (the compute dtype) at every product's operands: the weights
    are cast to it, the biases stay fp32, dropout acts on the fp32 h and
    the logits are fp32."""
    dt = pooled.dtype
    feats = conv1d_readout(
        pooled,
        params["conv5"]["w"].to(dt), params["conv5"]["b"],
        params["conv6"]["w"].to(dt), params["conv6"]["b"],
    )
    acts["readout"] = feats
    h = torch.relu(linear(feats.to(dt), params["lin1"]["w"].to(dt),
                          params["lin1"]["b"]))
    if not deterministic:
        if dropout_gen is None:
            raise ValueError("dropout_gen required when deterministic=False")
        keep = 1.0 - model.dropout_rate
        if isinstance(dropout_gen, torch.Generator):
            u = torch.rand(h.shape, generator=dropout_gen, device=h.device)
        else:
            u = _fold_uniform(h, dropout_gen)
        mask = u < keep
        acts["dropout_keep"] = mask
        h = torch.where(mask, h / keep, torch.zeros_like(h))
    logits = linear(h.to(dt), params["lin2"]["w"].to(dt), params["lin2"]["b"])
    log_probs = torch.log_softmax(logits, dim=-1)
    acts["log_probs"] = log_probs
    return log_probs


def _dense_trunk(params: Params, model: DGCNN, batch: DenseGraphBatch,
                 acts: dict) -> torch.Tensor:
    """GCN stack + SortPooling → pooled [S, k, Σdims] in the compute dtype.
    `x @ W1` is a plain matmul (`matmul_f32`); the adjacency-coupled chain
    runs in `gcn_trunk` (the CUDA kernel on the card, its plain version
    on the CPU) at the propagation dtype, and under bf16 compute with W_i
    rounded to bf16 and `round_h` (each layer's h rounded, where the
    reference's chain rounds). Fold-stacked parameters (leaves [F, ...])
    take the S slots as F runs of S/F, one per fold: `x @ W1` per fold as
    one batched product, and one trunk call with K = F weight sets, slot s
    reading set s // (S/F)."""
    gcn = params["gcn"]
    dims = tuple(model.hidden_dims)
    dt = model.dtype
    adj = batch.adj.to(model.prop_dtype(batch.adj.dtype))
    x = batch.x.to(dt)
    s, dev = adj.shape[0], adj.device
    if gcn[0]["w"].dim() == 3:
        f = gcn[0]["w"].shape[0]
        if s % f:
            raise ValueError(f"{s} slots do not split into {f} folds")
        hw1 = matmul_f32(x.reshape(f, -1, x.shape[-1]), gcn[0]["w"].to(dt)).reshape(
            s, x.shape[1], -1)
        wsel = torch.arange(f, dtype=torch.int32, device=dev)[:, None].expand(
            f, s // f).reshape(-1)
        ws = tuple(layer["w"].to(dt).float() for layer in gcn[1:])
        bs = tuple(layer["b"] for layer in gcn)
    else:
        hw1 = matmul_f32(x, gcn[0]["w"].to(dt))
        wsel = torch.zeros(s, dtype=torch.int32, device=dev)
        ws = tuple(layer["w"].to(dt).float().unsqueeze(0) for layer in gcn[1:])
        bs = tuple(layer["b"].unsqueeze(0) for layer in gcn)
    cat = gcn_trunk(dims, adj, hw1, batch.node_mask.float(), wsel, ws, bs,
                    round_h=dt == torch.bfloat16).to(dt)
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


def apply_multi_dense(
    params: Params,
    model: DGCNN,
    batches: Tuple[DenseGraphBatch, ...],
    *,
    deterministic: bool = True,
    dropout_gen: Optional[torch.Generator] = None,
    return_activations: bool = False,
):
    """Forward over one batch split by tile class (batching/multi_dense.py):
    each class runs the dense trunk at its own tile (`_dense_trunk`: the
    trunk kernel on the card), the pooled rows are concatenated in class
    order, and the readout and head run once over the union, so dropout
    draws one [ΣS_c, dense_dim] mask. A class with no graph in the batch
    still runs (its slots are masked), so every batch has the same work.
    Returns the log-probs of the class slots in class order, the order of
    `MultiDenseBatch.y` and `.graph_mask` (the reference returns those two
    beside the log-probs; here the batch carries them); with
    `return_activations=True` also the per-stage tensors, a class's
    tagged `_c<i>`."""
    acts: dict = {}
    pooled = []
    for i, b in enumerate(batches):
        class_acts: dict = {}
        pooled.append(_dense_trunk(params, model, b, class_acts))
        acts.update({f"{k}_c{i}": v for k, v in class_acts.items()})
    log_probs = _pooled_to_log_probs(
        params, model, torch.cat(pooled), deterministic, dropout_gen, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs


def _check_folds(params_f: Params, num_folds: int, deterministic: bool,
                 dropout_gens) -> None:
    if params_f["gcn"][0]["w"].shape[0] != num_folds:
        raise ValueError(f"parameters hold {params_f['gcn'][0]['w'].shape[0]} "
                         f"folds, not {num_folds}")
    if not deterministic and (dropout_gens is None
                              or len(dropout_gens) != num_folds):
        raise ValueError(f"dropout needs {num_folds} generators (None for a "
                         f"fold that draws nothing)")


def apply_dense_folds(
    params_f: Params,
    model: DGCNN,
    batch: DenseGraphBatch,
    num_folds: int,
    *,
    deterministic: bool = True,
    dropout_gens=None,
    return_activations: bool = False,
):
    """Fold-lockstep forward on the dense layout → log-probabilities
    [F, slots, C]. `params_f` is the reference-shaped dict with a leading
    fold axis F = `num_folds` on every leaf; `batch` holds F × slots graph
    slots, fold f's in slots [f·slots, (f+1)·slots) (`gather_dense_batch`
    of the flattened [F, slots] index row; a −1 slot is masked). Each
    fold's graphs meet only that fold's weights: fold f's log-probs are
    `apply_dense` of fold f's weights on its slots. With dropout on,
    `dropout_gens[f]` draws fold f's [slots, dense_dim] mask exactly as
    the sequential driver's generator for that fold does; None for a fold
    with no real graph in the step (it draws nothing)."""
    _check_folds(params_f, num_folds, deterministic, dropout_gens)
    acts: dict = {}
    pooled = _dense_trunk(params_f, model, batch, acts)
    pooled = pooled.reshape(num_folds, -1, *pooled.shape[1:])
    log_probs = _pooled_to_log_probs(
        params_f, model, pooled, deterministic, dropout_gens, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs


def apply_multi_dense_folds(
    params_f: Params,
    model: DGCNN,
    batches: Tuple[DenseGraphBatch, ...],
    num_folds: int,
    *,
    deterministic: bool = True,
    dropout_gens=None,
    return_activations: bool = False,
):
    """Fold-lockstep forward over one batch split by tile class → log-probs
    [F, ΣS_c, C]. Class c's batch holds F × S_c slots, fold f's in the
    f-th run of S_c (`gather_dense_batch` of the class's flattened [F, S_c]
    index rows); each class runs `_dense_trunk` once on its flat slot axis
    with K = F weight sets (the trunk kernel on the card), the pooled rows
    concatenate per fold in class order, and the readout and head run once
    per fold over the union: fold f's log-probs are `apply_multi_dense` of
    fold f's weights on its slots, in the order of `MultiDenseBatch.y` of
    the folds. With dropout on, `dropout_gens[f]` draws fold f's
    [ΣS_c, dense_dim] mask as the sequential driver's generator does."""
    _check_folds(params_f, num_folds, deterministic, dropout_gens)
    acts: dict = {}
    pooled = []
    for i, b in enumerate(batches):
        class_acts: dict = {}
        p = _dense_trunk(params_f, model, b, class_acts)
        pooled.append(p.reshape(num_folds, -1, *p.shape[1:]))
        acts.update({f"{k}_c{i}": v for k, v in class_acts.items()})
    log_probs = _pooled_to_log_probs(
        params_f, model, torch.cat(pooled, dim=1), deterministic, dropout_gens, acts
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


def _block_chain(params: Params, model: DGCNN, batch, pool: torch.Tensor,
                 block_impl: str, acts: dict) -> torch.Tensor:
    """The four GCN layers over a block batch → their outputs concatenated
    on the last axis, in the compute dtype. Each layer is `hw = h @ W` (a
    plain matmul in fp32 from compute-dtype operands, as the reference
    leaves it to XLA), rounded to the propagation dtype, the propagation
    `block_impl` names over the batch's work items, walking the kernel's
    plan built once here for the four layers, forward and backward, then
    bias, tanh and the node mask. The pool must be stored at the
    propagation dtype (the engines store it so; the kernels take hb and
    the pool in one dtype). A `FoldBlockBatch` (node arrays [F, S, ·],
    fold-stacked weights) runs `h @ W` as one batched product and the
    propagation once over the merged stream of nb' = F·nb block-rows."""
    if block_impl not in BLOCK_PROPAGATE:
        raise ValueError(f"unknown block_impl {block_impl!r}")
    dt, prop = model.dtype, model.prop_dtype(pool.dtype)
    if pool.dtype != prop:
        raise TypeError(f"a {pool.dtype} pool under compute_dtype="
                        f"{model.compute_dtype!r}: store the pool at the propagation "
                        f"dtype, {prop}")
    propagate, make_plan = BLOCK_PROPAGATE[block_impl]
    bs = pool.shape[1]
    nodes = batch.x.shape[:-1]  # [S] or [F, S]
    nb = nodes.numel() // bs
    mask = batch.node_mask[..., None]
    items = (batch.item_pool, batch.item_row, batch.item_col,
             batch.item_permT, batch.item_colT)
    plan = make_plan(*items, nb)
    h = batch.x.to(dt)
    layer_outs = []
    for i, layer in enumerate(params["gcn"]):
        hb = matmul_f32(h, layer["w"].to(dt)).to(prop).reshape(nb, bs, -1)
        agg = propagate(hb, pool, *items, batch.num_items, plan)
        b = layer["b"] if len(nodes) == 1 else layer["b"][:, None, :]
        h = (torch.tanh(agg.reshape(*nodes, -1) + b) * mask).to(dt)
        layer_outs.append(h)
        acts[f"gcn{i + 1}"] = h
    return torch.cat(layer_outs, dim=-1)


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
    → log-probabilities [slots, C]. The GCN layers are `_block_chain`'s
    (`block_impl`: "pallas" the CSR kernel, "xla" the item-parallel
    kernel; on CPU tensors both run the plain version). SortPooling is the
    global lexicographic sort with the row-block prefilter (row_block =
    bs)."""
    acts: dict = {}
    cat = _block_chain(params, model, batch, pool, block_impl, acts)
    pooled = sort_pool(cat, batch.node_graph, batch.y.shape[0], model.sort_pool_k,
                       row_block=pool.shape[1])
    acts["sort_pool"] = pooled
    log_probs = _pooled_to_log_probs(
        params, model, pooled, deterministic, dropout_gen, acts
    )
    if return_activations:
        return log_probs, acts
    return log_probs


def apply_block_folds(
    params_f: Params,
    model: DGCNN,
    batch: FoldBlockBatch,
    pool: torch.Tensor,
    *,
    deterministic: bool = True,
    dropout_gens=None,
    return_activations: bool = False,
    block_impl: str = "pallas",
):
    """Fold-lockstep forward on the block-sparse layout → log-probabilities
    [F, slots, C]. `params_f` carries a leading fold axis F on every leaf;
    each fold's node-side ops run on its own [S] axis with its own
    weights, and every layer's propagation runs once for all folds over
    the batch's merged work-item stream (`_block_chain`: one plan for the
    four layers, both directions). SortPooling is `sort_pool_folds` with
    the row-block prefilter, as `apply_block` pools one batch (the
    reference's lockstep sorts without it: the same rows). Fold f's
    log-probs are `apply_block` of fold f's weights on its batch; with
    dropout on, `dropout_gens[f]` draws fold f's [slots, dense_dim] mask
    as the sequential driver's generator does."""
    num_folds, num_slots = batch.y.shape
    _check_folds(params_f, num_folds, deterministic, dropout_gens)
    acts: dict = {}
    cat = _block_chain(params_f, model, batch, pool, block_impl, acts)
    pooled = sort_pool_folds(cat, batch.node_graph, num_slots, model.sort_pool_k,
                             row_block=pool.shape[1])
    acts["sort_pool"] = pooled
    log_probs = _pooled_to_log_probs(
        params_f, model, pooled, deterministic, dropout_gens, acts
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
    the batch (padded edges left out; with each position's column, so the
    edge-stream kernels gather h without a perm → col chain) serves the
    four layers' SpMMs, forward and backward, and a block-pair structure
    the packer attached serves "pallas", with its slot order
    (`block_coo_order`) built once here. SortPooling is the global
    lexicographic sort. Under bf16 compute x enters and each layer's
    masked output leaves in bf16, and each W_i is rounded to bf16 at its
    product (`gcn_conv`); the product is summed in fp32 and the SpMM runs
    fp32, as in the reference's `apply_coo`. The engines hand x over in
    fp32, as the reference's packers do."""
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
    dt = model.dtype
    x = batch.x.to(dt)
    layer_outs = []
    for i, layer in enumerate(params["gcn"]):
        x = (torch.tanh(gcn_conv(
            x, layer["w"].to(dt), layer["b"], batch.edge_src, batch.edge_dst,
            batch.edge_mask, deg_hat, impl=spmm_impl, node_scale=dinv_sqrt,
            structure=structure, w_pad=w_pad, w_padT=w_padT, order=order,
        )) * mask).to(dt)
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


def apply(params: Params, model: DGCNN, batch, **kwargs):
    """Layout-polymorphic forward (the reference's `apply`,
    dgcnn_tpu/models/dgcnn.py:1035): a `DenseGraphBatch` goes to
    `apply_dense` (its `spmm_impl` dropped), anything else to `apply_coo`."""
    if isinstance(batch, DenseGraphBatch):
        kwargs.pop("spmm_impl", None)
        return apply_dense(params, model, batch, **kwargs)
    return apply_coo(params, model, batch, **kwargs)
