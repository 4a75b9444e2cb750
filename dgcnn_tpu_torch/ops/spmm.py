"""SpMM over COO edges — the port of dgcnn_tpu/ops/spmm.py (`spmm_xla`
:33, `sddmm_xla` :153, the dispatcher `spmm` :242):

    out[i] = Σ_{e: dst_e = i} w_e · h[src_e]

`spmm_plain` (gather, scale, then `index_add_` by destination) is the one
plain version the three SpMM kernels are held against; `sddmm_plain` is
the edge-weight cotangent ⟨a[src_e], b[dst_e]⟩. `EdgeOrder` is the pair of
orderings the two edge-stream kernels walk, built once per batch by
`edge_order` and shared by the four GCN layers, forward and backward; the
block-COO kernel walks one over a block-pair structure's slots
(kernels/spmm_block_coo.py `block_coo_order`).

The dispatcher chooses by name, one hand-written kernel each, where the
reference chose by TPU VMEM gates (`block_coo_fits`,
`spmm_pallas_fits`, `spmm_pallas_mxu_fits`, `_ONEHOT_MAX_NF`) that mean
nothing on the card:

  * "xla": the row-parallel CSR kernel (kernels/spmm_pallas.py
    `spmm_pallas`, the port of the per-edge Pallas kernel), the
    reference's "gather, then destination-sorted segment sum" as a kernel;
  * "onehot": the edge-block kernel (`spmm_pallas_mxu`, the port of the
    one-hot selector kernel);
  * "pallas": the block-COO kernel (kernels/spmm_block_coo.py) on batches
    that carry a block-pair structure, else the CSR kernel.

"auto" is resolved above this layer (`Config.resolved_spmm_impl()`, the
port's H100 choice); the dispatcher takes the concrete names only.

On CPU tensors every name runs the plain version; on CUDA tensors the
kernel, or it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

IMPLS = ("xla", "onehot", "pallas")


def spmm_plain(edge_src, edge_dst, edge_weight, h, num_nodes: int) -> torch.Tensor:
    """Gather h[src], scale by w, add into row dst (ids past num_nodes
    would raise: the packer's padded edges point at N−1 with weight 0)."""
    out = h.new_zeros((num_nodes, h.shape[1]))
    return out.index_add_(0, edge_dst.long(), h[edge_src.long()] * edge_weight[:, None])


def sddmm_plain(edge_src, edge_dst, a, b) -> torch.Tensor:
    """out[e] = ⟨a[src_e], b[dst_e]⟩ — the SpMM's weight cotangent."""
    return (a[edge_src.long()] * b[edge_dst.long()]).sum(-1)


@dataclasses.dataclass
class EdgeOrder:
    """Two orderings of an edge stream, int32 tensors on its device:

    perm:      [E] edge at each position of the destination order, or None
               when the stream is already destination-sorted (identity)
    row_ptr:   [N+1] position range of each destination row
    permT:     [E] edge at each position of the source order (stable)
    row_ptrT:  [N+1] position range of each source row
    col:       [E] source of the edge at each destination-order position
               (src[perm]; the stream's src itself when perm is None)
    colT:      [E] destination of the edge at each source-order position
               (dst[permT])

    Edges left out (a mask of 0) fall past row_ptr[N] and row_ptrT[N]; col
    and colT are only read before those. The edge-stream kernels read the
    column of each position from col / colT, so that their h gathers wait
    on one index read; an order built without them (None) gets them from
    the wrapper before a launch."""

    perm: Optional[torch.Tensor]
    row_ptr: torch.Tensor
    permT: torch.Tensor
    row_ptrT: torch.Tensor
    col: Optional[torch.Tensor] = None
    colT: Optional[torch.Tensor] = None


def position_columns(order: EdgeOrder, edge_src, edge_dst) -> EdgeOrder:
    """`order` with col / colT filled in where they are None (one gather
    each; none for col when perm is None)."""
    col, colT = order.col, order.colT
    if col is not None and colT is not None:
        return order
    if col is None:
        col = edge_src if order.perm is None else edge_src.index_select(0, order.perm)
    if colT is None:
        colT = edge_dst.index_select(0, order.permT)
    return dataclasses.replace(order, col=col, colT=colT)


def _ranges(sorted_key: torch.Tensor, num_nodes: int) -> torch.Tensor:
    bounds = torch.arange(num_nodes + 1, dtype=sorted_key.dtype,
                          device=sorted_key.device)
    return torch.searchsorted(sorted_key, bounds, side="left", out_int32=True)


def edge_order(edge_src, edge_dst, num_nodes: int, edge_mask=None,
               dst_sorted: bool = False) -> EdgeOrder:
    """Both orderings, by stable device sorts (deterministic). With
    `edge_mask`, edges of mask 0 are left out of both (valid for weights
    that vanish there, as the GCN's edge-mask weights do). `dst_sorted`
    promises that the kept edges come first in destination order — true of
    the packer's streams, whose padding sits at the tail — and skips that
    sort; `col` is then `edge_src` itself (when it is int32), no copy."""
    i32 = torch.int32
    src0 = src = edge_src.to(i32)
    dst0 = dst = edge_dst.to(i32)
    if edge_mask is not None:
        keep = edge_mask > 0
        dst = torch.where(keep, dst, num_nodes)
        src = torch.where(keep, src, num_nodes)
    if dst_sorted:
        perm, dst_s = None, dst
    else:
        dst_s, perm = torch.sort(dst, stable=True)
        perm = perm.to(i32)
    src_s, permT = torch.sort(src, stable=True)
    return position_columns(
        EdgeOrder(perm=perm, row_ptr=_ranges(dst_s, num_nodes),
                  permT=permT.to(i32), row_ptrT=_ranges(src_s, num_nodes)),
        src0, dst0)


def spmm(edge_src, edge_dst, edge_weight, h, num_nodes: int, impl: str = "xla",
         structure=None, w_pad=None, w_padT=None,
         order: Optional[EdgeOrder] = None, edge_group=None) -> torch.Tensor:
    """`out[i] = Σ_{dst_e=i} w_e·h[src_e]` through the kernel `impl` names
    (module docstring). `structure`/`w_pad`/`w_padT` (the packer's
    `add_blockcoo`) serve "pallas" and must encode `edge_weight`; `order`
    serves the kernel that runs: `edge_order`'s for the edge-stream
    kernels, `block_coo_order`'s for the block-COO kernel when a structure
    is given. Each kernel builds its own when it is None.

    `edge_group` (a process group; the reference's `edge_axis`): the edge
    stream is this rank's contiguous chunk of one batch's, h the whole
    node block, the same on every rank of the group. The chunk runs
    through the edge-stream kernel `impl` names ("pallas" without a
    structure: the row kernel), and one sum over the group rebuilds the
    aggregate; the backward sums dh over the group, since the true dh is
    Σ_g A_gᵀ·dout (kernels/spmm_pallas.py). The block-COO kernel never
    runs on an edge chunk, as in the reference."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import spmm_block_coo
    from dgcnn_tpu_torch.kernels.spmm_pallas import spmm_pallas, spmm_pallas_mxu

    if impl not in IMPLS:
        raise ValueError(f"unknown spmm impl {impl!r} (one of {IMPLS})")
    if h.shape[0] != num_nodes:
        raise ValueError(f"h has {h.shape[0]} rows, num_nodes is {num_nodes}")
    if impl == "pallas" and structure is not None:
        if edge_group is not None:
            raise ValueError("the block-COO kernel does not run on an edge chunk")
        if w_pad is None or w_padT is None:
            raise ValueError("a block-COO structure needs w_pad and w_padT")
        return spmm_block_coo(structure, w_pad, w_padT, h, order)
    if impl == "onehot":
        return spmm_pallas_mxu(edge_src, edge_dst, edge_weight, h, order, edge_group)
    return spmm_pallas(edge_src, edge_dst, edge_weight, h, order, edge_group)
