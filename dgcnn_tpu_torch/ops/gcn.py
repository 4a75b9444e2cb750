"""GCN convolution with symmetric normalization — the port of
dgcnn_tpu/ops/gcn.py (`gcn_degree` :47, `gcn_edge_weights` :73,
`gcn_conv` :93). PyG GCNConv defaults (normalize, add_self_loops, bias):

    X' = D̂^{-1/2} (A + I) D̂^{-1/2} X Θ + b,   D̂ = deg(A) + I

as H = XΘ, the SpMM over the edges, and the self-loop term d̂^{-1}·H added
densely (no self-loop edges are stored). Degrees come from the masked
edge stream, so padded edges and nodes fall out.
"""

from __future__ import annotations

from typing import Optional

import torch

from dgcnn_tpu_torch.ops.readout import matmul_f32
from dgcnn_tpu_torch.ops.spmm import EdgeOrder, spmm


def gcn_degree(edge_dst, edge_mask, num_nodes: int) -> torch.Tensor:
    """d̂ = in-degree over real edges + 1 (the re-added self-loop). A sum
    of 0/1 masks: exact in any order below 2^24, so the index_add_'s
    atomics on the card give the same bits on every run."""
    deg = edge_mask.new_zeros(num_nodes)
    deg.index_add_(0, edge_dst.long(), edge_mask)
    return deg + 1.0


def gcn_edge_weights(edge_src, edge_dst, edge_mask, deg_hat) -> torch.Tensor:
    """Per-edge symmetric-normalization coefficients, 0 on padded edges."""
    dinv_sqrt = torch.rsqrt(deg_hat)
    return dinv_sqrt[edge_src.long()] * dinv_sqrt[edge_dst.long()] * edge_mask


def gcn_conv(x, weight, bias, edge_src, edge_dst, edge_weight, deg_hat,
             impl: str = "xla", node_scale: Optional[torch.Tensor] = None,
             structure=None, w_pad=None, w_padT=None,
             order: Optional[EdgeOrder] = None) -> torch.Tensor:
    """One GCNConv layer given precomputed edge weights and degrees (shared
    by the four layers of the DGCNN). With `node_scale` (= d̂^{-1/2}) the
    normalization runs as two node-row scalings around a SpMM weighted by
    `edge_weight`, which is then the raw edge mask:
    Σ_e s_src·s_dst·mask·h[src] = s_dst·Σ_e mask·(s·h)[src].
    `structure`/`w_pad`/`w_padT` serve `impl` "pallas" (they must encode
    the same weights); `order` serves the edge-stream kernels. `x` and
    `weight` may be bf16 (bf16 compute): their product is summed in fp32
    (`matmul_f32`) and the rest of the layer runs fp32, as the reference's
    `preferred_element_type=float32` product leaves it."""
    h = matmul_f32(x, weight)
    kw = dict(impl=impl, structure=structure, w_pad=w_pad, w_padT=w_padT,
              order=order)
    if node_scale is not None:
        s = node_scale[:, None]
        agg = spmm(edge_src, edge_dst, edge_weight, h * s, h.shape[0], **kw) * s
    else:
        agg = spmm(edge_src, edge_dst, edge_weight, h, h.shape[0], **kw)
    agg = agg + h * (1.0 / deg_hat)[:, None]
    return agg + bias
