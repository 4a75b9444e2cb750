"""SortPooling for the dense layout — the port of
dgcnn_tpu/ops/sort_pool.py:233 `sort_pool_dense`."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sort_pool_dense(x: torch.Tensor, node_mask: torch.Tensor, k: int) -> torch.Tensor:
    """[B, n, C] → [B, k, C]: each graph's k nodes with the largest last
    channel, in descending order.

    Equal keys keep the lower node index first (PyG's stable descending
    sort, the reference's `lax.top_k`): a STABLE descending sort, not
    `torch.topk`, whose tie order on CUDA is unspecified. Masked nodes
    key at −inf; rows whose key is not finite (graphs with fewer than k
    real nodes) are zeroed. A node axis shorter than k is zero-padded.
    Selection is a gather: each output row is exactly one input row, and
    the indices of a row are distinct, so its backward adds each gradient
    once (deterministic on the card)."""
    if x.shape[1] < k:
        pad = k - x.shape[1]
        x = F.pad(x, (0, 0, 0, pad))
        node_mask = F.pad(node_mask, (0, pad))
    key = torch.where(
        node_mask > 0, x[..., -1].to(torch.float32),
        torch.full_like(node_mask, float("-inf"), dtype=torch.float32),
    )
    vals, order = torch.sort(key, dim=1, descending=True, stable=True)
    top_val, top_idx = vals[:, :k], order[:, :k]
    pooled = torch.gather(
        x, 1, top_idx[..., None].expand(-1, -1, x.shape[2])
    )
    return torch.where(torch.isfinite(top_val)[..., None], pooled,
                       torch.zeros_like(pooled))
