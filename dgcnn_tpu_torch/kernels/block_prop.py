"""What the two block-propagation kernels share: the contract, its input
checks, the plain PyTorch version, the transposed item lists of the
backward, and the autograd packaging.

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]   r < nb
    hb [nb, bs, F] fp32, pool [P+1, bs, bs] fp32 (row P = zeros), out [nb, bs, F]
    transpose:  out[c] = Σ_{w in col-major order, item_colT = c} pool[ipT_w]ᵀ @ g[rT_w]

bs = 128 and F = 1..128. `item_row` is non-decreasing; padded items carry
segment id ≥ nb and fall outside every row; rows no item visits are exact
zeros. The backward runs the same product transposed over the build-time
col-major traversal (`transposed_items`), as the reference's custom VJPs
do; the pool is training-constant and gets no cotangent.

kernels/block_csr.py (the port of block_pallas) and
kernels/block_resident.py (the port of block_resident) each bind their
CUDA kernel into `make_block_prop_fn`; on a CPU tensor both run
`block_propagate_plain`, and on a CUDA tensor the kernel or an exception.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

BS = 128
MAX_F = 128


def check_inputs(hb, pool, item_pool, item_row, item_col, item_permT,
                 item_colT, num_items) -> Tuple[int, int]:
    """Validate everything the kernels rely on; returns (nb, F)."""
    if hb.dim() != 3 or hb.shape[1] != BS or not 1 <= hb.shape[2] <= MAX_F:
        raise ValueError(
            f"hb must be [nb, {BS}, F] with F in 1..{MAX_F}, got {tuple(hb.shape)}"
        )
    if pool.dim() != 3 or tuple(pool.shape[1:]) != (BS, BS) or pool.shape[0] < 1:
        raise ValueError(f"pool must be [P+1, {BS}, {BS}], got {tuple(pool.shape)}")
    for t in (hb, pool):
        if t.dtype != torch.float32:
            raise TypeError(f"hb and pool must be float32, got {t.dtype}")
    items = (item_pool, item_row, item_col, item_permT, item_colT)
    for t in (*items, num_items):
        if t.dtype != torch.int32:
            raise TypeError(f"item lists and num_items must be int32, got {t.dtype}")
    w = item_pool.shape[0]
    for t in items:
        if t.dim() != 1 or t.shape[0] != w:
            raise ValueError(f"item lists must all be [W={w}], got {tuple(t.shape)}")
    if num_items.numel() != 1:
        raise ValueError(f"num_items must hold one count, got {tuple(num_items.shape)}")
    dev = hb.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block propagation runs on cpu or cuda, got {dev}")
    for t in (pool, *items, num_items):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    for t in (hb, pool, *items):
        if not t.is_contiguous():
            raise ValueError(
                "block propagation inputs must be contiguous (hb = (h @ W)"
                ".reshape(nb, bs, F) of a row-major [nb·bs, F] h is)"
            )
    return hb.shape[0], hb.shape[2]


def block_propagate_plain(hb: torch.Tensor, pool: torch.Tensor,
                          item_pool: torch.Tensor, seg: torch.Tensor,
                          src: torch.Tensor, transpose: bool = False
                          ) -> torch.Tensor:
    """The kernels' function in plain PyTorch: gather the items' blocks,
    one batched product, then a segment sum over `seg` (ids ≥ nb are
    dropped). `transpose` multiplies by each block's transpose."""
    nb, bs, f = hb.shape
    blocks = pool[item_pool.long()]
    if transpose:
        blocks = blocks.mT
    parts = torch.bmm(blocks, hb[src.long()])
    out = hb.new_zeros((nb + 1, bs, f))
    out.index_add_(0, seg.long().clamp(max=nb), parts)
    return out[:nb]


def transposed_items(item_pool: torch.Tensor, item_row: torch.Tensor,
                     item_permT: torch.Tensor, nb: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ipT, rT) of the col-major traversal: pool ids and source rows in
    `item_colT` order. Padded items (identity permutation, row nb) get
    their source clamped to nb-1; their pool id is the zero block and
    their segment nb, so they add nothing."""
    perm = item_permT.long()
    ipT = item_pool[perm].contiguous()
    rT = item_row[perm].clamp(max=nb - 1).contiguous()
    return ipT, rT


def row_ptr(seg: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb+1] int32 CSR pointers into a non-decreasing segment-id vector;
    ids ≥ nb fall outside every range (the reference's `_row_ptr`)."""
    bounds = torch.arange(nb + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds, side="left", out_int32=True)


Launch = Callable[..., torch.Tensor]


def make_block_prop_fn(name: str, launch: Launch) -> type:
    """An autograd Function around one kernel. `launch(hb, pool, ip, seg,
    src, num_items, transpose)` runs the kernel on CUDA tensors (and
    counts the launch); CPU tensors run `block_propagate_plain`. Gradients
    flow to hb only."""

    def forward(hb, pool, item_pool, item_row, item_col, item_permT,
                item_colT, num_items):
        check_inputs(hb, pool, item_pool, item_row, item_col, item_permT,
                     item_colT, num_items)
        if hb.is_cuda:
            return launch(hb, pool, item_pool, item_row, item_col, num_items,
                          False)
        return block_propagate_plain(hb, pool, item_pool, item_row, item_col)

    def setup_context(ctx, inputs, output):
        _hb, pool, item_pool, item_row, _col, item_permT, item_colT, n = inputs
        ctx.save_for_backward(pool, item_pool, item_row, item_permT,
                              item_colT, n)

    def backward(ctx, g):
        pool, item_pool, item_row, item_permT, item_colT, n = ctx.saved_tensors
        g = g.contiguous()
        ipT, rT = transposed_items(item_pool, item_row, item_permT, g.shape[0])
        if g.is_cuda:
            d_hb = launch(g, pool, ipT, item_colT, rT, n, True)
        else:
            d_hb = block_propagate_plain(g, pool, ipT, item_colT, rT,
                                         transpose=True)
        return (d_hb,) + (None,) * 7

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
    })

