"""What the two block-propagation kernels share: the contract, its input
checks, the plain PyTorch version, the transposed item lists of the
backward, and the autograd packaging.

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]   r < nb
    hb [nb, bs, F], pool [P+1, bs, bs] (row P = zeros), out [nb, bs, F] fp32
    transpose:  out[c] = Σ_{w in col-major order, item_colT = c} pool[ipT_w]ᵀ @ g[rT_w]

hb and pool share one dtype, float32 or bfloat16 (the engines store the
pool at the propagation dtype, as the reference's do); the output is
fp32 either way. In bf16 the products of two bf16 values are exact and
sum in fp32 (the reference's `preferred_element_type=float32`), and the
backward rounds its cotangent to bf16 before the transposed product and
returns d_hb in hb's dtype (dgcnn_tpu/models/dgcnn.py:449-463).

bs = 128 and F = 1..128. `item_row` is non-decreasing; padded items carry
segment id ≥ nb and fall outside every row; rows no item visits are exact
zeros. The backward runs the same product transposed over the build-time
col-major traversal (`transposed_items`), as the reference's custom VJPs
do; the pool is training-constant and gets no cotangent.

kernels/block_csr.py (the port of block_pallas) and
kernels/block_resident.py (the port of block_resident) each bind their
CUDA kernel into `make_block_prop_fn`; on a CPU tensor both run
`block_propagate_plain`, and on a CUDA tensor the kernel or an exception.

Each kernel walks a per-batch `BlockPlan` that holds both directions'
item lists and the kernel's tables, built once per batch
(`plan_pieces` for the CSR kernel, `plan_groups` for the item-parallel
one; models/dgcnn.py apply_block builds it and hands it to the four
layers, forward and backward). Both are torch ops on the batch's device
with shapes set by the budgets: no host sync, nothing that changes with a
batch's real counts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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
    if hb.dtype != pool.dtype or hb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hb and pool must share a dtype, float32 or bfloat16; "
                        f"got {hb.dtype} and {pool.dtype}")
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
    dropped). `transpose` multiplies by each block's transpose. bf16
    operands are widened to fp32 (exactly) and multiplied there; the
    result is fp32."""
    nb, bs, f = hb.shape
    blocks = pool[item_pool.long()].float()
    if transpose:
        blocks = blocks.mT
    parts = torch.bmm(blocks, hb[src.long()].float())
    out = torch.zeros((nb + 1, bs, f), dtype=torch.float32, device=hb.device)
    out.index_add_(0, seg.long().clamp(max=nb), parts)
    return out[:nb]


def transposed_items(item_pool: torch.Tensor, item_row: torch.Tensor,
                     item_permT: torch.Tensor, nb: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ipT, rT) of the col-major traversal: pool ids and source rows in
    `item_colT` order. Padded items (identity permutation, row nb) get
    their source clamped to nb-1; their pool id is the zero block and
    their segment nb, so they add nothing."""
    ipT = item_pool.index_select(0, item_permT)
    rT = item_row.index_select(0, item_permT).clamp_(max=nb - 1)
    return ipT, rT


def row_ptr(seg: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb+1] int32 CSR pointers into a non-decreasing segment-id vector;
    ids ≥ nb fall outside every range (the reference's `_row_ptr`)."""
    bounds = torch.arange(nb + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, bounds, side="left", out_int32=True)


@dataclasses.dataclass(frozen=True)
class Direction:
    """One direction of a propagation: its item lists in segment order
    (`ip` pool ids, `seg` destination rows, non-decreasing, ≥ nb on
    padding; `src` source rows) and the rows' item ranges `row_ptr`
    [nb+1]. The CSR kernel's plan adds `piece_ptr` [nb+1]: row r's pieces
    are piece_ptr[r] .. piece_ptr[r+1]-1."""

    ip: torch.Tensor
    seg: torch.Tensor
    src: torch.Tensor
    row_ptr: torch.Tensor
    piece_ptr: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A batch's plan for one kernel: `kind` "pieces" (CSR kernel, `size`
    = P items per piece at most) or "groups" (item-parallel kernel,
    `size` = G items per group); the budgets it was built for; `parts`,
    the scratch's length in partial tiles (for the CSR kernel also its
    grid, ceil(W/P) + nb pieces); the forward and the transposed
    direction."""

    kind: str
    size: int
    nb: int
    w: int
    parts: int
    fwd: Direction
    bwd: Direction


def _directions(item_pool, item_row, item_col, item_permT, item_colT, nb):
    """Both directions' item lists, and their row pointers [2, nb+1]."""
    ipT, rT = transposed_items(item_pool, item_row, item_permT, nb)
    segs = torch.stack([item_row, item_colT])
    bounds = torch.arange(nb + 1, dtype=segs.dtype, device=segs.device)
    rp = torch.searchsorted(segs, bounds.repeat(2, 1), out_int32=True)
    return (item_pool, item_row, item_col), (ipT, item_colT, rT), rp


def plan_pieces(item_pool, item_row, item_col, item_permT, item_colT,
                nb: int, p: int) -> BlockPlan:
    """The CSR kernel's plan: each row's item run cut into pieces of at
    most `p` items, in item order; an empty row gets one empty piece, so
    every row is written and piece_ptr rises strictly.
    Piece q belongs to the row r with piece_ptr[r] <= q < piece_ptr[r+1]
    and covers items rp[r] + k·p .. min(rp[r] + (k+1)·p, rp[r+1]),
    k = q − piece_ptr[r] (the kernel's block q derives this itself). At
    most ceil(W/p) + nb pieces."""
    if p < 1:
        raise ValueError(f"piece length must be >= 1, got {p}")
    w = item_row.shape[0]
    fwd, bwd, rp = _directions(item_pool, item_row, item_col, item_permT,
                               item_colT, nb)
    n_pieces = ((rp[:, 1:] - rp[:, :-1] + (p - 1)) // p).clamp_(min=1)
    piece_ptr = torch.nn.functional.pad(n_pieces.cumsum(1, dtype=torch.int32),
                                        (1, 0))                  # [2, nb+1]
    dirs = [Direction(*lists, rp[i], piece_ptr[i])
            for i, lists in enumerate((fwd, bwd))]
    return BlockPlan("pieces", p, nb, w, -(-w // p) + nb, *dirs)


def plan_groups(item_pool, item_row, item_col, item_permT, item_colT,
                nb: int, g: int) -> BlockPlan:
    """The item-parallel kernel's plan: fixed groups of `g` consecutive
    items. A row segment begins at every group start and every row
    change, and its partial goes to the slot of its first item, so row
    r's partials are slot rp[r] and the group starts inside its run,
    rp[r] < j·g < rp[r+1], in group order: the row pointers are the whole
    table. The scratch has W slots, of which the segments (at most
    ceil(W/g) + nb) are written and read."""
    if g < 1:
        raise ValueError(f"group size must be >= 1, got {g}")
    w = item_row.shape[0]
    fwd, bwd, rp = _directions(item_pool, item_row, item_col, item_permT,
                               item_colT, nb)
    dirs = [Direction(*lists, rp[i]) for i, lists in enumerate((fwd, bwd))]
    return BlockPlan("groups", g, nb, w, w, *dirs)


def check_plan(plan: BlockPlan, kind: str, nb: int, w: int, device) -> None:
    """Raise unless `plan` is a `kind` plan for these budgets and device."""
    if not isinstance(plan, BlockPlan) or plan.kind != kind:
        raise ValueError(f"expected a {kind!r} BlockPlan, got {plan!r:.80}")
    if (plan.nb, plan.w) != (nb, w):
        raise ValueError(f"plan built for nb={plan.nb}, W={plan.w}; the call "
                         f"has nb={nb}, W={w}")
    if plan.fwd.row_ptr.device != device:
        raise ValueError(f"plan on {plan.fwd.row_ptr.device}, inputs on {device}")


class BlockLaunchCounts:
    """Plain integer counts of the calls run on a kernel (block
    propagations, SpMMs), those of width F = 1 among them and those in
    bf16 (block kernels)."""

    def reset(self) -> None:
        self.fwd_launches = self.bwd_launches = 0
        self.f1_fwd = self.f1_bwd = 0
        self.bf16_fwd = self.bf16_bwd = 0

    __init__ = reset

    def count(self, transpose: bool, f: int, bf16: bool = False) -> None:
        if transpose:
            self.bwd_launches += 1
            self.f1_bwd += f == 1
            self.bf16_bwd += bf16
        else:
            self.fwd_launches += 1
            self.f1_fwd += f == 1
            self.bf16_fwd += bf16


Launch = Callable[..., torch.Tensor]
Planner = Callable[..., BlockPlan]


def make_block_prop(name: str, kind: str, planner: Planner, launch: Launch
                    ) -> Callable[..., torch.Tensor]:
    """The entry of one kernel: checks its inputs, takes the caller's
    `kind` plan or builds one (`planner(items..., nb)`), and applies an
    autograd Function whose forward and backward walk that plan.
    `launch(hb, pool, plan, direction, num_items, transpose)` runs the
    kernel on CUDA tensors (and counts the launch); CPU tensors run
    `block_propagate_plain`. Gradients flow to hb only: the cotangent is
    taken in the pool's dtype (rounded to bf16 for a bf16 pool) and d_hb
    is returned in hb's."""

    def forward(hb, pool, num_items, plan):
        if hb.is_cuda:
            return launch(hb, pool, plan, plan.fwd, num_items, False)
        d = plan.fwd
        return block_propagate_plain(hb, pool, d.ip, d.seg, d.src)

    def setup_context(ctx, inputs, output):
        hb, pool, num_items, ctx.plan = inputs
        ctx.hb_dtype = hb.dtype
        ctx.save_for_backward(pool, num_items)

    def backward(ctx, g):
        pool, num_items = ctx.saved_tensors
        g = g.to(pool.dtype).contiguous()
        d = ctx.plan.bwd
        if g.is_cuda:
            d_hb = launch(g, pool, ctx.plan, d, num_items, True)
        else:
            d_hb = block_propagate_plain(g, pool, d.ip, d.seg, d.src,
                                         transpose=True)
        return d_hb.to(ctx.hb_dtype), None, None, None

    fn = type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
    })

    def propagate(hb, pool, item_pool, item_row, item_col, item_permT,
                  item_colT, num_items, plan=None) -> torch.Tensor:
        nb, _ = check_inputs(hb, pool, item_pool, item_row, item_col,
                             item_permT, item_colT, num_items)
        if plan is None:
            plan = planner(item_pool, item_row, item_col, item_permT,
                           item_colT, nb)
        check_plan(plan, kind, nb, item_pool.shape[0], hb.device)
        return fn.apply(hb, pool, num_items, plan)

    return propagate
