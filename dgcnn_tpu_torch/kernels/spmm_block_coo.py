"""Block-pair COO SpMM — the port of dgcnn_tpu/kernels/spmm_block_coo.py
(`BlockCOO` :88, the host builders :118-284, `spmm_block_coo` :414 with its
`pallas_call` at :399, backward `_bwd` :441).

    out[i] = Σ_{e: dst_e = i} w_e · h[src_e]

over a host-built block-pair structure. The packer's dst-sorted edge
stream is grouped by (dst block r, src block c), 128-node blocks, and each
group is cut into work items of EB = 256 edge slots holding the local
indices (ls = src % 128, ld = dst % 128) and the edge id `perm` (−1 on a
null slot, whose weight is 0). Items are r-major; `row_ptr` [nb+1] gives
each output block-row's item run. The transpose orientation (items grouped
by source block, `row_ptrT`/`item_cT`/`lsT`/`ldT`/`permT`) serves the
backward's dh. Padded items (`pad_structure`) carry item_r = nb and lie
outside every `row_ptr` range.

The host builders are NumPy copies of the reference's and give its arrays
field for field. `spmm_block_coo(structure, w_pad, w_padT, h, order)` is
the entry: on CPU tensors it runs `block_coo_plain`, the kernel's function
in plain PyTorch; on CUDA tensors the kernel of csrc/spmm_block_coo.cu, or
it raises. The kernel adds each slot's w·h[src] straight into its row: a
warp per row (a thread at F=1) walks the row's slots in the order
`block_coo_order` builds once per batch (an `EdgeOrder` over the flat
slots: sorted stably by destination row, null slots and sentinel items
left out; design and bound in the source's header). The backward runs the
same kernel over the transpose orientation for dh, and, only when `w_pad`
needs a gradient, the plain SDDMM for dw (null slots exactly 0), as the
reference leaves its SDDMM to XLA. `block_coo_fits` (the TPU's VMEM gate)
is not ported: the card reads h through L2.

`launches.fwd_launches` / `launches.bwd_launches` count one per forward /
backward SpMM that ran on the kernel (`f1_fwd` / `f1_bwd`: those of width
1).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dgcnn_tpu_torch.kernels.block_prop import BlockLaunchCounts
from dgcnn_tpu_torch.ops.spmm import EdgeOrder

BS = 128
DEFAULT_EB = 256
_LANES = 128

launches = BlockLaunchCounts()


@dataclasses.dataclass(frozen=True)
class BlockCOOMeta:
    num_nodes: int
    num_edges: int   # real edge count (−1 on engine-attached structures)
    eb: int
    fill: float      # real edges / slots (−1 on engine-attached structures)


@dataclasses.dataclass(frozen=True)
class BlockCOO:
    """Both orientations of one batch's block-pair structure; NumPy arrays
    from the builders, tensors after `map`. [W, EB] arrays are slot-major."""

    meta: BlockCOOMeta
    row_ptr: object   # [NB+1] item range of each output block-row
    item_r: object    # [W] destination block (non-decreasing; nb if padded)
    item_c: object    # [W] source block
    ls: object        # [W, EB] src % BS
    ld: object        # [W, EB] dst % BS
    perm: object      # [W, EB] edge index, −1 on a null slot
    row_ptrT: object  # [NB+1]
    item_cT: object   # [WT] destination block of each transpose item
    lsT: object       # [WT, EB] dst % BS
    ldT: object       # [WT, EB] src % BS
    permT: object     # [WT, EB]

    ARRAYS = ("row_ptr", "item_r", "item_c", "ls", "ld", "perm",
              "row_ptrT", "item_cT", "lsT", "ldT", "permT")

    def map(self, fn: Callable) -> "BlockCOO":
        return BlockCOO(meta=self.meta, **{f: fn(getattr(self, f)) for f in self.ARRAYS})


def _build_orientation(major, minor, num_nodes: int, eb: int):
    """Group edges by (major//BS, minor//BS), stable over the stream, and
    chunk each group into EB-slot items. Returns (row_ptr, item_r, item_c,
    l_minor, l_major, perm)."""
    e = major.shape[0]
    nb = num_nodes // BS
    key = (major // BS).astype(np.int64) * nb + minor // BS
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    if e:
        starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
        ends = np.r_[starts[1:], e]
        items_per = -(-(ends - starts) // eb)
        w = max(int(items_per.sum()), 1)
    else:
        starts = ends = np.zeros(0, np.int64)
        w = 1  # one all-null item keeps shapes non-empty

    perm = np.full((w, eb), -1, np.int64)
    item_r = np.zeros(w, np.int32)
    item_c = np.zeros(w, np.int32)
    wi = 0
    for s0, s1 in zip(starts.tolist(), ends.tolist()):
        gr, gc = divmod(int(key_s[s0]), nb)
        for off in range(s0, s1, eb):
            chunk = order[off : min(off + eb, s1)]
            perm[wi, : chunk.shape[0]] = chunk
            item_r[wi] = gr
            item_c[wi] = gc
            wi += 1

    null = perm < 0
    safe = np.maximum(perm, 0)
    lmaj = np.where(null, 0, major[safe] % BS) if e else np.zeros_like(perm)
    lmin = np.where(null, 0, minor[safe] % BS) if e else np.zeros_like(perm)
    row_ptr = np.searchsorted(item_r, np.arange(nb + 1)).astype(np.int32)
    return (row_ptr, item_r.astype(np.int32), item_c.astype(np.int32),
            lmin.astype(np.int32), lmaj.astype(np.int32), perm)


def _pad_items(arrs, w_target: int, nb: int):
    """Pad (item_r, item_c, ls, ld, perm) to `w_target` items with sentinel
    items (r = nb: outside every row_ptr range, never read)."""
    item_r, item_c, ls, ld, perm = arrs
    w, eb = perm.shape
    if w_target < w:
        raise ValueError(f"pad_items_to={w_target} < actual items {w}")
    pad = w_target - w
    if pad == 0:
        return arrs
    return (
        np.r_[item_r, np.full(pad, nb, np.int32)],
        np.r_[item_c, np.zeros(pad, np.int32)],
        np.r_[ls, np.zeros((pad, eb), np.int32)],
        np.r_[ld, np.zeros((pad, eb), np.int32)],
        np.r_[perm, np.full((pad, eb), -1, np.int64)],
    )


def pad_structure(s: BlockCOO, w_target: int) -> BlockCOO:
    """Pad both orientations' item axes to `w_target` (sentinel items)."""
    nb = s.meta.num_nodes // BS
    a = {f: np.asarray(getattr(s, f)) for f in BlockCOO.ARRAYS}
    r, c, ls, ld, perm = _pad_items(
        (a["item_r"], a["item_c"], a["ls"], a["ld"], a["perm"]), w_target, nb)
    _, cT, lsT, ldT, permT = _pad_items(
        (np.zeros(a["item_cT"].shape[0], np.int32), a["item_cT"], a["lsT"],
         a["ldT"], a["permT"]), w_target, nb)
    return BlockCOO(
        meta=s.meta, row_ptr=a["row_ptr"], item_r=r, item_c=c, ls=ls, ld=ld,
        perm=perm.astype(np.int32), row_ptrT=a["row_ptrT"], item_cT=cT,
        lsT=lsT, ldT=ldT, permT=permT.astype(np.int32),
    )


def build_block_coo(edge_src, edge_dst, num_nodes: int, eb: int = DEFAULT_EB,
                    pad_items_to: int = 0) -> BlockCOO:
    """Host build of both orientations (NumPy, once per packed batch).
    `num_nodes` must be a multiple of BS; `pad_items_to` pads both item
    axes to a fixed W."""
    if num_nodes % BS:
        raise ValueError(f"num_nodes {num_nodes} not a multiple of {BS}")
    if eb % _LANES:
        raise ValueError(f"eb {eb} not a multiple of {_LANES}")
    src = np.asarray(edge_src, np.int64)
    dst = np.asarray(edge_dst, np.int64)
    e = src.shape[0]
    nb = num_nodes // BS
    row_ptr, item_r, item_c, ls, ld, perm = _build_orientation(dst, src, num_nodes, eb)
    row_ptrT, item_rT, item_cT, lsT, ldT, permT = _build_orientation(
        src, dst, num_nodes, eb)
    fill = e / float(max(perm.size, 1))
    if pad_items_to:
        item_r, item_c, ls, ld, perm = _pad_items(
            (item_r, item_c, ls, ld, perm), pad_items_to, nb)
        item_rT, item_cT, lsT, ldT, permT = _pad_items(
            (item_rT, item_cT, lsT, ldT, permT), pad_items_to, nb)
    return BlockCOO(
        meta=BlockCOOMeta(num_nodes=num_nodes, num_edges=e, eb=eb, fill=fill),
        row_ptr=row_ptr, item_r=item_r, item_c=item_c, ls=ls, ld=ld,
        perm=perm.astype(np.int32), row_ptrT=row_ptrT, item_cT=item_cT,
        lsT=lsT, ldT=ldT, permT=permT.astype(np.int32),
    )


def _pad_w(perm, w) -> np.ndarray:
    w = np.asarray(w, np.float32)
    perm = np.asarray(perm)
    if w.size == 0:
        return np.zeros(perm.shape, np.float32)
    return np.where(perm < 0, 0.0, w[np.maximum(perm, 0)]).astype(np.float32)


def pad_weights(structure: BlockCOO, w) -> np.ndarray:
    """Edge weights → forward slot order [W, EB] (null slots 0)."""
    return _pad_w(structure.perm, w)


def pad_weights_t(structure: BlockCOO, w) -> np.ndarray:
    """Edge weights → transpose slot order [WT, EB]."""
    return _pad_w(structure.permT, w)


# -- the function, plain ----------------------------------------------------


def _item_rows(row_ptr: torch.Tensor, w: int) -> torch.Tensor:
    """Output block-row of each item as the kernel sees it, int32: item j
    lies in row r when row_ptr[r] ≤ j < row_ptr[r+1]; items past
    row_ptr[nb] get nb."""
    j = torch.arange(w, dtype=row_ptr.dtype, device=row_ptr.device)
    return torch.searchsorted(row_ptr, j, right=True, out_int32=True) - 1


def block_coo_plain(row_ptr, item_c, ls, ld, w_pad, h) -> torch.Tensor:
    """The kernel's function in plain PyTorch: every slot of every item in
    a row's run adds w·h[c·BS + ls] to row r·BS + ld (null slots add their
    weight, 0, as the kernel does); items outside all runs add nothing."""
    n, f = h.shape
    wn = ls.shape[0]
    rows = _item_rows(row_ptr, wn).long()
    gdst = (rows[:, None] * BS + ld.long()).reshape(-1)
    gsrc = (item_c.long()[:, None] * BS + ls.long()).reshape(-1)
    out = h.new_zeros((n + BS, f))
    out.index_add_(0, gdst, h[gsrc] * w_pad.reshape(-1, 1))
    return out[:n]


def slot_sddmm(structure: BlockCOO, h, g) -> torch.Tensor:
    """dw per forward slot, ⟨h[src_e], g[dst_e]⟩, 0 on null slots."""
    n = h.shape[0]
    gsrc = structure.item_c.long()[:, None] * BS + structure.ls.long()
    gdst = structure.item_r.long()[:, None] * BS + structure.ld.long()
    dots = (h[gsrc.clamp(max=n - 1)] * g[gdst.clamp(max=n - 1)]).sum(-1)
    return torch.where(structure.perm < 0, torch.zeros_like(dots), dots)


# -- the slot order the kernel walks -------------------------------------


def _slot_keys(row_ptr, ld, perm, num_nodes: int) -> torch.Tensor:
    """Destination row (item row · BS + ld) of each flat slot j·EB + q of
    one orientation, int32; null slots (perm < 0) and items outside every
    row run (sentinel items) get `num_nodes`: they add 0 or are never read."""
    nb = num_nodes // BS
    rows = _item_rows(row_ptr, ld.shape[0])[:, None]
    left_out = (perm < 0) | (rows < 0) | (rows >= nb)
    return torch.where(left_out, num_nodes, rows * BS + ld).reshape(-1)


def block_coo_order(structure: BlockCOO, num_nodes: int) -> EdgeOrder:
    """The slot orders of both orientations, built once per batch and
    shared by every SpMM over it, forward and backward: the flat slots
    sorted stably by destination row, so each row's slots come in
    item-run order and, within an item, in slot order; left-out slots past
    row_ptr[N]. `perm`/`row_ptr` over the forward slots, `permT`/`row_ptrT`
    over the transpose slots. Plain PyTorch on the structure's device: one
    stable sort of both orientations' int32 keys (the transpose's offset
    past the forward's) and one search for both row-pointer arrays;
    deterministic."""
    n = num_nodes
    key = _slot_keys(structure.row_ptr, structure.ld, structure.perm, n)
    keyT = _slot_keys(structure.row_ptrT, structure.ldT, structure.permT, n) + (n + 1)
    m = key.numel()
    key_s, order = torch.sort(torch.cat([key, keyT]), stable=True)
    bounds = torch.arange(2 * n + 2, dtype=key_s.dtype, device=key_s.device)
    ptr = torch.searchsorted(key_s, bounds, out_int32=True)
    order = order.to(torch.int32)
    return EdgeOrder(perm=order[:m], row_ptr=ptr[: n + 1],
                     permT=order[m:] - m, row_ptrT=ptr[n + 1:] - m)


# -- the kernel -----------------------------------------------------------


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("spmm_block_coo")
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.spmm_block_coo_f32.argtypes = [P] * 7 + [I] * 3 + [P]
        lib.spmm_block_coo_f32.restype = I
        lib.spmm_block_coo_error_string.argtypes = [I]
        lib.spmm_block_coo_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _cuda_spmm(row_ptr, perm, item_c, ls, w_pad, h, transpose: bool) -> torch.Tensor:
    """One launch of csrc/spmm_block_coo.cu over one orientation and its
    slot order (any F)."""
    lib = _lib()
    n, f = h.shape
    with torch.cuda.device(h.device):
        out = torch.empty((n, f), dtype=torch.float32, device=h.device)
        rc = lib.spmm_block_coo_f32(
            row_ptr.data_ptr(), perm.data_ptr(), item_c.data_ptr(), ls.data_ptr(),
            w_pad.data_ptr(), h.data_ptr(), out.data_ptr(), n, f, ls.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.spmm_block_coo_error_string(rc).decode()
        raise RuntimeError(
            f"spmm_block_coo {'backward' if transpose else 'forward'}: "
            f"CUDA error {rc} ({msg})")
    launches.count(transpose, f)
    return out


def check_inputs(structure: BlockCOO, w_pad, w_padT, h,
                 order: Optional[EdgeOrder] = None) -> Tuple[int, int]:
    """Validate what the kernel relies on; returns (N, F)."""
    if h.dim() != 2 or h.shape[0] % BS or h.shape[0] == 0 or h.shape[1] < 1:
        raise ValueError(f"h must be [N, F] with N a positive multiple of {BS}, "
                         f"got {tuple(h.shape)}")
    if h.dtype != torch.float32 or w_pad.dtype != torch.float32 or \
            w_padT.dtype != torch.float32:
        raise TypeError("h, w_pad and w_padT must be float32")
    nb = h.shape[0] // BS
    arrays = [getattr(structure, f) for f in BlockCOO.ARRAYS]
    if not all(isinstance(a, torch.Tensor) for a in arrays):
        raise TypeError("the structure's arrays must be tensors (BlockCOO.map)")
    if any(a.dtype != torch.int32 for a in arrays):
        raise TypeError("the structure's arrays must be int32")
    for rp in (structure.row_ptr, structure.row_ptrT):
        if rp.shape != (nb + 1,):
            raise ValueError(f"row pointers must be [{nb + 1}], got {tuple(rp.shape)}")
    for slots, cols, w in ((structure.ls, structure.item_c, w_pad),
                           (structure.lsT, structure.item_cT, w_padT)):
        if slots.dim() != 2 or cols.shape != slots.shape[:1]:
            raise ValueError("item columns must be [W] beside [W, EB] slots")
        if w.shape != slots.shape:
            raise ValueError(f"weights {tuple(w.shape)} must match slots "
                             f"{tuple(slots.shape)}")
    if structure.ls.shape[1] % 8 or structure.lsT.shape[1] != structure.ls.shape[1]:
        raise ValueError(f"slots per item must be one multiple of 8 in both "
                         f"orientations, got {structure.ls.shape[1]} and "
                         f"{structure.lsT.shape[1]}")
    for a, b in ((structure.ld, structure.ls), (structure.perm, structure.ls),
                 (structure.ldT, structure.lsT), (structure.permT, structure.lsT)):
        if a.shape != b.shape:
            raise ValueError("ls, ld and perm must share one [W, EB] shape")
    tensors = [*arrays, w_pad, w_padT]
    if order is not None:
        for name, slots in (("perm", structure.ls), ("row_ptr", None),
                            ("permT", structure.lsT), ("row_ptrT", None)):
            t = getattr(order, name)
            if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
                raise TypeError(f"the slot order's {name} must be an int32 tensor "
                                f"(block_coo_order)")
            want = (h.shape[0] + 1,) if slots is None else (slots.numel(),)
            if tuple(t.shape) != want:
                raise ValueError(f"the slot order's {name} must be {want}, "
                                 f"got {tuple(t.shape)}")
            tensors.append(t)
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the block-COO SpMM runs on cpu or cuda, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the block-COO SpMM's inputs must be contiguous")
    if not h.is_contiguous():
        raise ValueError("h must be contiguous")
    return h.shape


class SpmmBlockCooFn(torch.autograd.Function):
    """Forward: the kernel over the slot order (CUDA) or `block_coo_plain`
    (CPU). Backward: the same over the transpose orientation for dh; dw
    only when w_pad needs a gradient. The structure, w_padT and the order
    get none."""

    @staticmethod
    def forward(structure, w_pad, w_padT, h, order):
        if h.is_cuda:
            return _cuda_spmm(order.row_ptr, order.perm, structure.item_c,
                              structure.ls, w_pad, h, False)
        return block_coo_plain(structure.row_ptr, structure.item_c, structure.ls,
                               structure.ld, w_pad, h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        structure, _w, w_padT, h, order = inputs
        ctx.structure = structure
        ctx.order = order
        ctx.save_for_backward(w_padT, h)

    @staticmethod
    def backward(ctx, g):
        w_padT, h = ctx.saved_tensors
        s, o = ctx.structure, ctx.order
        g = g.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[3]:
            if g.is_cuda:
                dh = _cuda_spmm(o.row_ptrT, o.permT, s.item_cT, s.lsT, w_padT, g, True)
            else:
                dh = block_coo_plain(s.row_ptrT, s.item_cT, s.lsT, s.ldT, w_padT, g)
        if ctx.needs_input_grad[1]:
            dw = slot_sddmm(s, h, g)
        return None, dw, None, dh, None


def spmm_block_coo(structure: BlockCOO, w_pad, w_padT, h,
                   order: Optional[EdgeOrder] = None) -> torch.Tensor:
    """out [N, F] = Σ over the structure's slots of w·h[src] into dst. CPU
    tensors run the plain version; CUDA tensors the kernel, or raise.
    `order` is the structure's `block_coo_order`, built here when None."""
    check_inputs(structure, w_pad, w_padT, h, order)
    if h.is_cuda and order is None:
        order = block_coo_order(structure, h.shape[0])
    return SpmmBlockCooFn.apply(structure, w_pad, w_padT, h, order)
