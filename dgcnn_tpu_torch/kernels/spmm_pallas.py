"""Edge-stream SpMM kernels — the ports of dgcnn_tpu/kernels/spmm_pallas.py:

  * `spmm_pallas` (:220; `pallas_call` :102; backward `_bwd` :230): the
    per-edge gather-scale-scatter, here the row-parallel CSR kernel of
    csrc/spmm_rows.cu (a group of lanes per destination row loads the
    row's columns and weights together and keeps eight h-row loads in
    flight, summing in position order; the row is written once);
  * `spmm_pallas_mxu` (:191; `pallas_call` :170; backward `_mxu_bwd`
    :201): the one-hot selector kernel over 256-edge blocks, here the
    edge-block kernel of csrc/spmm_edge_block.cu (one launch: a block per
    256 ordered edges stages them in shared memory, and lane groups walk
    its runs as the row kernel walks a row; a row that straddles blocks is
    finished in block order by the last group to arrive on its counter).

Both compute `out[i] = Σ_{dst_e=i} w_e·h[src_e]` for any edge order, as
the reference's kernels do: they walk an `EdgeOrder` (ops/spmm.py), taken
from the caller (the model builds one per batch) or built here by stable
device sorts, and read the column of each position from its `col` /
`colT` (gathered here when the order has none). The backward runs the same
kernel over the source order with src and dst swapped for dh, and the
plain SDDMM for dw only when the weights need a gradient (the GCN's
weights are the edge mask and never do). On CPU tensors both run
`spmm_plain`; on CUDA tensors the kernel or an exception. Design and bound
are in each source's header. No float atomics: two runs give the same
bits, and the same bits as each kernel's earlier design (`design=EARLIER`:
one edge at a time through perm → col → h; reachable only through
`cuda_rows` / `cuda_edge_block`, for chip_smoke.py's in-run comparison).

The row kernel's launch is the operator `dgcnn_tpu_torch::spmm_rows`
(`torch.library.custom_op` with a fake implementation), so that
`torch.compile` of a forward on the card (graft_entry.py) keeps it whole.
Only the row kernel is compile-safe: `entry()` is the one forward that
is compiled, and it runs the row kernel. The edge-block kernel launches
through its ctypes call directly; Dynamo would trace into it.

`rows_launches` and `edge_block_launches` count one per forward /
backward SpMM that ran on each kernel (`f1_fwd` / `f1_bwd`: those of
width 1).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dgcnn_tpu_torch.kernels.block_prop import BlockLaunchCounts
from dgcnn_tpu_torch.ops.spmm import (
    EdgeOrder, edge_order, position_columns, sddmm_plain, spmm_plain,
)

rows_launches = BlockLaunchCounts()
edge_block_launches = BlockLaunchCounts()
EDGE_BLOCK = 256  # positions per block of the edge-block kernel
CURRENT, EARLIER = 0, 1  # the C entries' `design` (csrc/spmm_seq.cuh)


# `<name>_f32` of csrc/<name>.cu: (pointers, then ints), then the stream
ENTRY_ARGS = {"spmm_rows": (7, 3), "spmm_edge_block": (10, 4)}


def _bind(name: str):
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load(name)
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        n_ptr, n_int = ENTRY_ARGS[name]
        fn = getattr(lib, f"{name}_f32")
        fn.argtypes = [P] * n_ptr + [I] * n_int + [P]
        fn.restype = I
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _raise_on(lib, name: str, rc: int, transpose: bool) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} {'backward' if transpose else 'forward'}: "
                           f"CUDA error {rc} ({msg})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _rows_launch(row_ptr, perm, col, colp, w, h, transpose, design):
    lib = _bind("spmm_rows")
    n, f = row_ptr.shape[0] - 1, h.shape[1]
    with torch.cuda.device(h.device):
        out = torch.empty((n, f), dtype=torch.float32, device=h.device)
        rc = lib.spmm_rows_f32(row_ptr.data_ptr(), _ptr(perm), _ptr(col), _ptr(colp),
                               w.data_ptr(), h.data_ptr(), out.data_ptr(), n, f,
                               design, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "spmm_rows", rc, transpose)
    rows_launches.count(transpose, f)
    return out


# The row kernel's launch as an operator of its own, so that torch.compile
# (Dynamo) keeps it whole: traced, the ctypes call would meet fake tensors
# and Dynamo's stand-in for the current stream. The fake implementation
# gives the output's shape; the real one launches and counts.
_rows_op = torch.library.custom_op(
    "dgcnn_tpu_torch::spmm_rows", _rows_launch, mutates_args=(),
    schema="(Tensor row_ptr, Tensor? perm, Tensor? col, Tensor? colp, Tensor w, "
           "Tensor h, bool transpose, int design) -> Tensor")


@_rows_op.register_fake
def _rows_fake(row_ptr, perm, col, colp, w, h, transpose, design):
    return h.new_empty((row_ptr.shape[0] - 1, h.shape[1]), dtype=torch.float32)


def cuda_rows(row_ptr, perm, row, col, colp, w, h, transpose: bool,
              design: int = CURRENT) -> torch.Tensor:
    """One launch of csrc/spmm_rows.cu (`row` is unused: the row pointers
    give each row's range). `col` is by edge id (read by the earlier
    design), `colp` by position (read by the current one). Runs as the
    operator `torch.ops.dgcnn_tpu_torch.spmm_rows`."""
    del row
    return _rows_op(row_ptr, perm, col, colp, w, h, transpose, design)


_COUNTERS = {}  # device → int32 arrival counters, all 0 between launches


def _counters(device, n: int) -> torch.Tensor:
    """At least n zeroed counters on `device`; a larger N allocates new
    ones, zeroed (a launch that faulted could have left old ones dirty)."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = _COUNTERS[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                            device=device)
    return c


def cuda_edge_block(row_ptr, perm, row, col, colp, w, h, transpose: bool,
                    design: int = CURRENT) -> torch.Tensor:
    """One launch of csrc/spmm_edge_block.cu (two for the earlier design),
    with its scratch and the row counters. `row` and `col` are by edge id,
    `colp` by position."""
    lib = _bind("spmm_edge_block")
    n, f, n_pos = row_ptr.shape[0] - 1, h.shape[1], row.shape[0]
    blocks = max(-(-n_pos // EDGE_BLOCK), 1)
    with torch.cuda.device(h.device):
        out = torch.empty((n, f), dtype=torch.float32, device=h.device)
        partial = torch.empty((2 * blocks, f), dtype=torch.float32, device=h.device)
        rc = lib.spmm_edge_block_f32(
            row_ptr.data_ptr(), _ptr(perm), row.data_ptr(), _ptr(col), _ptr(colp),
            w.data_ptr(), h.data_ptr(), out.data_ptr(), partial.data_ptr(),
            _counters(h.device, n).data_ptr(), n, n_pos, f, design,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "spmm_edge_block", rc, transpose)
    edge_block_launches.count(transpose, f)
    return out


def check_inputs(edge_src, edge_dst, edge_weight, h,
                 order: Optional[EdgeOrder]) -> None:
    """Validate what the kernels rely on."""
    if h.dim() != 2 or h.shape[1] < 1:
        raise ValueError(f"h must be [N, F] with F ≥ 1, got {tuple(h.shape)}")
    if h.dtype != torch.float32 or edge_weight.dtype != torch.float32:
        raise TypeError("h and the edge weights must be float32")
    e = edge_src.shape[0]
    for t in (edge_src, edge_dst):
        if t.dtype != torch.int32:
            raise TypeError(f"edge indices must be int32, got {t.dtype}")
    tensors = {"edge_src": edge_src, "edge_dst": edge_dst,
               "edge_weight": edge_weight, "h": h}
    if order is not None:
        n = h.shape[0]
        for name in ("perm", "row_ptr", "permT", "row_ptrT", "col", "colT"):
            t = getattr(order, name)
            if t is None and name in ("perm", "col", "colT"):
                continue
            if t.dtype != torch.int32:
                raise TypeError(f"EdgeOrder.{name} must be int32")
            want = (n + 1,) if name.startswith("row_ptr") else (e,)
            if tuple(t.shape) != want:
                raise ValueError(f"EdgeOrder.{name} must be {want}, got {tuple(t.shape)}")
            tensors[f"EdgeOrder.{name}"] = t
    for t in (edge_src, edge_dst, edge_weight):
        if t.dim() != 1 or t.shape[0] != e:
            raise ValueError(f"edge arrays must all be [E={e}], got {tuple(t.shape)}")
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the SpMM runs on cpu or cuda, got {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the SpMM's inputs must be contiguous, {name} is not")


def make_spmm_fn(name: str, launch) -> type:
    """An autograd Function around one edge-stream kernel. `launch(row_ptr,
    perm, row, col, colp, w, h, transpose)` runs it on CUDA tensors (the
    order carries its position columns); CPU tensors run `spmm_plain`."""

    def forward(edge_src, edge_dst, edge_weight, h, order):
        if h.is_cuda:
            return launch(order.row_ptr, order.perm, edge_dst, edge_src, order.col,
                          edge_weight, h, False)
        return spmm_plain(edge_src, edge_dst, edge_weight, h, h.shape[0])

    def setup_context(ctx, inputs, output):
        edge_src, edge_dst, edge_weight, h, order = inputs
        ctx.order = order
        ctx.save_for_backward(edge_src, edge_dst, edge_weight, h)

    def backward(ctx, g):
        edge_src, edge_dst, edge_weight, h = ctx.saved_tensors
        g = g.contiguous()
        dw = dh = None
        if ctx.needs_input_grad[3]:
            if g.is_cuda:
                o = ctx.order
                dh = launch(o.row_ptrT, o.permT, edge_src, edge_dst, o.colT,
                            edge_weight, g, True)
            else:
                dh = spmm_plain(edge_dst, edge_src, edge_weight, g, g.shape[0])
        if ctx.needs_input_grad[2]:
            dw = sddmm_plain(edge_src, edge_dst, h, g)
        return None, None, dw, dh, None

    return type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context),
        "backward": staticmethod(backward),
    })


SpmmRowsFn = make_spmm_fn("SpmmRowsFn", cuda_rows)
SpmmEdgeBlockFn = make_spmm_fn("SpmmEdgeBlockFn", cuda_edge_block)


def _apply(fn, edge_src, edge_dst, edge_weight, h, order):
    check_inputs(edge_src, edge_dst, edge_weight, h, order)
    if h.is_cuda:
        order = (edge_order(edge_src, edge_dst, h.shape[0]) if order is None
                 else position_columns(order, edge_src, edge_dst))
    return fn.apply(edge_src, edge_dst, edge_weight, h, order)


def spmm_pallas(edge_src, edge_dst, edge_weight, h,
                order: Optional[EdgeOrder] = None) -> torch.Tensor:
    """out [N, F] through the row-parallel CSR kernel (CUDA) or the plain
    version (CPU). `order` defaults to stable sorts of this stream."""
    return _apply(SpmmRowsFn, edge_src, edge_dst, edge_weight, h, order)


def spmm_pallas_mxu(edge_src, edge_dst, edge_weight, h,
                    order: Optional[EdgeOrder] = None) -> torch.Tensor:
    """The same function through the edge-block kernel (CUDA) or the plain
    version (CPU)."""
    return _apply(SpmmEdgeBlockFn, edge_src, edge_dst, edge_weight, h, order)
