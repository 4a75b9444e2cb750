"""Block-sparse propagation, CSR form — the port of
dgcnn_tpu/kernels/block_pallas.py (`block_propagate_pallas` :170,
`pallas_call` :152, backward `_bwd` :201).

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]

(the full contract is in kernels/block_prop.py). The CUDA kernel,
csrc/block_csr.cu (design and bound in its header), cuts each output
block-row's item run into pieces of at most `PIECE` items, one block per
piece; a row of several pieces is summed in piece order by the block that
finishes last, in the same launch. The pieces come from the batch's plan
(`plan`, `block_prop.plan_pieces`), built once per batch by the caller
(models/dgcnn.py apply_block) or, when none is passed, here per call. The
backward launches the kernel again, transposed, over the plan's col-major
direction.

`block_propagate_csr` is the entry; `block_propagate_pallas` is the same
function under the reference's name. `launches.fwd_launches` /
`launches.bwd_launches` count one per forward / backward propagation
that ran on the kernel (`f1_fwd` / `f1_bwd`: those of width 1).
"""

from __future__ import annotations

import ctypes
import os

import torch

from dgcnn_tpu_torch.kernels import block_prop
from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain  # noqa: F401

PIECE = 2   # items per piece at most (chip_smoke phase 5 measures 2, 4, 6)

launches = block_prop.BlockLaunchCounts()

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "block_csr.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # extern "C" entry → argtypes
    "block_csr_f32": [_P] * 9 + [_I] * 5 + [_P],
    "block_csr_error_string": [_I],
}


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("block_csr")
    if not getattr(lib, "_dgcnn_bound", False):
        for name, types in _SIGNATURES.items():
            getattr(lib, name).argtypes = types
        lib.block_csr_f32.restype = _I
        lib.block_csr_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


_COUNTERS = {}  # device → int32 arrival counters, all 0 between launches


def _counters(device, nb: int) -> torch.Tensor:
    """At least nb zeroed counters on `device`; a larger budget allocates
    new ones, zeroed (a launch that faulted could have left old ones
    dirty)."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < nb:
        c = _COUNTERS[device] = torch.zeros(max(nb, 1024), dtype=torch.int32,
                                            device=device)
    return c


def make_plan(item_pool, item_row, item_col, item_permT, item_colT, nb,
              p: int = None) -> block_prop.BlockPlan:
    """The batch's piece plan for this kernel (`PIECE` items by default)."""
    return block_prop.plan_pieces(item_pool, item_row, item_col, item_permT,
                                  item_colT, nb, PIECE if p is None else p)


def _cuda_prop(hb, pool, plan, d, num_items, transpose: bool) -> torch.Tensor:
    """One launch of csrc/block_csr.cu on the current stream, over
    direction `d` of `plan`."""
    del num_items  # the pieces already leave padded items out
    lib = _lib()
    nb, bs, f = hb.shape
    dev = hb.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((nb, bs, f), dtype=torch.float32, device=dev)
        scratch = torch.empty((plan.parts, bs, f), dtype=torch.float32, device=dev)
        rc = lib.block_csr_f32(
            pool.data_ptr(), hb.data_ptr(), d.row_ptr.data_ptr(),
            d.piece_ptr.data_ptr(), d.ip.data_ptr(), d.src.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), _counters(dev, nb).data_ptr(),
            nb, plan.parts, plan.size, f, int(transpose), stream,
        )
    if rc != 0:
        msg = lib.block_csr_error_string(rc).decode()
        raise RuntimeError(f"block_csr {'backward' if transpose else 'forward'}: "
                           f"CUDA error {rc} ({msg})")
    launches.count(transpose, f)
    return out


_propagate = block_prop.make_block_prop("BlockCsrFn", "pieces", make_plan,
                                        _cuda_prop)


def block_propagate_csr(hb, pool, item_pool, item_row, item_col, item_permT,
                        item_colT, num_items, plan=None) -> torch.Tensor:
    """out [nb, bs, F] fp32 (kernels/block_prop.py has the contract).
    CPU tensors run the plain version; CUDA tensors run the kernel, or
    raise. `num_items` (the batch's real item count, int32) is checked
    and unused: the row pointers already leave padded items out. `plan`
    is the batch's `make_plan(...)`, built here when not given."""
    return _propagate(hb, pool, item_pool, item_row, item_col, item_permT,
                      item_colT, num_items, plan)


block_propagate_pallas = block_propagate_csr
