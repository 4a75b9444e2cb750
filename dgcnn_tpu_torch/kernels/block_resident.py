"""Block-sparse propagation, item-parallel form — the port of
dgcnn_tpu/kernels/block_resident.py (`block_propagate_resident` :141,
`pallas_call` :130, backward `_bwd` :185).

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]

(the full contract is in kernels/block_prop.py). The CUDA kernels,
csrc/block_resident.cu (design and bound in its header), compute fixed
groups of `GROUP` consecutive work items, one partial per (group, row
segment) into a scratch slot (the segment's first item), then sum each
destination row's segments in group order: two passes, no atomics. Groups past the batch's real item
count (`num_items`, read on the device) return at once. The row
pointers come from the batch's plan (`plan`, `block_prop.plan_groups`), built once
per batch by the caller or, when none is passed, here per call. The
backward launches both passes again, transposed, over the plan's
col-major direction.

`launches.fwd_launches` / `launches.bwd_launches` count one per forward /
backward propagation that ran on the kernels (`f1_fwd` / `f1_bwd`: those
of width 1).
"""

from __future__ import annotations

import ctypes
import os

import torch

from dgcnn_tpu_torch.kernels import block_prop
from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain  # noqa: F401

GROUP = 2   # items per group (chip_smoke phase 5 measures 2 and 4)

launches = block_prop.BlockLaunchCounts()

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "block_resident.cu")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # extern "C" entry → argtypes
    "block_resident_f32": [_P] * 9 + [_I] * 5 + [_P],
    "block_resident_error_string": [_I],
}


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("block_resident")
    if not getattr(lib, "_dgcnn_bound", False):
        for name, types in _SIGNATURES.items():
            getattr(lib, name).argtypes = types
        lib.block_resident_f32.restype = _I
        lib.block_resident_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def make_plan(item_pool, item_row, item_col, item_permT, item_colT, nb,
              g: int = None) -> block_prop.BlockPlan:
    """The batch's group plan for these kernels (`GROUP` items by default)."""
    return block_prop.plan_groups(item_pool, item_row, item_col, item_permT,
                                  item_colT, nb, GROUP if g is None else g)


def _cuda_prop(hb, pool, plan, d, num_items, transpose: bool) -> torch.Tensor:
    """Both passes of csrc/block_resident.cu on the current stream, over
    direction `d` of `plan`."""
    lib = _lib()
    nb, bs, f = hb.shape
    dev = hb.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        parts = torch.empty((plan.parts, bs, f), dtype=torch.float32, device=dev)
        out = torch.empty((nb, bs, f), dtype=torch.float32, device=dev)
        rc = lib.block_resident_f32(
            pool.data_ptr(), hb.data_ptr(), d.ip.data_ptr(), d.src.data_ptr(),
            d.seg.data_ptr(), d.row_ptr.data_ptr(),
            num_items.data_ptr(), parts.data_ptr(), out.data_ptr(),
            nb, plan.w, plan.size, f, int(transpose), stream,
        )
    if rc != 0:
        msg = lib.block_resident_error_string(rc).decode()
        raise RuntimeError(
            f"block_resident {'backward' if transpose else 'forward'}: "
            f"CUDA error {rc} ({msg})"
        )
    launches.count(transpose, f)
    return out


_propagate = block_prop.make_block_prop("BlockResidentFn", "groups", make_plan,
                                        _cuda_prop)


def block_propagate_resident(hb, pool, item_pool, item_row, item_col,
                             item_permT, item_colT, num_items,
                             plan=None) -> torch.Tensor:
    """out [nb, bs, F] fp32 (kernels/block_prop.py has the contract).
    CPU tensors run the plain version; CUDA tensors run the kernels, or
    raise. `num_items` is the batch's real item count, an int32 on the
    device, read by the kernel with no host sync. `plan` is the batch's
    `make_plan(...)`, built here when not given."""
    return _propagate(hb, pool, item_pool, item_row, item_col, item_permT,
                      item_colT, num_items, plan)
