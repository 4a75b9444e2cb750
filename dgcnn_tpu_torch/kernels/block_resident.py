"""Block-sparse propagation, item-parallel form — the port of
dgcnn_tpu/kernels/block_resident.py (`block_propagate_resident` :141,
`pallas_call` :130, backward `_bwd` :185).

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]

(the full contract is in kernels/block_prop.py). The CUDA kernels,
csrc/block_resident.cu (design and bound in its header), compute each
group of 8 work items' products into a per-item scratch [W, bs, F], then
sum each destination row's contiguous run of items in item order: two
passes, no atomics. Groups past the batch's real item count (`num_items`,
read on the device) return at once. The backward launches both passes
again, transposed, over the col-major traversal.

`launches.fwd_launches` / `launches.bwd_launches` count one per forward /
backward propagation that ran on the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from dgcnn_tpu_torch.kernels import block_prop
from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain  # noqa: F401
from dgcnn_tpu_torch.kernels.dense_trunk import LaunchCounts

launches = LaunchCounts()


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("block_resident")
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.block_resident_f32.argtypes = [P] * 8 + [I] * 4 + [P]
        lib.block_resident_f32.restype = I
        lib.block_resident_error_string.argtypes = [I]
        lib.block_resident_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _cuda_prop(hb, pool, ip, seg, src, num_items, transpose: bool) -> torch.Tensor:
    """Both passes of csrc/block_resident.cu on the current stream."""
    lib = _lib()
    nb, bs, f = hb.shape
    w = ip.shape[0]
    dev = hb.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rp = block_prop.row_ptr(seg, nb)
        parts = torch.empty((w, bs, f), dtype=torch.float32, device=dev)
        out = torch.empty((nb, bs, f), dtype=torch.float32, device=dev)
        rc = lib.block_resident_f32(
            pool.data_ptr(), hb.data_ptr(), ip.data_ptr(), src.data_ptr(),
            num_items.data_ptr(), rp.data_ptr(), parts.data_ptr(),
            out.data_ptr(), nb, w, f, int(transpose), stream,
        )
    if rc != 0:
        msg = lib.block_resident_error_string(rc).decode()
        raise RuntimeError(
            f"block_resident {'backward' if transpose else 'forward'}: "
            f"CUDA error {rc} ({msg})"
        )
    if transpose:
        launches.bwd_launches += 1
    else:
        launches.fwd_launches += 1
    return out


BlockResidentFn = block_prop.make_block_prop_fn("BlockResidentFn", _cuda_prop)


def block_propagate_resident(hb, pool, item_pool, item_row, item_col,
                             item_permT, item_colT, num_items) -> torch.Tensor:
    """out [nb, bs, F] fp32 (kernels/block_prop.py has the contract).
    CPU tensors run the plain version; CUDA tensors run the kernels, or
    raise. `num_items` is the batch's real item count, an int32 on the
    device, read by the kernel with no host sync."""
    return BlockResidentFn.apply(hb, pool, item_pool, item_row, item_col,
                                 item_permT, item_colT, num_items)
