"""Block-sparse propagation, CSR form — the port of
dgcnn_tpu/kernels/block_pallas.py (`block_propagate_pallas` :170,
`pallas_call` :152, backward `_bwd` :201).

    out[r] = Σ_{w : item_row[w] = r} pool[item_pool[w]] @ hb[item_col[w]]

(the full contract is in kernels/block_prop.py). The CUDA kernel,
csrc/block_csr.cu (design and bound in its header), runs one block per
output block-row over that row's contiguous item run, found through a
row-pointer table (`block_prop.row_ptr`, a searchsorted over the segment
ids, computed here before the launch). The backward launches it again,
transposed, over the col-major traversal.

`block_propagate_csr` is the entry; `block_propagate_pallas` is the same
function under the reference's name. `launches.fwd_launches` /
`launches.bwd_launches` count one per forward / backward propagation
that ran on the kernel.
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

    lib = _build.load("block_csr")
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.block_csr_f32.argtypes = [P] * 6 + [I] * 3 + [P]
        lib.block_csr_f32.restype = I
        lib.block_csr_error_string.argtypes = [I]
        lib.block_csr_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _cuda_prop(hb, pool, ip, seg, src, num_items, transpose: bool) -> torch.Tensor:
    """One launch of csrc/block_csr.cu on the current stream."""
    del num_items  # the row pointers already exclude padded items
    lib = _lib()
    nb, bs, f = hb.shape
    with torch.cuda.device(hb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rp = block_prop.row_ptr(seg, nb)
        out = torch.empty((nb, bs, f), dtype=torch.float32, device=hb.device)
        rc = lib.block_csr_f32(
            pool.data_ptr(), hb.data_ptr(), rp.data_ptr(), ip.data_ptr(),
            src.data_ptr(), out.data_ptr(), nb, f, int(transpose), stream,
        )
    if rc != 0:
        msg = lib.block_csr_error_string(rc).decode()
        raise RuntimeError(f"block_csr {'backward' if transpose else 'forward'}: "
                           f"CUDA error {rc} ({msg})")
    if transpose:
        launches.bwd_launches += 1
    else:
        launches.fwd_launches += 1
    return out


BlockCsrFn = block_prop.make_block_prop_fn("BlockCsrFn", _cuda_prop)


def block_propagate_csr(hb, pool, item_pool, item_row, item_col, item_permT,
                        item_colT, num_items) -> torch.Tensor:
    """out [nb, bs, F] fp32 (kernels/block_prop.py has the contract).
    CPU tensors run the plain version; CUDA tensors run the kernel, or
    raise. `num_items` (the batch's real item count, int32) is checked
    and unused: the row pointers already leave padded items out."""
    return BlockCsrFn.apply(hb, pool, item_pool, item_row, item_col,
                            item_permT, item_colT, num_items)


block_propagate_pallas = block_propagate_csr
