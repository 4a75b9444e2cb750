"""Dense GCN trunk — the port of dgcnn_tpu/kernels/dense_trunk.py.

For every graph slot s, with weight set k = wsel[s]:

    h_1 = tanh(adj @ hw1 + b_1[k]) · mask
    h_i = tanh(adj @ (h_{i-1} @ W_i[k]) + b_i[k]) · mask        i = 2..L
    cat = [h_1 ‖ … ‖ h_L]                                      [S, T, Σd]

`hw1 = x @ W1` stays outside (a plain `torch.matmul` in models/dgcnn.py,
as the reference leaves it to XLA), and autograd carries d_W1 and d_x
through it once `d_hw1` flows out of `GcnTrunkFn`.

Symmetry contract: `adj` must be symmetric (adjᵀ = adj). The normalized
adjacency D̂^{-1/2}(A+I)D̂^{-1/2} of an undirected graph is, and the
backward — of the CUDA kernel and of `gcn_trunk_plain_bwd` alike — uses
`adj` where the true gradient has `adjᵀ`, as the TPU kernel does.

Three implementations of one function live here:
  * `gcn_trunk_plain` / `gcn_trunk_plain_bwd`: the plain PyTorch chain and
    its written-out reverse recurrence, the same algorithm the kernel
    runs, so it is tested on the CPU against JAX before the card runs it;
  * the CUDA kernels (csrc/dense_trunk.cu — design and bound in its
    header), reached through `_cuda_fwd` / `_cuda_bwd`;
  * `gcn_trunk`, the public entry: `GcnTrunkFn` runs the plain version
    for CPU tensors and the kernels for CUDA tensors, or raises. There is
    no fallback from the kernel to the plain version.

`launches.fwd_launches` / `launches.bwd_launches` count one per trunk
forward / backward that ran on the kernels (a forward is L layer
launches; a backward L + 2).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

MAX_LAYERS = 8
MAX_WIDTH = 128
_BM = 32  # rows per block, csrc/dense_trunk.cu BM


class LaunchCounts:
    """Plain integer counts of trunk launches on the card."""

    def __init__(self):
        self.fwd_launches = 0
        self.bwd_launches = 0

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0


launches = LaunchCounts()


def _offsets(dims: Sequence[int]) -> List[int]:
    out = [0]
    for d in dims:
        out.append(out[-1] + int(d))
    return out


def _check(dims, adj, hw1, mask, wsel, ws, bs) -> int:
    """Validate everything the kernel relies on; returns K."""
    dims = tuple(int(d) for d in dims)
    n = len(dims)
    if not 1 <= n <= MAX_LAYERS or any(not 1 <= d <= MAX_WIDTH for d in dims):
        raise ValueError(
            f"dims {dims}: the trunk takes 1..{MAX_LAYERS} layers of width "
            f"1..{MAX_WIDTH}"
        )
    if adj.dtype == torch.bfloat16:
        raise NotImplementedError(
            "bf16 adjacency is not ported yet (ROADMAP Queue 1 item 10, "
            "mixed precision)"
        )
    if len(ws) != n - 1 or len(bs) != n:
        raise ValueError(f"need {n - 1} weights and {n} biases for dims {dims}")
    tensors = (adj, hw1, mask, *ws, *bs)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"trunk tensors must be float32, got {t.dtype}")
    if wsel.dtype != torch.int32:
        raise TypeError(f"wsel must be int32, got {wsel.dtype}")
    dev = adj.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gcn_trunk runs on cpu or cuda, got {dev}")
    for t in (*tensors, wsel):
        if t.device != dev:
            raise ValueError(f"all trunk tensors must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("trunk tensors must be contiguous")
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"adj must be [S, T, T], got {tuple(adj.shape)}")
    s, t = adj.shape[0], adj.shape[1]
    if tuple(hw1.shape) != (s, t, dims[0]):
        raise ValueError(f"hw1 must be {(s, t, dims[0])}, got {tuple(hw1.shape)}")
    if tuple(mask.shape) != (s, t):
        raise ValueError(f"mask must be {(s, t)}, got {tuple(mask.shape)}")
    if tuple(wsel.shape) != (s,):
        raise ValueError(f"wsel must be {(s,)}, got {tuple(wsel.shape)}")
    k = bs[0].shape[0]
    if k < 1:
        raise ValueError("need at least one weight set")
    for i, w in enumerate(ws):
        if tuple(w.shape) != (k, dims[i], dims[i + 1]):
            raise ValueError(
                f"W{i + 2} must be {(k, dims[i], dims[i + 1])}, got {tuple(w.shape)}"
            )
    for i, b in enumerate(bs):
        if tuple(b.shape) != (k, dims[i]):
            raise ValueError(f"b{i + 1} must be {(k, dims[i])}, got {tuple(b.shape)}")
    return k


# -- plain PyTorch version -----------------------------------------------


def gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs) -> torch.Tensor:
    """The `bmm`/tanh chain: cat [S, T, Σdims]."""
    sel = wsel.long()
    m = mask[..., None]
    hw = hw1
    outs = []
    for i in range(len(dims)):
        h = torch.tanh(torch.bmm(adj, hw) + bs[i][sel][:, None, :]) * m
        outs.append(h)
        if i + 1 < len(dims):
            hw = torch.bmm(h, ws[i][sel])
    return torch.cat(outs, dim=-1)


def gcn_trunk_plain_bwd(
    dims, adj, mask, wsel, ws, cat, g
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The kernel's reverse recurrence written out in PyTorch (uses
    adjᵀ = adj). Returns (d_hw1 [S,T,d1], per-slot dW_i [S,d_{i-1},d_i]
    for i = 2..L, per-slot db_i [S,d_i] for i = 1..L)."""
    offs = _offsets(dims)
    n = len(dims)
    sel = wsel.long()
    m = mask[..., None]
    d_chain = torch.zeros_like(cat[..., offs[n - 1] : offs[n]])
    dws: List[torch.Tensor] = [None] * (n - 1)
    dbs: List[torch.Tensor] = [None] * n
    d_hw1 = None
    for i in range(n - 1, -1, -1):
        h = cat[..., offs[i] : offs[i + 1]]
        d_pre = (g[..., offs[i] : offs[i + 1]] + d_chain) * m * (1.0 - h * h)
        d_hw = torch.bmm(adj, d_pre)  # adjᵀ = adj
        dbs[i] = d_pre.sum(dim=1)
        if i > 0:
            h_prev = cat[..., offs[i - 1] : offs[i]]
            dws[i - 1] = torch.bmm(h_prev.mT, d_hw)
            d_chain = torch.bmm(d_hw, ws[i - 1][sel].mT)
        else:
            d_hw1 = d_hw
    return d_hw1, dws, dbs


def _segment_sum(slot_grads: torch.Tensor, wsel: torch.Tensor, k: int) -> torch.Tensor:
    """Sum per-slot rows [S, P] into per-weight-set rows [K, P] as a
    one-hot product: deterministic on the card, unlike `index_add_`."""
    onehot = (
        wsel.long()[None, :]
        == torch.arange(k, device=wsel.device)[:, None]
    ).to(slot_grads.dtype)
    return onehot @ slot_grads


def _grad_layout(dims) -> Tuple[List[int], List[int], int]:
    """Offsets of dW_i (i = 2..L) and db_i (i = 1..L) in one flat row of
    P per-slot gradient values, the kernel's scratch layout."""
    woff, p = [0], 0
    for a, b in zip(dims[:-1], dims[1:]):
        woff.append(p)
        p += a * b
    dboff = []
    for d in dims:
        dboff.append(p)
        p += d
    return woff, dboff, p


def _split_grads(flat: torch.Tensor, dims):
    woff, dboff, _ = _grad_layout(dims)
    dws = [
        flat[:, woff[i] : woff[i] + dims[i - 1] * dims[i]].reshape(
            -1, dims[i - 1], dims[i]
        )
        for i in range(1, len(dims))
    ]
    dbs = [flat[:, dboff[i] : dboff[i] + dims[i]] for i in range(len(dims))]
    return dws, dbs


# -- CUDA kernels --------------------------------------------------------


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("dense_trunk")
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.trunk_fwd_layer_f32.argtypes = [P] * 8 + [I] * 8 + [P]
        lib.trunk_bwd_first_f32.argtypes = [P] * 5 + [I] * 8 + [P]
        lib.trunk_bwd_layer_f32.argtypes = [P] * 9 + [I] * 11 + [P]
        lib.trunk_reduce_blocks_f32.argtypes = [P, P, I, I, I, P]
        for f in (lib.trunk_fwd_layer_f32, lib.trunk_bwd_first_f32,
                  lib.trunk_bwd_layer_f32, lib.trunk_reduce_blocks_f32):
            f.restype = I
        lib.trunk_error_string.argtypes = [I]
        lib.trunk_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _ok(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.trunk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _bucket(dims) -> int:
    w = max(dims)
    return 32 if w <= 32 else 64 if w <= 64 else 128


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k) -> torch.Tensor:
    lib = _lib()
    s, t = adj.shape[0], adj.shape[1]
    offs = _offsets(dims)
    cdim = offs[-1]
    dpb = _bucket(dims)
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        cat = torch.empty((s, t, cdim), dtype=torch.float32, device=adj.device)
        hw = hw1
        for i, d in enumerate(dims):
            dn = dims[i + 1] if i + 1 < len(dims) else 0
            hw_next = (
                torch.empty((s, t, dn), dtype=torch.float32, device=adj.device)
                if dn else None
            )
            rc = lib.trunk_fwd_layer_f32(
                adj.data_ptr(), hw.data_ptr(), mask.data_ptr(), wsel.data_ptr(),
                bs[i].data_ptr(), _ptr(ws[i] if dn else None), cat.data_ptr(),
                _ptr(hw_next), s, t, d, dn, cdim, offs[i], k, dpb, stream,
            )
            _ok(lib, rc, f"trunk forward layer {i + 1}")
            hw = hw_next
    launches.fwd_launches += 1
    return cat


def _cuda_bwd(dims, adj, mask, wsel, ws, cat, g, k):
    """Returns (d_hw1, per-slot gradient rows [S, P])."""
    lib = _lib()
    s, t = adj.shape[0], adj.shape[1]
    offs = _offsets(dims)
    cdim = offs[-1]
    n = len(dims)
    woff, dboff, p = _grad_layout(dims)
    nblk = -(-t // _BM)
    dpb = _bucket(dims)
    dev = adj.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        part = torch.empty((s, nblk, p), dtype=torch.float32, device=dev)
        dpre = torch.empty((s, t, dims[-1]), dtype=torch.float32, device=dev)
        rc = lib.trunk_bwd_first_f32(
            cat.data_ptr(), g.data_ptr(), mask.data_ptr(), dpre.data_ptr(),
            part.data_ptr(), s, t, dims[-1], cdim, offs[n - 1], p,
            dboff[n - 1], dpb, stream,
        )
        _ok(lib, rc, "trunk backward start")
        for i in range(n - 1, -1, -1):
            dp = dims[i - 1] if i > 0 else 0
            out = torch.empty(
                (s, t, dp if i > 0 else dims[0]), dtype=torch.float32, device=dev
            )
            rc = lib.trunk_bwd_layer_f32(
                adj.data_ptr(), dpre.data_ptr(), cat.data_ptr(), g.data_ptr(),
                mask.data_ptr(), wsel.data_ptr(),
                _ptr(ws[i - 1] if i > 0 else None), out.data_ptr(),
                part.data_ptr(), s, t, dims[i], dp, cdim,
                offs[i - 1] if i > 0 else 0, k, p,
                woff[i] if i > 0 else 0, dboff[i - 1] if i > 0 else 0,
                dpb, stream,
            )
            _ok(lib, rc, f"trunk backward layer {i + 1}")
            dpre = out
        flat = torch.empty((s, p), dtype=torch.float32, device=dev)
        rc = lib.trunk_reduce_blocks_f32(
            part.data_ptr(), flat.data_ptr(), s, nblk, p, stream
        )
        _ok(lib, rc, "trunk backward block reduction")
    launches.bwd_launches += 1
    return dpre, flat


# -- autograd packaging and the public entry -----------------------------


class GcnTrunkFn(torch.autograd.Function):
    """cat = trunk(adj, hw1, mask, wsel, W2..WL, b1..bL). Gradients flow to
    hw1, the weights and the biases; `adj`, `mask` and `wsel` get none
    (the adjacency is data). Saves `cat` for the backward."""

    @staticmethod
    def forward(dims, adj, hw1, mask, wsel, *wb):
        n = len(dims)
        ws, bs = wb[: n - 1], wb[n - 1 :]
        k = _check(dims, adj, hw1, mask, wsel, ws, bs)
        if adj.is_cuda:
            return _cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k)
        return gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dims, adj, _hw1, mask, wsel, *wb = inputs
        n = len(dims)
        ctx.dims = tuple(int(d) for d in dims)
        ctx.k = wb[n - 1].shape[0]
        ctx.save_for_backward(adj, mask, wsel, output, *wb[: n - 1])

    @staticmethod
    def backward(ctx, g):
        adj, mask, wsel, cat, *ws = ctx.saved_tensors
        dims, k = ctx.dims, ctx.k
        g = g.contiguous()
        if adj.is_cuda:
            d_hw1, flat = _cuda_bwd(dims, adj, mask, wsel, ws, cat, g, k)
        else:
            d_hw1, dws_slot, dbs_slot = gcn_trunk_plain_bwd(
                dims, adj, mask, wsel, ws, cat, g
            )
            flat = torch.cat(
                [d.reshape(d.shape[0], -1) for d in (*dws_slot, *dbs_slot)],
                dim=1,
            )
        dws, dbs = _split_grads(_segment_sum(flat, wsel, k), dims)
        return (None, None, d_hw1, None, None, *dws, *dbs)


def gcn_trunk(dims, adj, hw1, mask, wsel, ws, bs) -> torch.Tensor:
    """cat [S, T, Σdims] — see the module docstring.

    dims  layer widths, e.g. (32, 32, 32, 1): 1..8 layers, each 1..128
    adj   [S, T, T] float32, SYMMETRIC normalized adjacency
    hw1   [S, T, d1] = x @ W1 (computed by the caller)
    mask  [S, T] node mask
    wsel  [S] int32 weight-set id per slot (zeros when K == 1)
    ws    L−1 tensors [K, d_{i-1}, d_i] (W2..WL)
    bs    L tensors [K, d_i]

    CPU tensors run the plain version; CUDA tensors run the kernels."""
    return GcnTrunkFn.apply(tuple(int(d) for d in dims), adj, hw1, mask,
                            wsel, *ws, *bs)
