"""Dense GCN trunk — the port of dgcnn_tpu/kernels/dense_trunk.py.

For every graph slot s, with weight set k = wsel[s]:

    h_1 = tanh(adj @ hw1 + b_1[k]) · mask
    h_i = tanh(adj @ (h_{i-1} @ W_i[k]) + b_i[k]) · mask        i = 2..L
    cat = [h_1 ‖ … ‖ h_L]                                      [S, T, Σd]

`hw1 = x @ W1` stays outside (a plain `torch.matmul` in models/dgcnn.py,
as the reference leaves it to XLA), and autograd carries d_W1 and d_x
through it once `d_hw1` flows out of `GcnTrunkFn`.

The adjacency is float32 or bfloat16; everything else is float32. A bf16
adjacency is the TPU kernel's bf16 mode (dgcnn_tpu/kernels/
dense_trunk.py:93, :152): each operand that meets it in a product, hw in
the forward and d_pre in the backward, is rounded to bf16 (round to
nearest even), the products are exact in fp32 and summed in fp32; dW, db,
the chain and d_hw1 stay fp32. `round_h=True` (bf16 compute; needs a bf16
adjacency) also rounds each layer's output h to bf16, in cat and as the
h @ W operand: with W_i passed already rounded by the caller, that is the
reference's einsum chain under compute_dtype=bfloat16 (models/dgcnn.py
:266-293), which its own fused kernel never runs. The backward is the
same in both bf16 forms (the reference's autodiff of its chain rounds
d_hw after the adjacency product and the chain cotangents between layers;
the kernel rounds d_pre before it, as the TPU kernel does, and keeps the
rest fp32: the two agree within bf16 tolerance).

Symmetry contract: `adj` must be symmetric (adjᵀ = adj). The normalized
adjacency D̂^{-1/2}(A+I)D̂^{-1/2} of an undirected graph is, and the
backward — of the CUDA kernel and of `gcn_trunk_plain_bwd` alike — uses
`adj` where the true gradient has `adjᵀ`, as the TPU kernel does.

Three implementations of one function live here:
  * `gcn_trunk_plain` / `gcn_trunk_plain_bwd`: the plain PyTorch chain and
    its written-out reverse recurrence, the same algorithm the kernels
    run, so it is tested on the CPU against JAX before the card runs it;
  * the CUDA kernels (csrc/dense_trunk.cu — design and bound in its
    header), reached through `_cuda_fwd` / `_cuda_bwd`;
  * `gcn_trunk`, the public entry: `GcnTrunkFn` runs the plain version
    for CPU tensors and the kernels for CUDA tensors, or raises. There is
    no fallback from the kernel to the plain version.

Read once per direction, the adjacency feeds 48 flop per byte at dims
(32, 32, 32, 1), over the H100's fp32 ridge of 20: the trunk is bound by
fp32 FMA throughput. `trunk_plan` (pure Python) picks one of two regimes
from the kernels' shared-memory formulas, mirrored here:
  * resident — both directions fit one block's shared memory for a
    cluster of C ∈ {1, 2, 4} blocks per slot, each holding a band of rows
    of the adjacency for every layer (T = 32, 88, 112, 176 at S = 56; up
    to T = 320 at dims (32, 32, 32, 1)): ONE launch per forward and ONE
    per backward;
  * streamed — everything else (T = 624, 2048, wide layers at larger T):
    a forward is L launches, a backward L + 2 (`launches_per_call`).
`_cuda_fwd` / `_cuda_bwd` take a forced plan for measurement only.

`launches.fwd_launches` / `launches.bwd_launches` count one per trunk
forward / backward that ran on the kernels, whatever the regime
(`bf16_fwd` / `bf16_bwd`: those with a bf16 adjacency);
`launches.resident_fwd`, `resident_bwd`, `streamed_fwd` and
`streamed_bwd` split the same calls by regime; `kernel_fwd` / `kernel_bwd`
count the kernels those calls launched, one beside each launch (a
resident call launches one, a streamed forward L and a streamed backward
L + 2). A call captured in a CUDA
graph counts once, at capture; the fused runner's `CountedGraph`
(train/loop.py) takes that back and adds it once per replay, so the
counts are of calls run, replays included.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import List, NamedTuple, Sequence, Tuple

import torch

MAX_LAYERS = 8
MAX_WIDTH = 128


class LaunchCounts:
    """Plain integer counts of trunk launches on the card."""

    def __init__(self):
        self.fwd_launches = 0
        self.bwd_launches = 0

    def reset(self) -> None:
        self.fwd_launches = 0
        self.bwd_launches = 0


class TrunkLaunchCounts(LaunchCounts):
    """The per-call counts, the same split by regime, and the kernel
    launches those calls made."""

    def reset(self) -> None:
        super().reset()
        self.bf16_fwd = self.bf16_bwd = 0
        self.resident_fwd = self.resident_bwd = 0
        self.streamed_fwd = self.streamed_bwd = 0
        self.kernel_fwd = self.kernel_bwd = 0

    __init__ = reset


launches = TrunkLaunchCounts()


def _offsets(dims: Sequence[int]) -> List[int]:
    out = [0]
    for d in dims:
        out.append(out[-1] + int(d))
    return out


def _check(dims, adj, hw1, mask, wsel, ws, bs, round_h=False) -> int:
    """Validate everything the kernel relies on; returns K."""
    dims = tuple(int(d) for d in dims)
    n = len(dims)
    if not 1 <= n <= MAX_LAYERS or any(not 1 <= d <= MAX_WIDTH for d in dims):
        raise ValueError(
            f"dims {dims}: the trunk takes 1..{MAX_LAYERS} layers of width "
            f"1..{MAX_WIDTH}"
        )
    if len(ws) != n - 1 or len(bs) != n:
        raise ValueError(f"need {n - 1} weights and {n} biases for dims {dims}")
    if adj.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adj must be float32 or bfloat16, got {adj.dtype}")
    if round_h and adj.dtype != torch.bfloat16:
        raise ValueError("round_h (bf16 compute) needs a bf16 adjacency")
    tensors = (adj, hw1, mask, *ws, *bs)
    for t in (hw1, mask, *ws, *bs):
        if t.dtype != torch.float32:
            raise TypeError(f"trunk tensors other than adj must be float32, "
                            f"got {t.dtype}")
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


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (round to nearest even) and widened back: the
    value a bf16 operand carries into an fp32 product."""
    return t.to(torch.bfloat16).to(t.dtype)


def _prop(adj: torch.Tensor):
    """(the adjacency as fp32, the rounding of what meets it): a bf16
    adjacency widens exactly and rounds its partner operand to bf16."""
    if adj.dtype == torch.bfloat16:
        return adj.float(), round_bf16
    return adj, lambda t: t


def gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs, round_h=False) -> torch.Tensor:
    """The `bmm`/tanh chain: cat [S, T, Σdims] (fp32; with a bf16
    adjacency hw rounds to bf16 where it meets it, and with `round_h`
    each h too)."""
    sel = wsel.long()
    m = mask[..., None]
    a, rnd = _prop(adj)
    hw = hw1
    outs = []
    for i in range(len(dims)):
        h = torch.tanh(torch.bmm(a, rnd(hw)) + bs[i][sel][:, None, :]) * m
        if round_h:
            h = round_bf16(h)
        outs.append(h)
        if i + 1 < len(dims):
            hw = torch.bmm(h, ws[i][sel])
    return torch.cat(outs, dim=-1)


def gcn_trunk_plain_bwd(
    dims, adj, mask, wsel, ws, cat, g
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """The kernel's reverse recurrence written out in PyTorch (uses
    adjᵀ = adj; with a bf16 adjacency d_pre rounds to bf16 where it meets
    it). Returns (d_hw1 [S,T,d1], per-slot dW_i [S,d_{i-1},d_i] for i =
    2..L, per-slot db_i [S,d_i] for i = 1..L)."""
    offs = _offsets(dims)
    n = len(dims)
    sel = wsel.long()
    m = mask[..., None]
    a, rnd = _prop(adj)
    d_chain = torch.zeros_like(cat[..., offs[n - 1] : offs[n]])
    dws: List[torch.Tensor] = [None] * (n - 1)
    dbs: List[torch.Tensor] = [None] * n
    d_hw1 = None
    for i in range(n - 1, -1, -1):
        h = cat[..., offs[i] : offs[i + 1]]
        d_pre = (g[..., offs[i] : offs[i + 1]] + d_chain) * m * (1.0 - h * h)
        d_hw = torch.bmm(a, rnd(d_pre))  # adjᵀ = adj
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


# -- the plan: which regime, how many blocks per slot ---------------------

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "dense_trunk.cu")


def _cu_constant(name: str) -> int:
    """`constexpr int <name> = <value>;` of csrc/dense_trunk.cu: the one
    definition the kernels and this plan share."""
    with open(_CU) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    return int(m.group(1))


SMEM_MAX = _cu_constant("SMEM_MAX")  # bytes of shared memory a block may use
SBM = _cu_constant("SBM")  # rows of a streamed block
SBK = _cu_constant("SBK")  # depth of a streamed K-tile
NUM_SMS = 132  # H100 SXM
CLUSTERS = (1, 2, 4)


class TrunkPlan(NamedTuple):
    """regime "resident" (one launch per direction, C blocks per slot in a
    thread-block cluster) or "streamed" (C = 0: a launch per layer), and
    the shared-memory bytes of one forward and one backward block."""

    regime: str
    c: int
    fwd_smem: int
    bwd_smem: int


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


# Shared-memory plans, formula for formula as csrc/dense_trunk.cu (bytes;
# `es` is the adjacency's element size, 4 for fp32 and 2 for bf16).
def band_rows(t: int, c: int) -> int:
    return _rup(-(-t // c), 8)


def _adj_pitch(t: int, es: int) -> int:
    # adjacency row pitch (elements): 16-byte rows, consecutive rows 16
    # bytes apart in the banks
    return _rup(t, 32) + 16 // es


def _resident_fwd_bytes(t: int, c: int, dp: int, es: int) -> int:
    # resident forward: adj band + 2 full hw + h band + W
    tb = band_rows(t, c)
    return (tb * _adj_pitch(t, es) * es
            + 4 * (2 * _rup(t, 4) * dp + tb * (dp + 4) + dp * dp))


def _resident_bwd_bytes(t: int, c: int, dp: int, es: int) -> int:
    # resident backward: adj band + 2 full d_pre + d_hw band + h_prev band +
    # W^T + (C > 1) two layers of partials [dW | db]
    tb = band_rows(t, c)
    return (tb * _adj_pitch(t, es) * es
            + 4 * (2 * _rup(t, 4) * dp + 2 * tb * (dp + 4) + dp * dp
                   + (2 * (dp * dp + dp) if c > 1 else 0)))


def _stream_stage_bytes(dp: int, es: int) -> int:
    # streamed: one K-stage = adj tile [SBM][SBK + 16/es] + hw tile [SBK][DP];
    # the epilogue's row buffers reuse the two stages; W separate
    return SBM * (SBK + 16 // es) * es + 4 * SBK * dp


def _stream_fwd_bytes(dp: int, es: int) -> int:
    return max(2 * _stream_stage_bytes(dp, es), 4 * SBM * (dp + 4)) + 4 * dp * dp


def _stream_bwd_bytes(dp: int, es: int) -> int:
    return max(2 * _stream_stage_bytes(dp, es), 4 * 3 * SBM * (dp + 4)) + 4 * dp * dp


def resident_smem(t: int, c: int, dims, es: int = 4) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes of one resident block, for
    an adjacency of `es` bytes an element."""
    dp = _bucket(dims)
    return _resident_fwd_bytes(t, c, dp, es), _resident_bwd_bytes(t, c, dp, es)


def trunk_plan(s: int, t: int, dims, c: int = None, regime: str = None,
               es: int = 4) -> TrunkPlan:
    """The regime for S slots of T rows at layer widths `dims`, for an
    adjacency of `es` bytes an element (4 fp32, 2 bf16). Resident
    when both directions fit SMEM_MAX for some C in CLUSTERS whose bands
    all hold rows: the smallest such C with S·C ≥ NUM_SMS / 2, else the
    largest. A resident call's time is one block's serial chain of
    layers, not the card's fill: on the H100 C = 2 (112 blocks at S = 56)
    beat C = 4 (224) by 5-9 % at T = 88 and tied at T = 176 (chip_smoke.py
    phase 5, in PERF.md). Otherwise streamed. `c` (resident) or `regime="streamed"`
    forces a plan, for measurement; a forced resident plan that does not
    fit is returned as it is and refused by the kernel."""
    dp = _bucket(dims)
    streamed = TrunkPlan("streamed", 0, _stream_fwd_bytes(dp, es),
                         _stream_bwd_bytes(dp, es))
    if regime == "streamed":
        return streamed
    if c is not None:
        return TrunkPlan("resident", c, *resident_smem(t, c, dims, es))
    fits = [c for c in CLUSTERS
            if (c - 1) * band_rows(t, c) < t
            and max(resident_smem(t, c, dims, es)) <= SMEM_MAX]
    if not fits:
        return streamed
    full = [c for c in fits if 2 * s * c >= NUM_SMS]
    c = full[0] if full else fits[-1]
    return TrunkPlan("resident", c, *resident_smem(t, c, dims, es))


def launches_per_call(plan: TrunkPlan, dims) -> Tuple[int, int]:
    """Kernel launches of one forward and one backward trunk call."""
    if plan.regime == "resident":
        return 1, 1
    return len(dims), len(dims) + 2


# -- CUDA kernels --------------------------------------------------------


class _TrunkArgs(ctypes.Structure):
    """csrc/dense_trunk.cu `TrunkArgs`, field for field."""

    _fields_ = [
        ("adj", ctypes.c_void_p), ("hw1", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("wsel", ctypes.c_void_p),
        ("w", ctypes.c_void_p * MAX_LAYERS), ("b", ctypes.c_void_p * MAX_LAYERS),
        ("cat_in", ctypes.c_void_p), ("g", ctypes.c_void_p),
        ("cat", ctypes.c_void_p), ("dhw1", ctypes.c_void_p),
        ("flat", ctypes.c_void_p),
        ("S", ctypes.c_int), ("T", ctypes.c_int), ("K", ctypes.c_int),
        ("L", ctypes.c_int), ("P", ctypes.c_int), ("C", ctypes.c_int),
        ("dims", ctypes.c_int * MAX_LAYERS),
        ("offs", ctypes.c_int * (MAX_LAYERS + 1)),
        ("woff", ctypes.c_int * MAX_LAYERS),
        ("dboff", ctypes.c_int * MAX_LAYERS),
    ]


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of csrc/dense_trunk.cu's C entries, in order
_SIGNATURES = {
    "trunk_resident_f32": [_I, ctypes.POINTER(_TrunkArgs), _I, _P],
    "trunk_resident_bf16": [_I, ctypes.POINTER(_TrunkArgs), _I, _I, _P],
    "trunk_stream_fwd_f32": [_P, _P, _I] + [_P] * 6 + [_I] * 8 + [_P],
    "trunk_stream_fwd_bf16": [_P, _P, _I] + [_P] * 6 + [_I] * 9 + [_P],
    "trunk_stream_bwd_first_f32": [_P] * 6 + [_I] * 9 + [_P],
    "trunk_stream_bwd_f32": [_P] * 9 + [_I] * 11 + [_P],
    "trunk_stream_bwd_bf16": [_P] * 9 + [_I] * 11 + [_P],
    "trunk_reduce_blocks_f32": [_P, _P, _I, _I, _I, _P],
    "trunk_smem_bytes": [_I] * 6,
    "trunk_error_string": [_I],
}


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("dense_trunk")
    if not getattr(lib, "_dgcnn_bound", False):
        for name, types in _SIGNATURES.items():
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = _I
        lib.trunk_smem_bytes.restype = ctypes.c_longlong
        lib.trunk_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def kernel_smem(plan: TrunkPlan, t: int, dims, es: int = 4) -> Tuple[int, int]:
    """(forward, backward) shared-memory bytes as the compiled kernels
    count them (needs the built library); equal to `plan`'s own."""
    lib, dp = _lib(), _bucket(dims)
    reg = 0 if plan.regime == "resident" else 1
    return tuple(int(lib.trunk_smem_bytes(reg, b, t, plan.c, dp, es)) for b in (0, 1))


def _ok(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.trunk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _bucket(dims) -> int:
    w = max(dims)
    return 32 if w <= 32 else 64 if w <= 64 else 128


def _ptr(t):
    return None if t is None else t.data_ptr()


def _args(dims, plan, adj, mask, wsel, ws, k) -> _TrunkArgs:
    s, t = adj.shape[0], adj.shape[1]
    woff, dboff, p = _grad_layout(dims)
    a = _TrunkArgs()
    a.adj, a.mask, a.wsel = adj.data_ptr(), mask.data_ptr(), wsel.data_ptr()
    for i, w in enumerate(ws):
        a.w[i + 1] = w.data_ptr()
    a.S, a.T, a.K, a.L, a.P, a.C = s, t, k, len(dims), p, plan.c
    for i, d in enumerate(dims):
        a.dims[i], a.woff[i], a.dboff[i] = d, woff[i], dboff[i]
    for i, o in enumerate(_offsets(dims)):
        a.offs[i] = o
    return a


def _cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k, plan=None,
              round_h=False) -> torch.Tensor:
    lib = _lib()
    s, t = adj.shape[0], adj.shape[1]
    bf16 = adj.dtype == torch.bfloat16
    plan = plan or trunk_plan(s, t, dims, es=adj.element_size())
    offs = _offsets(dims)
    cdim = offs[-1]
    dpb = _bucket(dims)
    dev = adj.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        cat = torch.empty((s, t, cdim), dtype=torch.float32, device=dev)
        if plan.regime == "resident":
            a = _args(dims, plan, adj, mask, wsel, ws, k)
            a.hw1, a.cat = hw1.data_ptr(), cat.data_ptr()
            for i, b in enumerate(bs):
                a.b[i] = b.data_ptr()
            rc = (lib.trunk_resident_bf16(0, ctypes.byref(a), dpb, int(round_h), stream)
                  if bf16 else lib.trunk_resident_f32(0, ctypes.byref(a), dpb, stream))
            _ok(lib, rc, f"trunk forward (resident, C={plan.c})")
            launches.kernel_fwd += 1
            launches.resident_fwd += 1
        else:
            hw, ld = hw1, dims[0]
            for i, d in enumerate(dims):
                dn = dims[i + 1] if i + 1 < len(dims) else 0
                # intermediate hw rows padded to the tile width, zero past dn
                hw_next = (torch.empty((s, t, dpb), dtype=torch.float32, device=dev)
                           if dn else None)
                args = (adj.data_ptr(), hw.data_ptr(), ld, mask.data_ptr(),
                        wsel.data_ptr(), bs[i].data_ptr(),
                        _ptr(ws[i] if dn else None), cat.data_ptr(), _ptr(hw_next),
                        s, t, d, dn, cdim, offs[i], k, dpb)
                rc = (lib.trunk_stream_fwd_bf16(*args, int(round_h), stream) if bf16
                      else lib.trunk_stream_fwd_f32(*args, stream))
                _ok(lib, rc, f"trunk forward layer {i + 1}")
                launches.kernel_fwd += 1
                hw, ld = hw_next, dpb
            launches.streamed_fwd += 1
    launches.fwd_launches += 1
    launches.bf16_fwd += bf16
    return cat


def _cuda_bwd(dims, adj, mask, wsel, ws, cat, g, k, plan=None):
    """Returns (d_hw1, per-slot gradient rows [S, P])."""
    lib = _lib()
    s, t = adj.shape[0], adj.shape[1]
    bf16 = adj.dtype == torch.bfloat16
    plan = plan or trunk_plan(s, t, dims, es=adj.element_size())
    offs = _offsets(dims)
    cdim = offs[-1]
    n = len(dims)
    woff, dboff, p = _grad_layout(dims)
    dpb = _bucket(dims)
    dev = adj.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        flat = torch.empty((s, p), dtype=torch.float32, device=dev)
        d_hw1 = torch.empty((s, t, dims[0]), dtype=torch.float32, device=dev)
        if plan.regime == "resident":
            a = _args(dims, plan, adj, mask, wsel, ws, k)
            a.cat_in, a.g = cat.data_ptr(), g.data_ptr()
            a.dhw1, a.flat = d_hw1.data_ptr(), flat.data_ptr()
            rc = (lib.trunk_resident_bf16(1, ctypes.byref(a), dpb, 0, stream)
                  if bf16 else lib.trunk_resident_f32(1, ctypes.byref(a), dpb, stream))
            _ok(lib, rc, f"trunk backward (resident, C={plan.c})")
            launches.kernel_bwd += 1
            launches.resident_bwd += 1
        else:
            nblk = -(-t // SBM)
            part = torch.empty((s, nblk, p), dtype=torch.float32, device=dev)
            dpre = torch.empty((s, t, dpb), dtype=torch.float32, device=dev)
            rc = lib.trunk_stream_bwd_first_f32(
                cat.data_ptr(), g.data_ptr(), mask.data_ptr(), wsel.data_ptr(),
                dpre.data_ptr(), part.data_ptr(), s, t, dims[-1], cdim,
                offs[n - 1], p, dboff[n - 1], k, dpb, stream,
            )
            _ok(lib, rc, "trunk backward start")
            launches.kernel_bwd += 1
            for i in range(n - 1, -1, -1):
                dp = dims[i - 1] if i > 0 else 0
                out = (torch.empty((s, t, dpb), dtype=torch.float32, device=dev)
                       if i > 0 else d_hw1)
                entry = lib.trunk_stream_bwd_bf16 if bf16 else lib.trunk_stream_bwd_f32
                rc = entry(
                    adj.data_ptr(), dpre.data_ptr(), cat.data_ptr(), g.data_ptr(),
                    mask.data_ptr(), wsel.data_ptr(),
                    _ptr(ws[i - 1] if i > 0 else None), out.data_ptr(),
                    part.data_ptr(), s, t, dims[i], dp, cdim,
                    offs[i - 1] if i > 0 else 0, k, p,
                    woff[i] if i > 0 else 0, dboff[i - 1] if i > 0 else 0,
                    dpb, stream,
                )
                _ok(lib, rc, f"trunk backward layer {i + 1}")
                launches.kernel_bwd += 1
                dpre = out
            rc = lib.trunk_reduce_blocks_f32(
                part.data_ptr(), flat.data_ptr(), s, nblk, p, stream
            )
            _ok(lib, rc, "trunk backward block reduction")
            launches.kernel_bwd += 1
            launches.streamed_bwd += 1
    launches.bwd_launches += 1
    launches.bf16_bwd += bf16
    return d_hw1, flat


# -- autograd packaging and the public entry -----------------------------


class GcnTrunkFn(torch.autograd.Function):
    """cat = trunk(adj, hw1, mask, wsel, W2..WL, b1..bL), `round_h` the
    bf16-compute flag. Gradients flow to hw1, the weights and the biases;
    `adj`, `mask` and `wsel` get none (the adjacency is data). Saves `cat`
    for the backward."""

    @staticmethod
    def forward(dims, round_h, adj, hw1, mask, wsel, *wb):
        n = len(dims)
        ws, bs = wb[: n - 1], wb[n - 1 :]
        k = _check(dims, adj, hw1, mask, wsel, ws, bs, round_h)
        if adj.is_cuda:
            return _cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k, round_h=round_h)
        return gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs, round_h)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dims, _round_h, adj, _hw1, mask, wsel, *wb = inputs
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
        return (None, None, None, d_hw1, None, None, *dws, *dbs)


def gcn_trunk(dims, adj, hw1, mask, wsel, ws, bs, round_h=False) -> torch.Tensor:
    """cat [S, T, Σdims] float32 — see the module docstring.

    dims  layer widths, e.g. (32, 32, 32, 1): 1..8 layers, each 1..128
    adj   [S, T, T] float32 or bfloat16, SYMMETRIC normalized adjacency
    hw1   [S, T, d1] = x @ W1 (computed by the caller)
    mask  [S, T] node mask
    wsel  [S] int32 weight-set id per slot (zeros when K == 1)
    ws    L−1 tensors [K, d_{i-1}, d_i] (W2..WL)
    bs    L tensors [K, d_i]

    round_h  bf16 compute: round each layer's h to bf16 (bf16 adj only)

    CPU tensors run the plain version; CUDA tensors run the kernels."""
    return GcnTrunkFn.apply(tuple(int(d) for d in dims), bool(round_h), adj, hw1,
                            mask, wsel, *ws, *bs)
