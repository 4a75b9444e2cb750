"""Cost split of the block-COO SpMM on the card — the port of
tools/probe_kernel_anatomy.py (its Pallas variants, `pallas_call` at :199).

    python -m dgcnn_tpu_torch.tools.probe_kernel_anatomy

GPU only. Prints one JSON line on stdout (each variant's device ms, warm
and L2-flushed, at each shape, with the bound, the plain version's and
cuSPARSE's time and the card's name and power limit), detail on stderr.
Without CUDA it prints `{"error": ...}` and exits 1: the probe times
kernels and has no CPU path.

The method is the reference probe's: each variant removes one cost from
the kernel, and a variant that computes a wrong result still runs the
same instructions otherwise. The variants (csrc/spmm_block_coo_probe.cu)
cover two designs of the same function:

  abuild            the A-build design: the TPU kernel's, and the port's
                    first version of csrc/spmm_block_coo.cu, moved there
                    unchanged (one block per output block-row builds each
                    item's 128×128 block A in shared memory, then A @ h[c]);
                    it lies on no training path now
  abuild_no_ah      A built, the product skipped
  abuild_no_abuild  A left stale, staging of h and the product kept
  direct            the slot-walk design, the kernel of
                    csrc/spmm_block_coo.cu (a warp per row adds each slot's
                    w·h[src] in the order `block_coo_order` builds)
  direct_no_fma     the walk and every load, no multiply-add
  empty             each row's position range read and zeros written: the
                    floor of launch, row pointers and output write

`abuild` and `direct` are asserted equal to `block_coo_plain` (within
rtol 1e-4 of the largest value) before anything is timed, as the
reference asserted its base variant equal to the library kernel (:252).

The reference's `unroll4`, `sel_const` and `bf16_sel` have no counterpart.
`unroll4` asked whether four accumulators hide the A-build → A@h
dependence in the TPU's matrix-unit pipeline; a CUDA block has no such
software pipeline to deepen (its warps interleave by themselves).
`sel_const` and `bf16_sel` asked what the vector unit's compare/select
sweeps building the one-hot selectors cost, and whether bf16 selectors
halve them; the card builds A with no selector matrices at all (a thread
adds each slot into its row of A), and the slot-walk design builds no A.

Shapes, all at F=32: the reference's standard one, `_batch_edges(rng(0),
2048, 8192)` (2,048 nodes; it draws exactly 8,192 edges, so it has no
padding); the same generator asked for 8,237 edges, which draws 8,194 and
pads 1,022 w=0 edges into node 2,047, one long row that a single warp of
the slot-walk design walks; and DD's mean batch as `--spmm pallas` trains
on it (`CooEngine`'s first epoch of fold 1, the GCN's weights: the edge
mask). Times are `utils/profiling.device_ms` (CUDA-graph replay; warm, and
after a 64 MB L2 flush net of the flush); the reference's
unroll-and-floor-subtraction worked around the TPU transport and is not
needed. The bound is `spmm_bound` of the edges with a nonzero weight;
the library time is `torch.sparse_csr_tensor` @ dense (cuSPARSE) on the
same edges, built outside the timed call.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from dgcnn_tpu_torch.kernels.dense_trunk import LaunchCounts

VARIANTS = ("abuild", "abuild_no_ah", "abuild_no_abuild", "direct",
            "direct_no_fma", "empty")
_AB_MODE = {"abuild": 0, "abuild_no_ah": 1, "abuild_no_abuild": 2}
_DIRECT_MODE = {"direct": 0, "direct_no_fma": 1, "empty": 2}
_AB_MAX_F = 128  # the A-build kernel's widest tile; wider h in chunks
STANDARD = (2048, 8192, 32)  # nodes, edges, F
# `_batch_edges(rng(0), 2048, 8192)` draws exactly 8,192 edges, a multiple
# of 1,024, so it has no padding. Asked for 8,237 it draws 8,194 and pads
# 1,022 w=0 edges into node 2,047: the long row.
LONG_ROW_EDGES = 8237

launches = LaunchCounts()  # fwd_launches: one per variant launch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _lib():
    from dgcnn_tpu_torch.kernels import _build

    lib = _build.load("spmm_block_coo_probe")
    if not getattr(lib, "_dgcnn_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_abuild_f32.argtypes = [I] + [P] * 7 + [I] * 3 + [P]
        lib.probe_abuild_f32.restype = I
        lib.probe_direct_f32.argtypes = [I] + [P] * 7 + [I] * 3 + [P]
        lib.probe_direct_f32.restype = I
        lib.probe_error_string.argtypes = [I]
        lib.probe_error_string.restype = ctypes.c_char_p
        lib._dgcnn_bound = True
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"spmm_block_coo_probe {what}: CUDA error {rc} "
                           f"({lib.probe_error_string(rc).decode()})")


def abuild(row_ptr, item_c, ls, ld, w_pad, h, variant: str = "abuild") -> torch.Tensor:
    """One A-build variant over one orientation (CUDA tensors; column
    chunks of 128 for wider h)."""
    if not h.is_cuda:
        raise ValueError("the probe's kernels run on CUDA tensors only")
    lib = _lib()
    n, f = h.shape
    outs = []
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, f, _AB_MAX_F):
            hc = h if f <= _AB_MAX_F else h[:, c0 : c0 + _AB_MAX_F].contiguous()
            out = torch.empty((n, hc.shape[1]), dtype=torch.float32, device=h.device)
            rc = lib.probe_abuild_f32(
                _AB_MODE[variant], row_ptr.data_ptr(), item_c.data_ptr(),
                ls.data_ptr(), ld.data_ptr(), w_pad.data_ptr(), hc.data_ptr(),
                out.data_ptr(), n // 128, hc.shape[1], ls.shape[1], stream)
            _raise_on(lib, rc, variant)
            outs.append(out)
    launches.fwd_launches += 1
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def direct(row_ptr, perm, item_c, ls, w_pad, h, variant: str = "direct") -> torch.Tensor:
    """One slot-walk variant over one orientation and its slot order (CUDA
    tensors, any F)."""
    if not h.is_cuda:
        raise ValueError("the probe's kernels run on CUDA tensors only")
    lib = _lib()
    n, f = h.shape
    with torch.cuda.device(h.device):
        out = torch.empty((n, f), dtype=torch.float32, device=h.device)
        rc = lib.probe_direct_f32(
            _DIRECT_MODE[variant], row_ptr.data_ptr(), perm.data_ptr(),
            item_c.data_ptr(), ls.data_ptr(), w_pad.data_ptr(), h.data_ptr(),
            out.data_ptr(), n, f, ls.shape[1], torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, rc, variant)
    launches.fwd_launches += 1
    return out


@dataclasses.dataclass
class Shape:
    """One batch's forward orientation as the variants take it (tensors on
    the card), with its edges for the bound and the library call."""

    label: str
    structure: object   # BlockCOO of tensors
    w_pad: torch.Tensor
    order: object       # EdgeOrder over the slots (block_coo_order)
    h: torch.Tensor
    src: np.ndarray     # edges with a nonzero weight
    dst: np.ndarray
    w: np.ndarray

    @property
    def n(self) -> int:
        return self.h.shape[0]

    def describe(self) -> Dict[str, object]:
        """Counts of the shape; `longest_row` in slots of the order (w=0
        slots that carry an edge included)."""
        s, rp = self.structure, self.order.row_ptr
        return {"nodes": self.n, "f": self.h.shape[1], "edges": int(self.src.shape[0]),
                "items": int(s.row_ptr[-1]), "item_axis": int(s.ls.shape[0]),
                "eb": int(s.ls.shape[1]), "slots": int(rp[-1]),
                "rows_read": int(np.unique(self.src).shape[0]),
                "longest_row": int((rp[1:] - rp[:-1]).max())}


def make_shape(label, structure, w_pad, h, device) -> Shape:
    """A `Shape` from a host structure (NumPy), its forward slot weights and
    h; the edges are read back off the structure's non-null slots."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import BS, block_coo_order

    perm = np.asarray(structure.perm)
    real = (perm >= 0) & (np.asarray(w_pad) != 0)
    item_c = np.asarray(structure.item_c)
    item_r = np.asarray(structure.item_r)
    rows = np.broadcast_to(np.arange(perm.shape[0])[:, None], perm.shape)[real]
    src = item_c[rows] * BS + np.asarray(structure.ls)[real]
    dst = item_r[rows] * BS + np.asarray(structure.ld)[real]
    st = structure.map(lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device))
    return Shape(label=label, structure=st,
                 w_pad=torch.from_numpy(np.ascontiguousarray(w_pad, np.float32)).to(device),
                 order=block_coo_order(st, h.shape[0]), h=h.to(device),
                 src=src, dst=dst, w=np.asarray(w_pad)[real])


def standard_shape(device, num_edges: int = STANDARD[1]) -> Shape:
    """The reference probe's shape: `_batch_edges(rng(0), 2048, num_edges)`,
    the structure of all its edges (the w=0 padding ones too), F=32;
    `num_edges` = LONG_ROW_EDGES gives the long row."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import build_block_coo, pad_weights
    from dgcnn_tpu_torch.utils.profiling import _batch_edges

    n, _, f = STANDARD
    rng = np.random.default_rng(0)
    src, dst, w = _batch_edges(rng, n, num_edges)
    s = build_block_coo(src, dst, n)
    h = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32) * 0.01)
    what = "standard" if num_edges == STANDARD[1] else "long row"
    return make_shape(f"{what} ({n} nodes, {len(src)} edges of which "
                      f"{int((w == 0).sum())} w=0 padding, F={f})", s,
                      pad_weights(s, w), h, device)


def coo_engine_epoch(name: str, gs, device):
    """Fold 1's first training epoch of `gs` as `--spmm pallas` trains on it
    (CLI defaults: seed 324, batch 50, 2 folds): `CooEngine` packs it into
    the worst-case bucket with block-pair structures, exactly as it ships
    them, on the host. Returns (engine, stacked epoch, seconds to pack)."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.train.cv import CooEngine

    cfg = Config(data_type=name, batch_size=50, layout="coo", spmm_impl="pallas")
    engine = CooEngine(cfg, gs, device)
    tr, _ = get_folds(gs.y, "", 2, cfg.seed, data_type=name)[0]
    perm = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1])).permutation(len(tr))
    t0 = time.perf_counter()
    stack = engine.pack_host(gs.subset(tr), perm)
    return engine, stack, time.perf_counter() - t0


def mean_row(stack) -> int:
    """The batch of a stacked epoch whose real edge count is nearest the mean."""
    edges = stack.edge_mask.sum(1)
    return int(np.argmin(np.abs(edges - edges.mean())))


def stack_shape(label, stack, r, device, f: int = 32) -> Shape:
    """Batch `r` of a `CooEngine` epoch: its structure and the GCN's slot
    weights (the edge mask), h random from a seed."""
    from dgcnn_tpu_torch.batching.packer import batch_step

    structure, w_pad, _ = batch_step(stack, r).blockcoo
    n = stack.x.shape[1]
    h = torch.from_numpy(np.random.default_rng(r).normal(size=(n, f)).astype(np.float32) * 0.01)
    return make_shape(label, structure, w_pad, h, device)


def dd_shape(device) -> Shape:
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset

    _, stack, _ = coo_engine_epoch("DD", synthesize_tu_dataset("DD"), device)
    r = mean_row(stack)
    return stack_shape(f"DD CooEngine mean batch (row {r})", stack, r, device)


def _calls(shape: Shape):
    s, o, h, w = shape.structure, shape.order, shape.h, shape.w_pad
    calls = {}
    for v in VARIANTS:
        if v in _AB_MODE:
            calls[v] = (lambda v=v: abuild(s.row_ptr, s.item_c, s.ls, s.ld, w, h, v))
        else:
            calls[v] = (lambda v=v: direct(o.row_ptr, o.perm, s.item_c, s.ls, w, h, v))
    return calls


def plain(shape: Shape) -> torch.Tensor:
    from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_plain

    s = shape.structure
    return block_coo_plain(s.row_ptr, s.item_c, s.ls, s.ld, shape.w_pad, shape.h)


def check(shape: Shape) -> Dict[str, float]:
    """`abuild` and `direct` against `block_coo_plain`; raises on a
    disagreement. Returns each one's max abs error."""
    from dgcnn_tpu_torch.utils.profiling import rel_err

    want = plain(shape)
    errs = {}
    for v in ("abuild", "direct"):
        err, rel, ok = rel_err(_calls(shape)[v](), want)
        if not ok:
            raise AssertionError(f"{shape.label}: the {v} variant disagrees with "
                                 f"block_coo_plain (max abs {err:.3e}, rel {rel:.3e})")
        errs[v] = err
        log(f"  {shape.label}: {v} vs block_coo_plain max abs {err:.3e} rel {rel:.3e} (ok)")
    return errs


def library_call(shape: Shape):
    """cuSPARSE: the shape's edges as one `torch.sparse_csr_tensor` @ h."""
    order = np.argsort(shape.dst, kind="stable")
    dev = shape.h.device
    crow = np.searchsorted(shape.dst[order], np.arange(shape.n + 1))
    a = torch.sparse_csr_tensor(
        torch.from_numpy(crow.astype(np.int64)).to(dev),
        torch.from_numpy(shape.src[order].astype(np.int64)).to(dev),
        torch.from_numpy(shape.w[order].astype(np.float32)).to(dev),
        size=(shape.n, shape.n))
    return lambda: a @ shape.h


def measure(shape: Shape, flush) -> Dict[str, object]:
    """Every variant's warm and L2-flushed device ms at one shape, with the
    bound, the plain version's, the library call's and the slot order's
    build time."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_order
    from dgcnn_tpu_torch.utils.profiling import device_ms, events_ms, rel_err, spmm_bound

    d = shape.describe()
    bnd = spmm_bound(d["edges"], shape.n, d["rows_read"], d["f"])
    lib = library_call(shape)
    err, _, ok = rel_err(lib(), plain(shape))
    if not ok:
        raise AssertionError(f"{shape.label}: the CSR product disagrees ({err:.3e})")
    row = dict(d, bound_ms=bnd[0], bound_by=bnd[1], library_ms=events_ms(lib),
               plain_ms=device_ms(lambda: plain(shape)),
               order_ms=device_ms(lambda: block_coo_order(shape.structure, shape.n)),
               variants={})
    for v, fn in _calls(shape).items():
        row["variants"][v] = {"ms": device_ms(fn), "ms_l2_flushed": device_ms(fn, flush)}
    log(f"  {shape.label}: {d}; bound {bnd[0]:.4f} ms ({bnd[1]}), cuSPARSE "
        f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, slot order "
        f"{row['order_ms']:.4f} ms")
    for v, t in row["variants"].items():
        log(f"    {v:17s} {t['ms']:.4f} ms (L2-flushed {t['ms_l2_flushed']:.4f})")
    return row


def run(shapes: List[Shape], device) -> Dict[str, object]:
    """Check, then time every shape; `launches` counts the timing's
    launches only (the checks' are reset away)."""
    from dgcnn_tpu_torch.utils.profiling import Flush, card_line

    errs = {s.label: check(s) for s in shapes}
    flush = Flush(device)
    launches.reset()
    rows = {s.label: measure(s, flush) for s in shapes}
    for label in rows:
        rows[label]["max_abs_err"] = errs[label]
    return {"card": card_line(), "device": torch.cuda.get_device_name(device),
            "launches": launches.fwd_launches, "shapes": rows}


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: the probe times kernels on the "
                                   "card and has no CPU path"}), flush=True)
        return 1
    from dgcnn_tpu_torch.train.cv import fp32_only

    fp32_only()
    device = torch.device("cuda")
    log("probe_kernel_anatomy: building the shapes")
    result = run([standard_shape(device), standard_shape(device, LONG_ROW_EDGES),
                  dd_shape(device)], device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
