"""Cost split of the two edge-stream SpMM kernels on the card.

    python -m dgcnn_tpu_torch.tools.probe_spmm_anatomy

GPU only. Prints one JSON line on stdout (each variant's device ms, warm,
per kernel, direction and width, with the card's name and power limit),
detail on stderr. Without CUDA it prints `{"error": ...}` and exits 1: the
probe times kernels and has no CPU path.

Each variant is csrc/spmm_rows.cu or csrc/spmm_edge_block.cu built again
with one cost taken out of the current design, the method of
tools/probe_block_anatomy.py. A variant computes a wrong result and
otherwise runs the same instructions:

  row kernel (spmm_rows)
    base        the kernel as it is
    no_h        the h loads taken out (the lanes add their column index):
                row pointers, index loads, sums and stores
    empty       no edge walked: the row pointers and the stores (the floor)
  edge-block kernel (spmm_edge_block)
    base        the kernel as it is
    no_gather   the h loads taken out of the run walks (each lane adds
                its position instead)
    no_finish   no straddling row counted or finished: no fence, no atomic
    no_zero     no row with no edge written (step 4)
    floor       all three taken out: the stream's loads, its runs, the
                walks' index reads, sums and stores
    runs_only   the floor without the walks: the stream's loads, the
                barrier, each run's start and end

at DD's mean device-assembled COO batch as chip_smoke.py times it (fold
1's first epoch of synthetic DD, batch 50, the train batch nearest the
mean edge count; random weights on its real edges), F ∈ {32, 1}, forward
and backward. The copies build into dgcnn_tpu_torch/_build/spmm_anatomy/.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from dgcnn_tpu_torch.kernels import _build

_H4 = "            load_h<V>(hv[j], h + (size_t)s * f + c);"
_H1 = "      hv = __ldg(h + colp[pb + lane]);"
_WALK = "    for (int pb = p0; pb < p1; pb += G) {"
_GATHER = "          load_h<V>(hv[j], h + (size_t)scol[q] * f + c);"
_FINISH = "    if (head || tail) arrive<G, V>(partial, out, counters, rr, span0, span1, f, gl);"
_WALK_RUN = "    walk_run<G, V>(scol, sw, h, q0, q1, f, gl,"
_ZERO = "  for (int i0 = 0; i0 < items; i0 += 2 * NT) {"

PATCHES = {
    "spmm_rows": {
        "base": [],
        "no_h": [(_H4, "            for (int v = 0; v < V; ++v) hv[j][v] = (float)s;"),
                 (_H1, "      hv = (float)colp[pb + lane];")],
        "empty": [(_WALK, "    for (int pb = p0; pb < p0; pb += G) {")],
    },
    "spmm_edge_block": {
        "base": [],
        "no_gather": [(_GATHER, "          for (int v = 0; v < V; ++v) hv[j][v] = (float)q;")],
        "no_finish": [(_FINISH, "    (void)span0, (void)span1;")],
        "no_zero": [(_ZERO, _ZERO.replace("i0 < items", "i0 < 0 * items"))],
    },
}
PATCHES["spmm_edge_block"]["floor"] = [
    p for v in ("no_gather", "no_finish", "no_zero") for p in PATCHES["spmm_edge_block"][v]]
PATCHES["spmm_edge_block"]["runs_only"] = PATCHES["spmm_edge_block"]["floor"] + [
    (_WALK_RUN, "    if (q1 < 0) walk_run<G, V>(scol, sw, h, q0, q1, f, gl,")]


def variant_source(kname: str, name: str, src: str) -> str:
    """The kernel's source with the costs `name` takes out (each patch must
    find its line at least once: a changed kernel fails here, not on the
    card)."""
    out = src
    for old, new in PATCHES[kname][name]:
        if old not in out:
            raise ValueError(f"{kname}.cu no longer has {old.strip()!r}")
        out = out.replace(old, new)
    return out


def build_variants() -> dict:
    """(kernel, variant) → loaded library, all nvcc builds in parallel."""
    procs = []
    for kname, variants in PATCHES.items():
        with open(os.path.join(_build.CSRC, kname + ".cu")) as f:
            src = f.read()
        for name in variants:
            d = os.path.join(_build.BUILD_DIR, "spmm_anatomy", name)
            os.makedirs(d, exist_ok=True)
            for hdr in os.listdir(_build.CSRC):
                if hdr.endswith(".cuh"):
                    with open(os.path.join(_build.CSRC, hdr)) as f, \
                            open(os.path.join(d, hdr), "w") as g:
                        g.write(f.read())
            with open(os.path.join(d, kname + ".cu"), "w") as g:
                g.write(variant_source(kname, name, src))
            lib = os.path.join(d, f"lib{kname}.so")
            procs.append((kname, name, lib, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, kname + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for kname, name, path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of {kname}.cu:\n{log}")
        libs[(kname, name)] = ctypes.CDLL(path)
    return libs


def dd_mean_coo_batch(device):
    """chip_smoke.py's DD COO mean batch (DeviceCooEngine), with random
    weights on its real edges and its edge order (padding left out)."""
    from dgcnn_tpu_torch.batching.dense import order_matrix
    from dgcnn_tpu_torch.batching.device_coo import gather_coo_batch
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.ops.spmm import edge_order
    from dgcnn_tpu_torch.train.cv import DeviceCooEngine

    gs = synthesize_tu_dataset("DD")
    cfg = Config(data_type="DD", batch_size=50, layout="coo")
    engine = DeviceCooEngine(cfg, gs, device)
    tr, te = get_folds(gs.y, "", 2, cfg.seed, data_type="DD")[0]
    engine.begin_fold(tr, te)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1]))
    order = order_matrix(np.asarray(tr, np.int32)[rng.permutation(len(tr))], 50,
                         engine.slots)
    bucket = engine.bucket_for(order, engine._test_np)
    edges = (engine._edge_counts[np.maximum(order, 0)] * (order >= 0)).sum(1)
    row = int(np.argmin(np.abs(edges - edges.mean())))
    b = gather_coo_batch(engine.dev, torch.from_numpy(order[row]).to(device), bucket)
    gen = torch.Generator(device=device).manual_seed(row)
    w = (torch.rand(b.edge_mask.shape, generator=gen, device=device) + 0.5) * b.edge_mask
    o = edge_order(b.edge_src, b.edge_dst, b.x.shape[0], edge_mask=b.edge_mask,
                   dst_sorted=True)
    return b, w, o


def run(device) -> dict:
    from dgcnn_tpu_torch.kernels import spmm_pallas as sp
    from dgcnn_tpu_torch.utils.profiling import card_line, device_ms

    libs = build_variants()
    b, w, o = dd_mean_coo_batch(device)
    n, e = b.x.shape[0], b.edge_src.shape[0]
    result = {"shape": f"DD COO mean batch: {int(o.row_ptr[-1])} real edges of {e}, N {n}",
              "card": card_line(), "kernels": {}}
    gen = torch.Generator(device=device).manual_seed(11)
    blocks = max(-(-e // sp.EDGE_BLOCK), 1)
    for f in (32, 1):
        x = torch.randn((n, f), generator=gen, device=device)
        for (kname, name), lib in libs.items():
            entry = getattr(lib, kname + "_f32")
            n_ptr, n_int = sp.ENTRY_ARGS[kname]
            entry.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
                ctypes.c_void_p]
            entry.restype = ctypes.c_int
            for d, tr in (("fwd", False), ("bwd", True)):
                rp, perm, row, colp = ((o.row_ptrT, o.permT, b.edge_src, o.colT) if tr
                                       else (o.row_ptr, o.perm, b.edge_dst, o.col))

                def call(entry=entry, rp=rp, perm=perm, row=row, colp=colp, kname=kname):
                    out = torch.empty((n, f), device=device)
                    stream = torch.cuda.current_stream().cuda_stream
                    pp = None if perm is None else perm.data_ptr()
                    if kname == "spmm_rows":
                        rc = entry(rp.data_ptr(), pp, None, colp.data_ptr(), w.data_ptr(),
                                   x.data_ptr(), out.data_ptr(), n, f, sp.CURRENT, stream)
                    else:
                        partial = torch.empty((2 * blocks, f), device=device)
                        rc = entry(rp.data_ptr(), pp, row.data_ptr(), None, colp.data_ptr(),
                                   w.data_ptr(), x.data_ptr(), out.data_ptr(),
                                   partial.data_ptr(), sp._counters(device, n).data_ptr(),
                                   n, e, f, sp.CURRENT, stream)
                    if rc != 0:
                        raise RuntimeError(f"{kname} {name}: CUDA error {rc}")

                ms = device_ms(call)
                result["kernels"].setdefault(kname, {}).setdefault(f"{d} F={f}", {})[name] = ms
                print(f"{kname} {d} F={f} {name}: {ms:.4f} ms warm", file=sys.stderr,
                      flush=True)
    return result


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: the probe times kernels on the "
                                   "card and has no CPU path"}))
        return 1
    print(json.dumps(run(torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
