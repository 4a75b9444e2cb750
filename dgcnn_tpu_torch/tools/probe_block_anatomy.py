"""Cost split of the two block-propagation kernels on the card.

    python -m dgcnn_tpu_torch.tools.probe_block_anatomy

GPU only. Prints one JSON line on stdout (each variant's device ms, warm
and L2-flushed, per kernel and direction, with the card's name and power
limit), detail on stderr. Without CUDA it prints `{"error": ...}` and
exits 1: the probe times kernels and has no CPU path.

Each variant is csrc/block_csr.cu and csrc/block_resident.cu built again
from a copy of csrc/block_tile.cuh with one cost taken out of its item
walk (`walk_items`), the method of tools/probe_kernel_anatomy.py. A
variant computes a wrong result and otherwise runs the same instructions:

  base       the kernels as they are
  no_mac     every chunk staged, no product (the copies, the launch,
             the plan's reads, the stores and the split rows' sums)
  no_reload  only each piece's (group's) first item staged, every
             product taken over it (the products without their copies)
  neither    both taken out: the floor of launch, first copy and
             epilogue

at DD's mean batch as chip_smoke.py times it (fold 1's first epoch of
synthetic DD, batch 50, the row nearest the mean item count), F = 32, the
wrappers' piece or group size. The copies build into
dgcnn_tpu_torch/_build/anatomy/.
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

VARIANTS = ("base", "no_mac", "no_reload", "neither")
_MAC = "    mma3_mac<FP, TRANS, KC>(smem + (s % STAGES) * STAGE, acc);"
_RELOAD = ("    if (s + STAGES - 1 < steps) load(s + STAGES - 1);",
           "    if (s + STAGES - 1 < CH) load(s + STAGES - 1);")


def variant_source(name: str, src: str) -> str:
    """block_tile.cuh with the costs `name` takes out (each patch must
    find its line: a changed walk fails here, not on the card)."""
    out = src
    patches = []
    if name in ("no_mac", "neither"):
        patches.append((_MAC, _MAC.replace("mma3_mac", "if (s < 0) mma3_mac", 1)))
    if name in ("no_reload", "neither"):
        patches.append(_RELOAD)
    for old, new in patches:
        if out.count(old) != 1:
            raise ValueError(f"walk_items no longer has {old.strip()!r} once")
        out = out.replace(old, new)
    return out


def build_variants() -> dict:
    """variant → {kernel: loaded library}, all nvcc builds in parallel."""
    with open(os.path.join(_build.CSRC, "block_tile.cuh")) as f:
        tile = f.read()
    procs = []
    for name in VARIANTS:
        d = os.path.join(_build.BUILD_DIR, "anatomy", name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "block_tile.cuh"), "w") as f:
            f.write(variant_source(name, tile))
        for kname in ("block_csr", "block_resident"):
            with open(os.path.join(_build.CSRC, kname + ".cu")) as f, \
                    open(os.path.join(d, kname + ".cu"), "w") as g:
                g.write(f.read())
            lib = os.path.join(d, f"lib{kname}.so")
            procs.append((name, kname, lib, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, kname + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: dict = {}
    for name, kname, path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy of {kname}.cu:\n{log}")
        libs.setdefault(name, {})[kname] = ctypes.CDLL(path)
    return libs


def dd_mean_batch(device):
    """(pool, batch, nb, W) of chip_smoke.py's DD mean batch."""
    from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch
    from dgcnn_tpu_torch.batching.dense import order_matrix
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.train.cv import BlockSparseEngine

    gs = synthesize_tu_dataset("DD")
    cfg = Config(data_type="DD", batch_size=50)
    engine = BlockSparseEngine(cfg, gs, device)
    tr, te = get_folds(gs.y, "", 2, cfg.seed, data_type="DD")[0]
    engine.begin_fold(tr, te)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1]))
    order = order_matrix(np.asarray(tr, np.int32)[rng.permutation(len(tr))], 50,
                         engine.slots)
    nb, w = engine.budget_for(order, engine._test_np)
    counts = engine._block_counts
    items = (counts[np.maximum(order, 0)] * (order >= 0)).sum(1)
    row = int(np.argmin(np.abs(items - items.mean())))
    batch = gather_block_batch(engine.dev, torch.from_numpy(order[row]).to(device),
                               nb, w)
    return engine.dev.pool, batch, nb, w


def run(device, f: int = 32) -> dict:
    from dgcnn_tpu_torch.kernels import block_csr, block_resident
    from dgcnn_tpu_torch.utils.profiling import Flush, card_line, device_ms

    libs = build_variants()
    pool, b, nb, w = dd_mean_batch(device)
    items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
    hb = torch.randn((nb, 128, f), generator=torch.Generator(device=device).manual_seed(7),
                     device=device)
    flush = Flush(device)
    result = {"shape": f"DD mean batch: {int(b.num_items)} items, nb {nb}, W {w}, F {f}",
              "card": card_line(), "kernels": {}}
    for kname, mod in (("block_csr", block_csr), ("block_resident", block_resident)):
        plan = mod.make_plan(*items, nb)
        result["kernels"][kname] = {"size": plan.size}
        for d, tr in (("fwd", False), ("bwd", True)):
            dr = plan.bwd if tr else plan.fwd
            row = {}
            for name in VARIANTS:
                lib = libs[name][kname]
                entry = getattr(lib, kname + "_f32")
                entry.argtypes = mod._SIGNATURES[kname + "_f32"]
                entry.restype = ctypes.c_int

                def call(entry=entry, dr=dr, tr=tr):
                    out = torch.empty((nb, 128, f), device=device)
                    scratch = torch.empty((plan.parts, 128, f), device=device)
                    stream = torch.cuda.current_stream().cuda_stream
                    if kname == "block_csr":
                        rc = entry(pool.data_ptr(), hb.data_ptr(), dr.row_ptr.data_ptr(),
                                   dr.piece_ptr.data_ptr(), dr.ip.data_ptr(),
                                   dr.src.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                   block_csr._counters(device, nb).data_ptr(), nb,
                                   plan.parts, plan.size, f, int(tr), stream)
                    else:
                        rc = entry(pool.data_ptr(), hb.data_ptr(), dr.ip.data_ptr(),
                                   dr.src.data_ptr(), dr.seg.data_ptr(),
                                   dr.row_ptr.data_ptr(), b.num_items.data_ptr(),
                                   scratch.data_ptr(), out.data_ptr(), nb, plan.w,
                                   plan.size, f, int(tr), stream)
                    if rc != 0:
                        raise RuntimeError(f"{kname} {name}: CUDA error {rc}")

                row[name] = {"ms": device_ms(call), "ms_l2_flushed": device_ms(call, flush)}
                print(f"{kname} {d} {name}: {row[name]['ms']:.4f} ms warm, "
                      f"{row[name]['ms_l2_flushed']:.4f} ms flushed", file=sys.stderr,
                      flush=True)
            result["kernels"][kname][d] = row
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
