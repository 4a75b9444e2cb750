#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dgcnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero, printing no result, when
CUDA is absent or any phase fails. Phases:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build every kernel from dgcnn_tpu_torch/csrc (nvcc, sm_90a, one
     process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card:
     a. the GCN trunk, forward and backward, K ∈ {1, 10} weight sets,
        each adjacency symmetric, two backward runs bitwise equal, the
        planned regime checked by its launch counts: real dense batches
        (synthetic MUTAG T=32, NCI1 T=88, PROTEINS T=176; NCI1 at 112 and
        PROTEINS at 624), random symmetric cases at the resident cap, the
        cap + 8, T=40 (a ragged and an empty band at C=4) and T=2048; every
        forced cluster size C ∈ {1, 2, 4} at T=88 and 176 (a direction
        whose plan exceeds the shared memory, C=1's backward at 176, is
        refused by the kernel); dims
        (64,64,64,1) and (128,128,128,1) at one resident and one streamed
        T; and `trunk_plan`'s shared-memory bytes against the kernels';
     b. both block-propagation kernels (CSR and item-parallel) on real
        synthetic-DD batches of 50 graphs (the main path's mean and
        largest batch and the batch holding the largest graph), with
        budget headroom so padded items and unvisited block-rows exist,
        F ∈ {32, 1} (every width F ∈ {1, 2, 31, 32, 64, 97, 128} at the
        mean batch), forward and transposed: against the plain version,
        gradients against autograd of the plain forward, two runs
        bitwise equal, unvisited rows exactly 0; a stress batch whose one
        block-row holds 80 real items (blocks from the real pool, split
        into many pieces both ways) and a batch with num_items = 0; every
        design phase 5 times (pieces of P ∈ {2, 4, 6} and one piece per
        row, groups of G ∈ {2, 4, 8}) at the mean and
        the stress batch, forward and transposed;
     c. the three COO SpMM kernels (row-parallel CSR, edge-block,
        block-COO) on the DD COO main path's mean and largest batch and an
        NCI1 COO batch (device-assembled buckets, block-COO structures
        with 16 sentinel items past the real ones), and on the batches
        `--spmm pallas` trains on: fold 1's first epoch packed by
        `CooEngine` (worst-case bucket, structures padded to the epoch's
        largest batch), its DD mean and largest batch and its NCI1 mean
        batch; the probe's standard shape and its long-row variant
        (1,022 padding edges into one row), every edge real and weighted;
        F ∈ {32, 1, 97, 160},
        random weights on the real edges: forward and dh against the
        plain version and autograd of it (the block-COO kernel also
        against `block_coo_plain`), two runs bitwise equal, rows with no
        edge exactly 0; the earlier A-build design of the block-COO kernel
        (the probe's `abuild`) forward and transposed against the same; on
        an NCI1 batch that fills its bucket, padded edges (weight 0, into
        the real node N−1) add exactly nothing;
  4. the main paths, each with its launch counts set to 0 just before
     and read just after:
     a. the CLI trains synthetic NCI1 (dense layout, batch 50) for
        2 folds × 2 epochs, every trunk call resident; one NCI1 batch on
        the card against the CPU;
     b. the CLI trains synthetic DD with `--layout auto` (→ block, the
        kernel `block_impl` auto names) for 2 folds × 2 epochs, then
        1 fold × 1 epoch with the other `--block_impl` (CSR kernel =
        pallas, item-parallel kernel = xla); propagations exactly
        4 × (train + eval steps) forward and 4 × train steps backward,
        a quarter of each of width 1; one DD batch on the card against
        the CPU through each kernel;
     c. the CLI trains synthetic DD with `--layout coo`: `--spmm auto` for
        2 folds × 2 epochs, then the other device-assembled name and
        `--spmm pallas` (host-packed, block-pair structures) for 1 fold ×
        1 epoch each, and synthetic NCI1 `--layout coo --spmm pallas` for
        1 fold × 1 epoch; launches exactly 4 × (train + eval steps)
        forward and 4 × train steps backward on the named kernel, 0 on the
        others; one DD and one NCI1 COO batch on the card against the CPU
        through each kernel (the block-COO kernel on a `CooEngine` batch);
  5. device times (utils/profiling.py `device_ms`): each call captured
     10 times in one CUDA graph, the graph replayed and timed with CUDA
     events, so the host's launch rate is out of the number; warm
     (operands left in L2 by the previous call) and after a 64 MB
     L2-flushing write (the write's own time, measured the same way,
     subtracted). The trunk at T = 88, 112, 176, 624 and each forced
     C at 88 and 176, beside its bound (and its kind) and the plain chain.
     The block kernels at the DD mean and largest batch and the batch of
     the largest graph, F ∈ {32, 1}, each design (the CSR kernel at
     P ∈ {2, 4, 6} and one piece per row; the item-parallel one at
     G ∈ {2, 4, 8}), each kernel's
     plan build, and one train step's propagations per kernel (the
     measure `block_impl` auto is chosen by).
     Kernel, plain version, bound and the library yardstick
     (`torch.sparse_bsr_tensor` @ dense for the block kernels,
     `torch.sparse_csr_tensor` @ dense, cuSPARSE, for the SpMM kernels at
     the DD COO mean and largest batch, both the device-assembled and the
     `CooEngine` ones); the block-COO kernel, its earlier A-build design
     and its slot order's build also at every other batch of phase 3c;
  6. one `torch.profiler` table of a single train step for NCI1 dense,
     DD block through each `--block_impl`, DD COO and DD COO `--spmm
     pallas` (top 10 CUDA kernels)
     and each step's wall time and launches;
  7. the block-COO cost-split probe (dgcnn_tpu_torch/tools/
     probe_kernel_anatomy.py) at its standard shape, its long-row variant
     and DD's `CooEngine` mean batch, its launch count set to 0 after its checks and read
     after its timing; its JSON line;
  8. one JSON line describing every kernel, the card line again, and
     the final `{"ok": true, ...}` line.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from dgcnn_tpu_torch.utils.profiling import (
    FLUSH_BYTES, Flush, bound, card_line, device_ms, events_ms, rel_err, spmm_bound,
)

S = 56  # graph slots: batch 50 rounded up to graph_pad_multiple 8
DIMS = (32, 32, 32, 1)
WIDE = ((64, 64, 64, 1), (128, 128, 128, 1))  # the two wider width buckets
BS = 128


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 3a: the dense trunk --------------------------------------------


def glorot(gen, shape, device):
    a = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return ((torch.rand(shape, generator=gen) * 2 - 1) * a).to(device)


def trunk_inputs(adj, mask, k, seed, device, dims=DIMS):
    """hw1, wsel, W2..WL, b1..bL for a case (random, from a seed)."""
    gen = torch.Generator().manual_seed(seed)
    s, t = adj.shape[0], adj.shape[1]
    hw1 = (torch.randn((s, t, dims[0]), generator=gen) * 0.5).to(device)
    wsel = torch.randint(0, k, (s,), generator=gen, dtype=torch.int32).to(device)
    ws = [glorot(gen, (k, a, b), device) for a, b in zip(dims[:-1], dims[1:])]
    bs = [(torch.randn((k, d), generator=gen) * 0.1).to(device) for d in dims]
    return hw1, wsel, ws, bs


def random_symmetric_case(t, seed, device):
    """S slots of random graphs with n ≤ t nodes, ~8 neighbours each:
    normalized D̂^-½(A+I)D̂^-½, exactly symmetric."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = torch.randint(t // 2, t + 1, (S,), generator=gen, device=device)
    node = torch.arange(t, device=device)
    mask = (node[None, :] < n[:, None]).float()
    a = (torch.rand((S, t, t), generator=gen, device=device) < 8.0 / t).float()
    a = torch.triu(a, 1)
    a = (a + a.mT) * mask[:, :, None] * mask[:, None, :]
    a = a + torch.diag_embed(mask)
    dinv = torch.where(mask > 0, a.sum(-1).clamp(min=1).rsqrt(), 0.0)
    adj = a * dinv[:, :, None] * dinv[:, None, :]
    del a
    return (adj + adj.mT) * 0.5, mask


def compare_trunk(name, adj, mask, device, dt, stats, dims=DIMS, plan=None):
    """The kernel against the plain version at K ∈ {1, 10}: forward, and
    every gradient against autograd of the plain chain, two backward runs
    bitwise equal. `plan` forces a regime / cluster size (the kernels are
    then called directly and their flat gradients summed as `GcnTrunkFn`
    does); else `gcn_trunk` runs the plan it picks. Checks that the
    planned regime ran."""
    sym = (adj - adj.mT).abs().max().item()
    if sym > 1e-7:
        raise AssertionError(f"{name}: adjacency not symmetric ({sym:.3g})")
    s, t = adj.shape[0], adj.shape[1]
    want_plan = plan or dt.trunk_plan(s, t, dims)
    n = len(dims)
    for k in (1, 10):
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, k, seed=17 + k, device=device,
                                         dims=dims)
        before = dict(vars(dt.launches))
        with torch.no_grad():
            if plan is None:
                cat_k = dt.gcn_trunk(dims, adj, hw1, mask, wsel, ws, bs)
            else:
                cat_k = dt._cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k, plan)
            cat_p = dt.gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs)
        err, rel, ok = rel_err(cat_k, cat_p)
        stats["gcn_trunk_fwd"] = max(stats["gcn_trunk_fwd"], err)
        log(f"  {name} K={k} forward: max abs {err:.3e} rel {rel:.3e} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"{name} K={k}: forward disagrees")

        g = torch.randn(cat_p.shape, generator=torch.Generator(device=device)
                        .manual_seed(k), device=device)
        leaves = [hw1, *ws, *bs]

        def grads(fn):
            xs = [x.detach().clone().requires_grad_() for x in leaves]
            cat = fn(dims, adj, xs[0], mask, wsel, xs[1:n], xs[n:])
            return torch.autograd.grad(cat, xs, g)

        def kernel_grads():
            if plan is None:
                return grads(dt.gcn_trunk)
            d_hw1, flat = dt._cuda_bwd(dims, adj, mask, wsel, ws, cat_k, g, k, plan)
            dws, dbs = dt._split_grads(dt._segment_sum(flat, wsel, k), dims)
            return [d_hw1, *dws, *dbs]

        want = grads(dt.gcn_trunk_plain)  # autograd of the plain chain
        got = kernel_grads()
        again = kernel_grads()
        ran = {key: v - before[key] for key, v in vars(dt.launches).items()}
        regime = want_plan.regime
        if ran[f"{regime}_fwd"] < 1 or ran[f"{regime}_bwd"] != 2 or (
                ran["resident_fwd"] + ran["streamed_fwd"] != ran["fwd_launches"]):
            raise AssertionError(f"{name} K={k}: expected the {regime} kernels, "
                                 f"counts moved {ran}")
        names = ["d_hw1"] + [f"dW{i + 2}" for i in range(n - 1)] + [
            f"db{i + 1}" for i in range(n)]
        worst = (0.0, 0.0, "")
        for nm, a, b, c in zip(names, got, want, again):
            err, rel, ok = rel_err(a, b)
            if not ok:
                raise AssertionError(f"{name} K={k} {nm}: backward disagrees "
                                     f"(max abs {err:.3e}, rel {rel:.3e})")
            if not torch.equal(a, c):
                raise AssertionError(f"{name} K={k} {nm}: two backward runs differ")
            stats["gcn_trunk_bwd"] = max(stats["gcn_trunk_bwd"], err)
            if rel >= worst[1]:
                worst = (err, rel, nm)
        log(f"  {name} K={k} backward: worst {worst[2]} max abs {worst[0]:.3e} "
            f"rel {worst[1]:.3e} (ok; two runs bitwise equal; {regime}"
            f"{f', C={want_plan.c}' if regime == 'resident' else ''})")


def check_refusal(name, adj, mask, device, dt, stats, plan):
    """A forced resident plan that one direction cannot fit: the direction
    that fits agrees with the plain version, the other is refused by the
    kernel (cudaErrorInvalidValue), never run."""
    hw1, wsel, ws, bs = trunk_inputs(adj, mask, 1, seed=18, device=device)
    with torch.no_grad():
        cat_p = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
    calls = {
        "forward": (plan.fwd_smem,
                    lambda: dt._cuda_fwd(DIMS, adj, hw1, mask, wsel, ws, bs, 1, plan)),
        "backward": (plan.bwd_smem,
                     lambda: dt._cuda_bwd(DIMS, adj, mask, wsel, ws, cat_p,
                                          torch.ones_like(cat_p), 1, plan)),
    }
    for what, (smem, call) in calls.items():
        if smem <= dt.SMEM_MAX:
            err, rel, ok = rel_err(call(), cat_p)
            if what == "backward" or not ok:
                raise AssertionError(f"{name} {what}: expected a refusal or agreement")
            stats["gcn_trunk_fwd"] = max(stats["gcn_trunk_fwd"], err)
            log(f"  {name} K=1 {what}: {smem} B fits, max abs {err:.3e} rel {rel:.3e} (ok)")
            continue
        try:
            call()
        except RuntimeError as e:
            if "invalid argument" not in str(e):
                raise
            log(f"  {name} {what}: {smem} B > {dt.SMEM_MAX}, refused by the kernel "
                f"({e})")
        else:
            raise AssertionError(f"{name} {what}: a plan over the shared memory ran")


def resident_cap(dims=DIMS):
    """The largest multiple of 8 that the plan keeps resident at S slots."""
    from dgcnn_tpu_torch.kernels import dense_trunk as dt

    t = 8
    while dt.trunk_plan(S, t + 8, dims).regime == "resident":
        t += 8
    return t


def check_trunk(datasets, device, dt, stats):
    """Phase 3a: every trunk case; returns the packed tiles by T."""
    from dgcnn_tpu_torch.batching.dense import dense_tile

    t_main = dense_tile(datasets["NCI1"])
    t_prot = dense_tile(datasets["PROTEINS"])
    cases = [
        ("MUTAG T=32", datasets["MUTAG"], 32),
        (f"NCI1 T={t_main} (main path)", datasets["NCI1"], t_main),
        ("NCI1 T=112", datasets["NCI1"], 112),
        (f"PROTEINS T={t_prot}", datasets["PROTEINS"], t_prot),
        ("PROTEINS T=624", datasets["PROTEINS"], 624),
    ]
    shapes = {}
    for name, gs, n_tile in cases:
        adj, mask = dense_case(gs, n_tile, device)
        shapes[n_tile] = (adj, mask)
    for smem_t in sorted(shapes):  # the plan's bytes are the kernels' bytes
        for dims in (DIMS, WIDE[0], WIDE[1]):
            for plan in [dt.trunk_plan(S, smem_t, dims, c=c) for c in dt.CLUSTERS] + [
                    dt.trunk_plan(S, smem_t, dims, regime="streamed")]:
                if dt.kernel_smem(plan, smem_t, dims) != (plan.fwd_smem, plan.bwd_smem):
                    raise AssertionError(f"plan {plan} at T={smem_t} {dims}: the "
                                         f"kernels count {dt.kernel_smem(plan, smem_t, dims)}")
    log(f"  trunk_plan's shared-memory bytes equal the kernels' at T {sorted(shapes)}")
    for name, _, n_tile in cases:
        log(f"  {name}: plan {dt.trunk_plan(S, n_tile, DIMS)}")
        compare_trunk(name, *shapes[n_tile], device, dt, stats)
    cap = resident_cap()
    for t in (cap, cap + 8):
        adj, mask = random_symmetric_case(t, seed=t, device=device)
        log(f"  random T={t}: plan {dt.trunk_plan(S, t, DIMS)}")
        compare_trunk(f"random T={t} ({'resident cap' if t == cap else 'cap + 8'})",
                      adj, mask, device, dt, stats)
    for t in (t_main, t_prot):
        for c in dt.CLUSTERS:
            plan = dt.trunk_plan(S, t, DIMS, c=c)
            if max(plan.fwd_smem, plan.bwd_smem) <= dt.SMEM_MAX:
                compare_trunk(f"T={t} forced C={c}", *shapes[t], device, dt, stats,
                              plan=plan)
            else:
                check_refusal(f"T={t} forced C={c}", *shapes[t], device, dt, stats, plan)
    adj, mask = random_symmetric_case(40, seed=40, device=device)
    compare_trunk("random T=40 forced C=4 (ragged last band)", adj, mask, device,
                  dt, stats, plan=dt.trunk_plan(S, 40, DIMS, c=4))
    for dims, t_res, t_str in ((WIDE[0], t_main, 624), (WIDE[1], 32, t_main)):
        for t in (t_res, t_str):
            plan = dt.trunk_plan(S, t, dims)
            want = "resident" if t == t_res else "streamed"
            if plan.regime != want:
                raise AssertionError(f"dims {dims} T={t}: plan {plan}, expected {want}")
            compare_trunk(f"dims {dims} T={t} ({want})", *shapes[t], device, dt,
                          stats, dims=dims)
    adj, mask = random_symmetric_case(2048, seed=5, device=device)
    compare_trunk("random T=2048", adj, mask, device, dt, stats)
    del adj, mask
    return shapes


def dense_case(gs, n_tile, device):
    from dgcnn_tpu_torch.batching.dense import pack_dense_batch

    b = pack_dense_batch(gs, np.arange(50), n_tile, S)
    return torch.from_numpy(b.adj).to(device), torch.from_numpy(b.node_mask).to(device)


def trunk_bounds(s, t, k):
    """(fwd, bwd) least times in ms. Each input read once, each output
    written once."""
    sd = sum(DIMS)
    pairs = sum(a * b for a, b in zip(DIMS[:-1], DIMS[1:]))
    wbytes = 4 * k * (pairs + sd) + 4 * s
    p = pairs + sd  # per-slot gradient values the backward writes
    fwd_bytes = 4 * (s * t * t + s * t * DIMS[0] + s * t + s * t * sd) + wbytes
    fwd_flops = 2 * s * t * t * sd + 2 * s * t * pairs
    bwd_bytes = 4 * (s * t * t + s * t + 2 * s * t * sd + s * t * DIMS[0]
                     + s * p) + wbytes
    bwd_flops = 2 * s * t * t * sd + 4 * s * t * pairs
    return bound(fwd_bytes, fwd_flops), bound(bwd_bytes, bwd_flops)


# -- phase 3b: the block kernels ------------------------------------------


class DDContext:
    """Synthetic DD in the block layout on the card, and the batches of
    the main path's first fold-epoch (CLI defaults: seed 324, batch 50)."""

    def __init__(self, device):
        from dgcnn_tpu_torch.config import Config
        from dgcnn_tpu_torch.data.folds import get_folds
        from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
        from dgcnn_tpu_torch.train.cv import BlockSparseEngine, choose_layout

        self.gs = synthesize_tu_dataset("DD")
        cfg = Config(data_type="DD", batch_size=50)
        self.layout = choose_layout(cfg, self.gs)
        t0 = time.perf_counter()
        self.engine = BlockSparseEngine(cfg, self.gs, device)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        tr, te = get_folds(self.gs.y, "", 2, cfg.seed, data_type="DD")[0]
        self.engine.begin_fold(tr, te)
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1]))
        from dgcnn_tpu_torch.batching.dense import order_matrix

        self.order = order_matrix(
            np.asarray(tr, np.int32)[rng.permutation(len(tr))], 50, self.engine.slots
        )
        self.test = self.engine._test_np
        self.nb, self.w = self.engine.budget_for(self.order, self.test)
        self.pool = self.engine.dev.pool
        counts = self.engine._block_counts
        nbs = self.engine._nb
        rows = np.concatenate([self.order, self.test])
        items = (counts[np.maximum(rows, 0)] * (rows >= 0)).sum(1)
        self.row_items = items
        self.row_nb = (nbs[np.maximum(rows, 0)] * (rows >= 0)).sum(1)
        self.rows = rows
        train_items = items[: len(self.order)]
        self.mean_row = int(np.argmin(np.abs(train_items - train_items.mean())))
        self.max_row = int(np.argmax(train_items))
        gmax = int(np.argmax(counts[:-1]))
        self.big_graph = (gmax, int(counts[gmax]), int(nbs[gmax]))
        self.big_row = int(np.nonzero((rows == gmax).any(1))[0][0])
        log(f"synthetic DD: {self.gs.num_graphs} graphs, layout auto → "
            f"{self.layout}; pool {tuple(self.pool.shape)} "
            f"({self.pool.numel() * 4 / 1e6:.0f} MB), x_blocks "
            f"{tuple(self.engine.dev.x_blocks.shape)}; build + H2D "
            f"{self.build_s:.1f} s")
        log(f"fold 1 epoch 1: {len(self.order)} train + {len(self.test)} test "
            f"batches; items per batch mean {train_items.mean():.1f} max "
            f"{items.max()}, block-rows mean {self.row_nb.mean():.1f} max "
            f"{self.row_nb.max()}; budgets nb {self.nb} W {self.w}; largest "
            f"graph {gmax}: {self.big_graph[1]} blocks, {self.big_graph[2]} "
            f"block-rows")

    def batch(self, r, nb=None, w=None):
        from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch

        row = torch.from_numpy(self.rows[r]).to(self.pool.device)
        return gather_block_batch(self.engine.dev, row, nb or self.nb, w or self.w)


BLOCK_KERNELS = ("block_csr", "block_resident")
BLOCK_WIDTHS = (1, 2, 31, 32, 64, 97, 128)  # every width bucket of the tile, both edges


def block_kernels():
    """name → (module: launch counts, `make_plan` and `_cuda_prop`,
    autograd entry)."""
    from dgcnn_tpu_torch.kernels import block_csr, block_resident

    return {"block_csr": (block_csr, block_csr.block_propagate_csr),
            "block_resident": (block_resident,
                               block_resident.block_propagate_resident)}


def block_variants(kname):
    """(label, plan size) of each design of a block kernel that phase 5
    times; the first is the one the wrapper runs. A size of None is one
    piece per row: no split, each row's whole run in one block."""
    mod = block_kernels()[kname][0]
    if kname == "block_csr":
        sizes = [mod.PIECE] + [p for p in (2, 4, 6) if p != mod.PIECE]
        return [(f"P={p}", p) for p in sizes] + [("one piece per row", None)]
    sizes = [mod.GROUP] + [g for g in (2, 4, 8) if g != mod.GROUP]
    return [(f"G={g}", g) for g in sizes]


def variant_plan(mod, b, nb, size):
    items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
    return mod.make_plan(*items, nb, size or max(b.item_pool.shape[0], 1))


def made_batch(pool, rows, cols, nb, w, seed, device):
    """A batch of len(rows) real items at (row, col), rows non-decreasing,
    blocks drawn from the real pool, padded to w items as
    `gather_block_batch` pads (sentinel block, row nb, col 0; the
    col-major traversal by col then row, identity on padding)."""
    from types import SimpleNamespace

    n = len(rows)
    rng = np.random.default_rng(seed)
    sentinel = pool.shape[0] - 1
    ip = np.full(w, sentinel, np.int32)
    ip[:n] = rng.integers(0, sentinel, n)
    row = np.full(w, nb, np.int32)
    row[:n] = rows
    col = np.zeros(w, np.int32)
    col[:n] = cols
    perm = np.arange(w, dtype=np.int32)
    perm[:n] = np.lexsort((row[:n], col[:n]))
    colT = np.full(w, nb, np.int32)
    colT[:n] = col[perm[:n]]
    t = {k: torch.from_numpy(v).to(device) for k, v in (
        ("item_pool", ip), ("item_row", row), ("item_col", col),
        ("item_permT", perm), ("item_colT", colT))}
    return SimpleNamespace(**t, num_items=torch.tensor(n, dtype=torch.int32, device=device))


def compare_block(name, b, nb, pool, device, stats, widths=(32, 1), variants=False,
                  need_padding=True):
    """Both kernels vs the plain version on batch b at each width: forward
    and gradient (autograd of the plain forward) through the autograd
    entries, two runs bitwise equal, unvisited rows exactly 0; with
    `variants`, every design phase 5 times, forward and transposed."""
    from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain, row_ptr

    items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
    w = b.item_pool.shape[0]
    n_items = int(b.num_items)
    rp = row_ptr(b.item_row, nb)
    dead = (rp[1:] == rp[:-1])
    rpT = row_ptr(b.item_colT, nb)
    deadT = (rpT[1:] == rpT[:-1])
    if need_padding and (not bool(dead.any()) or n_items >= w):
        raise AssertionError(f"{name}: the case must leave unvisited rows and padded items")
    gen = torch.Generator(device=device).manual_seed(nb + n_items)
    for f in widths:
        hb = torch.randn((nb, BS, f), generator=gen, device=device)
        g = torch.randn((nb, BS, f), generator=gen, device=device)
        with torch.no_grad():
            want = block_propagate_plain(hb, pool, b.item_pool, b.item_row, b.item_col)
        hr = hb.clone().requires_grad_()
        want_g, = torch.autograd.grad(
            block_propagate_plain(hr, pool, b.item_pool, b.item_row, b.item_col), hr, g)
        for kname, (mod, fn) in block_kernels().items():
            outs, grads = [], []
            for _ in range(2):
                x = hb.clone().requires_grad_()
                out = fn(x, pool, *items, b.num_items)
                out.backward(g)
                outs.append(out.detach())
                grads.append(x.grad)
            err, rel, ok = rel_err(outs[0], want)
            gerr, grel, gok = rel_err(grads[0], want_g)
            if not ok or not gok:
                raise AssertionError(
                    f"{name} F={f} {kname}: disagrees with the plain version "
                    f"(fwd abs {err:.3e} rel {rel:.3e}; bwd abs {gerr:.3e} rel {grel:.3e})")
            if not (torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])):
                raise AssertionError(f"{name} F={f} {kname}: two runs differ")
            if bool((outs[0][dead] != 0).any()) or bool((grads[0][deadT] != 0).any()):
                raise AssertionError(f"{name} F={f} {kname}: an unvisited row is not 0")
            stats[f"{kname}_fwd"] = max(stats[f"{kname}_fwd"], err)
            stats[f"{kname}_bwd"] = max(stats[f"{kname}_bwd"], gerr)
            log(f"  {name} F={f} {kname}: fwd max abs {err:.3e} rel {rel:.3e}; "
                f"grad vs autograd of plain max abs {gerr:.3e} rel {grel:.3e}; "
                f"two runs bitwise equal; {int(dead.sum())} unvisited rows fwd, "
                f"{int(deadT.sum())} bwd, exactly 0")
            if not variants:
                continue
            for label, size in block_variants(kname)[1:]:
                plan = variant_plan(mod, b, nb, size)
                got = mod._cuda_prop(hb, pool, plan, plan.fwd, b.num_items, False)
                got_t = mod._cuda_prop(g, pool, plan, plan.bwd, b.num_items, True)
                err, rel, ok = rel_err(got, want)
                gerr, grel, gok = rel_err(got_t, want_g)
                if (not ok or not gok or bool((got[dead] != 0).any())
                        or bool((got_t[deadT] != 0).any())):
                    raise AssertionError(
                        f"{name} F={f} {kname} {label}: disagrees with the plain version "
                        f"or leaves an unvisited row non-zero (fwd abs {err:.3e}, "
                        f"transposed abs {gerr:.3e})")
                log(f"    {kname} {label}: fwd max abs {err:.3e}, transposed {gerr:.3e}")
    return n_items


def check_blocks(ctx, device, stats):
    """Phase 3b: every case of both block kernels."""
    checked = {"mean": ctx.mean_row, "max": ctx.max_row, "largest graph": ctx.big_row}
    nb, w = ctx.nb + 8, ctx.w + 64  # padded items and unvisited rows exist
    for label, r in checked.items():
        compare_block(f"DD {label} batch (row {r}, {ctx.row_items[r]} items)",
                      ctx.batch(r, nb, w), nb, ctx.pool, device, stats,
                      widths=BLOCK_WIDTHS if label == "mean" else (32, 1),
                      variants=label == "mean")
    run = 80  # one row of 80 real items, 20 pieces at P = 4, 13-14 per column
    stress = made_batch(ctx.pool, [0] * run, [i % 6 for i in range(run)], 6, 96,
                        seed=5, device=device)
    compare_block(f"stress batch (one block-row of {run} real items over 6 columns)",
                  stress, 6, ctx.pool, device, stats, widths=(32, 1, 64, 128),
                  variants=True)
    empty = made_batch(ctx.pool, [], [], 6, 16, seed=6, device=device)
    compare_block("batch with num_items = 0", empty, 6, ctx.pool, device, stats,
                  widths=(32, 1), need_padding=False)


def block_bounds(n_items, nb, f):
    """(least ms, by) of one propagation: each real item's block and
    source rows read once, the [nb, bs, F] output written once."""
    nbytes = n_items * (BS * BS * 4 + BS * f * 4) + nb * BS * f * 4
    return bound(nbytes, 2.0 * n_items * BS * BS * f)


def library_bsr(b, nb, pool, f, hb, transpose):
    """The yardstick: the batch's adjacency as one `sparse_bsr_tensor`
    (crow = row pointers, col = source rows, values = the blocks) times
    hb reshaped [nb·bs, F]. Built outside the timed call."""
    from dgcnn_tpu_torch.kernels.block_prop import row_ptr, transposed_items

    n = int(b.num_items)
    if transpose:
        ipT, rT = transposed_items(b.item_pool, b.item_row, b.item_permT, nb)
        seg, src, vals = b.item_colT, rT, pool[ipT[:n].long()].mT
    else:
        seg, src, vals = b.item_row, b.item_col, pool[b.item_pool[:n].long()]
    a = torch.sparse_bsr_tensor(
        row_ptr(seg, nb).long(), src[:n].long(), vals.contiguous(),
        size=(nb * BS, nb * BS),
    )
    x = hb.reshape(nb * BS, f)
    return lambda: a @ x


def time_block(ctx, r, flush, device):
    """Per kernel, design and F: warm and flushed device ms of the kernel
    (its plan built outside the timed call), warm ms of the plain version
    and of the library call, and the bound; each kernel's plan build."""
    from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain

    b = ctx.batch(r)
    nb = ctx.nb
    n_items = int(b.num_items)
    items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
    gen = torch.Generator(device=device).manual_seed(7)
    rows = {}
    for kname, (mod, _) in block_kernels().items():
        rows[(kname, "plan")] = device_ms(lambda mod=mod: mod.make_plan(*items, nb))
        log(f"  {kname} plan build (once per batch): {rows[(kname, 'plan')]:.4f} ms")
    tplan = block_kernels()["block_csr"][0].make_plan(*items, nb).bwd
    for f in (32, 1):
        hb = torch.randn((nb, BS, f), generator=gen, device=device)
        bnd = block_bounds(n_items, nb, f)

        def plain_fwd():
            return block_propagate_plain(hb, ctx.pool, b.item_pool, b.item_row, b.item_col)

        def plain_bwd():
            return block_propagate_plain(hb, ctx.pool, tplan.ip, tplan.seg, tplan.src,
                                         transpose=True)

        plain = {"fwd": device_ms(plain_fwd), "bwd": device_ms(plain_bwd)}
        lib = {}
        for d, tr in (("fwd", False), ("bwd", True)):
            try:
                call = library_bsr(b, nb, ctx.pool, f, hb, tr)
                want = plain_bwd() if tr else plain_fwd()
                err, _, ok = rel_err(call().reshape(nb, BS, f), want)
                if not ok:
                    raise AssertionError(f"BSR product disagrees ({err:.3e})")
                lib[d] = events_ms(call)
            except (RuntimeError, AssertionError, NotImplementedError) as e:
                log(f"  library BSR {d} F={f}: {type(e).__name__}: {str(e)[:200]} → null")
                lib[d] = None
        for kname, (mod, _) in block_kernels().items():
            for label, size in block_variants(kname):
                plan = variant_plan(mod, b, nb, size)
                for d, tr in (("fwd", False), ("bwd", True)):
                    dr = plan.bwd if tr else plan.fwd
                    fn = (lambda mod=mod, plan=plan, dr=dr, tr=tr:
                          mod._cuda_prop(hb, ctx.pool, plan, dr, b.num_items, tr))
                    row = {
                        "ms": device_ms(fn), "ms_l2_flushed": device_ms(fn, flush),
                        "plain_ms": plain[d], "library_ms": lib[d],
                        "bound_ms": bnd[0], "bound_by": bnd[1],
                        "n_items": n_items, "nb": nb, "f": f, "design": label,
                    }
                    rows[(kname, label, d, f)] = row
                    log(f"  {kname} [{label}] {d} F={f} items {n_items} nb {nb}: "
                        f"kernel warm {row['ms']:.4f} ms, L2-flushed "
                        f"{row['ms_l2_flushed']:.4f} ms ({row['ms'] / bnd[0]:.2f}x the "
                        f"bound); plain {row['plain_ms']:.4f} ms; library "
                        f"{'null' if lib[d] is None else f'{lib[d]:.4f} ms'}; bound "
                        f"{bnd[0]:.4f} ms ({bnd[1]})")
    return rows


def block_row(rows, kname, d, f):
    """The timing row of the design the wrapper runs."""
    return rows[(kname, block_variants(kname)[0][0], d, f)]


def block_step_ms(rows, kname, label=None):
    """One train step's propagations on one design: 3 x F=32 + F=1, forward
    and backward (the measure `block_impl` auto is chosen by)."""
    label = label or block_variants(kname)[0][0]
    return sum(rows[(kname, label, d, f)]["ms"] * (3 if f == 32 else 1)
               for d in ("fwd", "bwd") for f in (32, 1))


# -- phase 3c: the SpMM kernels -------------------------------------------


SPMM_KERNELS = ("spmm_rows", "spmm_edge_block", "spmm_block_coo")
SPMM_KERNEL_OF = {"xla": "spmm_rows", "onehot": "spmm_edge_block",
                  "pallas": "spmm_block_coo"}


def spmm_counters():
    """name → the kernel's launch counts."""
    from dgcnn_tpu_torch.kernels import spmm_block_coo as sbc
    from dgcnn_tpu_torch.kernels import spmm_pallas as sp

    return {"spmm_rows": sp.rows_launches, "spmm_edge_block": sp.edge_block_launches,
            "spmm_block_coo": sbc.launches}


class CooContext:
    """Synthetic `name` in the COO layout on the card (DeviceCooEngine),
    and the batches of the main path's first fold-epoch (CLI defaults:
    seed 324, batch 50, 2 folds)."""

    def __init__(self, name, device, gs=None):
        from dgcnn_tpu_torch.batching.dense import order_matrix
        from dgcnn_tpu_torch.config import Config
        from dgcnn_tpu_torch.data.folds import get_folds
        from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
        from dgcnn_tpu_torch.train.cv import DeviceCooEngine

        self.name, self.device = name, device
        self.gs = gs if gs is not None else synthesize_tu_dataset(name)
        cfg = Config(data_type=name, batch_size=50, layout="coo")
        t0 = time.perf_counter()
        self.engine = DeviceCooEngine(cfg, self.gs, device)
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        tr, te = get_folds(self.gs.y, "", 2, cfg.seed, data_type=name)[0]
        self.engine.begin_fold(tr, te)
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 1]))
        self.order = order_matrix(np.asarray(tr, np.int32)[rng.permutation(len(tr))],
                                  50, self.engine.slots)
        self.test = self.engine._test_np
        self.bucket = self.engine.bucket_for(self.order, self.test)
        self.rows = np.concatenate([self.order, self.test])
        valid = self.rows >= 0
        safe = np.maximum(self.rows, 0)
        self.row_nodes = (self.engine._node_counts[safe] * valid).sum(1)
        self.row_edges = (self.engine._edge_counts[safe] * valid).sum(1)
        train_e = self.row_edges[: len(self.order)]
        self.mean_row = int(np.argmin(np.abs(train_e - train_e.mean())))
        self.max_row = int(np.argmax(self.row_edges))
        log(f"synthetic {name} COO: {self.gs.num_graphs} graphs; graphset on the "
            f"card in {self.build_s:.1f} s; fold 1 epoch 1: {len(self.order)} train + "
            f"{len(self.test)} test batches, nodes per batch mean "
            f"{self.row_nodes[:len(self.order)].mean():.0f} max {self.row_nodes.max()}, "
            f"edges mean {train_e.mean():.0f} max {self.row_edges.max()}; bucket "
            f"{self.bucket.num_nodes} nodes, {self.bucket.num_edges} edges")

    def host_batch(self, r):
        from dgcnn_tpu_torch.batching.packer import pack_batch

        ids = self.rows[r]
        return pack_batch(self.gs, ids[ids >= 0], self.bucket)

    def batch(self, r):
        from dgcnn_tpu_torch.batching.device_coo import gather_coo_batch

        row = torch.from_numpy(self.rows[r]).to(self.device)
        return gather_coo_batch(self.engine.dev, row, self.bucket)


class HostCooContext:
    """Synthetic `name` as `--spmm pallas` trains on it: `CooEngine` packs
    the main path's first fold-epoch (the same graphs in the same order as
    `CooContext`) into the worst-case bucket with block-pair structures
    attached, exactly as it ships them; kept on the host, one batch at a
    time to the card."""

    def __init__(self, name, gs, device):
        from dgcnn_tpu_torch.tools.probe_kernel_anatomy import coo_engine_epoch, mean_row

        self.name, self.device = name, device
        engine, self.stack, pack_s = coo_engine_epoch(name, gs, device)
        edges = self.stack.edge_mask.sum(1)
        self.mean_row = mean_row(self.stack)
        self.max_row = int(np.argmax(edges))
        s = self.stack.blockcoo[0]
        items = s.row_ptr[:, -1]
        log(f"synthetic {name} CooEngine (--spmm pallas): bucket "
            f"{engine.bucket.num_nodes} nodes, {engine.bucket.num_edges} edges; fold 1 "
            f"epoch 1 packed with structures in {pack_s:.1f} s: {edges.shape[0]} "
            f"batches, real edges mean {edges.mean():.0f} max {edges.max():.0f}; "
            f"block-COO items per batch mean {items.mean():.0f} max {items.max()}, "
            f"item axes padded to {s.ls.shape[1]}")

    def host(self, r):
        from dgcnn_tpu_torch.batching.packer import batch_step

        return batch_step(self.stack, r)

    def batch(self, r, device=None):
        from dgcnn_tpu_torch.batching.packer import batch_to_device

        return batch_to_device(self.host(r), device or self.device)

    def case(self, r):
        return SpmmCase(self.batch(r), seed=r, device=self.device,
                        structure=self.host(r).blockcoo[0])


class SpmmCase:
    """One COO batch on the card as the SpMM kernels take it: random
    weights on the real edges (0 on padding), the batch's `EdgeOrder`
    (padding left out) and a block-pair structure: `structure` when given
    (the one `add_blockcoo` attached on the main path), else one built on
    the host from the real edges with `item_headroom` sentinel items past
    the real ones."""

    def __init__(self, b, seed, device, item_headroom=16, structure=None):
        from dgcnn_tpu_torch.kernels.spmm_block_coo import (
            block_coo_order, build_block_coo, pad_structure, pad_weights,
            pad_weights_t)
        from dgcnn_tpu_torch.ops.spmm import edge_order

        self.n = b.x.shape[0]
        self.src, self.dst = b.edge_src, b.edge_dst
        gen = torch.Generator(device=device).manual_seed(seed)
        self.w = (torch.rand(b.edge_mask.shape, generator=gen, device=device)
                  + 0.5) * b.edge_mask
        self.order = edge_order(self.src, self.dst, self.n, edge_mask=b.edge_mask,
                                dst_sorted=True)
        self.e_real = int(self.order.row_ptr[-1])
        real = b.edge_mask.cpu().numpy() > 0
        w_r = self.w.cpu().numpy()[real]
        src_r, dst_r = self.src.cpu().numpy()[real], self.dst.cpu().numpy()[real]
        # rows of the input each direction reads: h at the sources, g at
        # the destinations
        self.rows_read = (len(np.unique(src_r)), len(np.unique(dst_r)))
        if structure is None:
            s = build_block_coo(src_r, dst_r, self.n)
            s = pad_structure(s, max(s.ls.shape[0], s.lsT.shape[0]) + item_headroom)
        else:
            s = structure
        self.items = (int(s.row_ptr[-1]), int(s.row_ptrT[-1]))
        self.slots = s.ls.shape[0]
        self.structure = s.map(lambda a: torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device))
        self.w_pad = torch.from_numpy(pad_weights(s, w_r)).to(device)
        self.w_padT = torch.from_numpy(pad_weights_t(s, w_r)).to(device)
        self.bc_order = block_coo_order(self.structure, self.n)
        rp = self.bc_order.row_ptr
        self.longest_row = int((rp[1:] - rp[:-1]).max())

    def fns(self, order=None):
        """name → autograd entry h ↦ out (the block-COO wrapper builds its
        slot order itself)."""
        from dgcnn_tpu_torch.kernels.spmm_block_coo import spmm_block_coo
        from dgcnn_tpu_torch.kernels.spmm_pallas import spmm_pallas, spmm_pallas_mxu

        o = self.order if order is None else order
        return {
            "spmm_rows": lambda h: spmm_pallas(self.src, self.dst, self.w, h, o),
            "spmm_edge_block": lambda h: spmm_pallas_mxu(self.src, self.dst, self.w, h, o),
            "spmm_block_coo": lambda h: spmm_block_coo(self.structure, self.w_pad,
                                                      self.w_padT, h),
        }

    def block_plain(self, x, transpose: bool):
        """`block_coo_plain` over one orientation of the structure."""
        from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_plain

        s = self.structure
        if transpose:
            return block_coo_plain(s.row_ptrT, s.item_cT, s.lsT, s.ldT, self.w_padT, x)
        return block_coo_plain(s.row_ptr, s.item_c, s.ls, s.ld, self.w_pad, x)

    def abuild(self, x, transpose: bool):
        """The earlier A-build design (the probe's `abuild` variant) over
        one orientation."""
        from dgcnn_tpu_torch.tools.probe_kernel_anatomy import abuild

        s = self.structure
        if transpose:
            return abuild(s.row_ptrT, s.item_cT, s.lsT, s.ldT, self.w_padT, x)
        return abuild(s.row_ptr, s.item_c, s.ls, s.ld, self.w_pad, x)

    def plain(self, h):
        from dgcnn_tpu_torch.ops.spmm import spmm_plain

        return spmm_plain(self.src, self.dst, self.w, h, self.n)


def _run_twice(fn, h, g):
    outs, grads = [], []
    for _ in range(2):
        x = h.clone().requires_grad_()
        out = fn(x)
        out.backward(g)
        outs.append(out.detach())
        grads.append(x.grad)
    return outs, grads


SPMM_WIDTHS = (32, 1, 97, 160)


def compare_spmm(name, case, device, stats):
    """Every SpMM kernel vs the plain version on one batch, F ∈ SPMM_WIDTHS:
    forward; dh against autograd of the plain forward; two runs bitwise
    equal; rows with no edge (padding nodes included) exactly 0 both ways.
    The block-COO kernel, and the earlier A-build design (the probe's
    `abuild`, forward and transposed), also against `block_coo_plain`."""
    o = case.order
    empty = o.row_ptr[1:] == o.row_ptr[:-1]
    emptyT = o.row_ptrT[1:] == o.row_ptrT[:-1]
    gen = torch.Generator(device=device).manual_seed(case.n)
    for f in SPMM_WIDTHS:
        h = torch.randn((case.n, f), generator=gen, device=device)
        g = torch.randn((case.n, f), generator=gen, device=device)
        with torch.no_grad():
            want = case.plain(h)
            want_bc = (case.block_plain(h, False), case.block_plain(g, True))
        hr = h.clone().requires_grad_()
        want_g, = torch.autograd.grad(case.plain(hr), hr, g)
        for kname, fn in case.fns().items():
            outs, grads = _run_twice(fn, h, g)
            err, rel, ok = rel_err(outs[0], want)
            gerr, grel, gok = rel_err(grads[0], want_g)
            if kname == "spmm_block_coo":
                ok = ok and rel_err(outs[0], want_bc[0])[2]
                gok = gok and rel_err(grads[0], want_bc[1])[2]
            if not ok or not gok:
                raise AssertionError(
                    f"{name} F={f} {kname}: disagrees with the plain version "
                    f"(fwd abs {err:.3e} rel {rel:.3e}; bwd abs {gerr:.3e} rel {grel:.3e})")
            if not (torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])):
                raise AssertionError(f"{name} F={f} {kname}: two runs differ")
            if bool((outs[0][empty] != 0).any()) or bool((grads[0][emptyT] != 0).any()):
                raise AssertionError(f"{name} F={f} {kname}: a row with no edge is not 0")
            stats[f"{kname}_fwd"] = max(stats[f"{kname}_fwd"], err)
            stats[f"{kname}_bwd"] = max(stats[f"{kname}_bwd"], gerr)
            log(f"  {name} F={f} {kname}: fwd max abs {err:.3e} rel {rel:.3e}; dh vs "
                f"autograd of plain max abs {gerr:.3e} rel {grel:.3e}; two runs bitwise "
                f"equal; {int(empty.sum())} empty rows fwd, {int(emptyT.sum())} bwd, "
                f"exactly 0")
        with torch.no_grad():
            got = [case.abuild(h, False), case.abuild(g, True)]
            again = [case.abuild(h, False), case.abuild(g, True)]
        for d, a, b, bc, plain in zip(("fwd", "bwd"), got, again, want_bc, (want, want_g)):
            err, rel, ok = rel_err(a, plain)
            if not ok or not rel_err(a, bc)[2] or not torch.equal(a, b):
                raise AssertionError(f"{name} F={f} spmm_block_coo_abuild {d}: disagrees "
                                     f"with the plain version or between two runs "
                                     f"(abs {err:.3e} rel {rel:.3e})")
            stats[f"spmm_block_coo_abuild_{d}"] = max(
                stats[f"spmm_block_coo_abuild_{d}"], err)
        log(f"  {name} F={f} spmm_block_coo_abuild (the earlier design): fwd and "
            f"transposed agree with the plain version, two runs bitwise equal")


def filled_batch(gs, device, slots=S):
    """A batch whose real nodes fill its bucket exactly (node count a
    multiple of 128, so node N−1 is real), with padded edges after the
    real ones."""
    from dgcnn_tpu_torch.batching.packer import BucketSpec, batch_to_device, pack_batch

    rng = np.random.default_rng(0)
    nc = gs.node_counts()
    for _ in range(100000):
        idx = rng.choice(gs.num_graphs, 50, replace=False)
        n = int(nc[idx].sum())
        if n % BS == 0:
            break
    else:
        raise AssertionError("no 50-graph subset fills a multiple of 128 nodes")
    e = int(gs.edge_counts()[idx].sum())
    host = pack_batch(gs, idx, BucketSpec(n, (e // 1024 + 2) * 1024, slots))
    if host.node_mask[-1] != 1 or host.edge_mask[-1] != 0:
        raise AssertionError("the filled batch must have a real node N-1 and padded edges")
    return batch_to_device(host, device)


def check_filled(name, b, device, stats):
    """On a bucket-filling batch: with the padded edges in the stream
    (weight 0, `edge_order` without a mask) each edge-stream kernel's
    forward gives the same bits as without them (they sit at the tail of
    the destination order, in row N−1, a real node); so does the row
    kernel's dh. The edge-block kernel's dh is held to the tolerance: the
    padded edges enter the source order in row 0 and shift every later
    position, so other rows straddle other 256-edge blocks and their
    partial sums group differently. All three agree with the plain version."""
    from dgcnn_tpu_torch.ops.spmm import edge_order

    case = SpmmCase(b, seed=3, device=device)
    compare_spmm(name, case, device, stats)
    unmasked = edge_order(case.src, case.dst, case.n)
    gen = torch.Generator(device=device).manual_seed(9)
    h = torch.randn((case.n, 32), generator=gen, device=device)
    g = torch.randn((case.n, 32), generator=gen, device=device)
    with_pad = case.fns(unmasked)
    for kname in ("spmm_rows", "spmm_edge_block"):
        a_out, a_grad = _run_twice(case.fns()[kname], h, g)
        b_out, b_grad = _run_twice(with_pad[kname], h, g)
        grad_same = torch.equal(a_grad[0], b_grad[0])
        _, _, grad_ok = rel_err(b_grad[0], a_grad[0])
        if not torch.equal(a_out[0], b_out[0]) or not grad_ok or (
                kname == "spmm_rows" and not grad_same):
            raise AssertionError(f"{name} {kname}: the padded edges changed the result")
        log(f"  {name} {kname}: {case.n} nodes, node N-1 real; "
            f"{case.src.shape[0] - case.e_real} padded edges in the stream: forward "
            f"bitwise equal, dh {'bitwise equal' if grad_same else 'within tolerance'}")
    return case


def library_csr(case, f, x, transpose):
    """The yardstick: the batch's adjacency as one `torch.sparse_csr_tensor`
    (cuSPARSE) times x; built outside the timed call."""
    o, m = case.order, case.e_real
    if transpose:
        perm, rp, col = o.permT.long()[:m], o.row_ptrT, case.dst
    else:
        perm = (torch.arange(case.src.shape[0], device=x.device) if o.perm is None
                else o.perm.long())[:m]
        rp, col = o.row_ptr, case.src
    a = torch.sparse_csr_tensor(rp.long(), col.long()[perm], case.w[perm],
                                size=(case.n, case.n))
    return lambda: a @ x


def probe_case(device, num_edges):
    """A probe shape (`_batch_edges(rng(0), 2048, num_edges)`) as a batch
    whose every edge is real, the w=0 padding edges into node 2,047 too
    (the long row, when it has padding), with random nonzero weights on
    all of them, so a slot dropped from the long row would show."""
    import types

    from dgcnn_tpu_torch.tools.probe_kernel_anatomy import STANDARD
    from dgcnn_tpu_torch.utils.profiling import _batch_edges

    n = STANDARD[0]
    src, dst, _ = _batch_edges(np.random.default_rng(0), n, num_edges)
    b = types.SimpleNamespace(
        x=torch.zeros((n, 1), device=device), edge_src=torch.from_numpy(src).to(device),
        edge_dst=torch.from_numpy(dst).to(device),
        edge_mask=torch.ones(len(src), device=device))
    return SpmmCase(b, seed=5, device=device)


BLOCK_COO_TIMED = ("spmm_block_coo", "spmm_block_coo_abuild")


def time_spmm(case, flush, device, kernels=SPMM_KERNELS + ("spmm_block_coo_abuild",)):
    """Per kernel of `kernels`, direction and F: warm and flushed device
    ms, the plain version's and the library call's ms, and the bound; the
    block-COO slot order's build time."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import _cuda_spmm, block_coo_order
    from dgcnn_tpu_torch.kernels.spmm_pallas import cuda_edge_block, cuda_rows
    from dgcnn_tpu_torch.ops.spmm import spmm_plain

    o, s, bo = case.order, case.structure, case.bc_order
    gen = torch.Generator(device=device).manual_seed(11)
    rows = {"order_ms": device_ms(lambda: block_coo_order(s, case.n))}
    log(f"  block-COO slot order (both orientations): {rows['order_ms']:.4f} ms")
    for f in (32, 1):
        h = torch.randn((case.n, f), generator=gen, device=device)
        g = torch.randn((case.n, f), generator=gen, device=device)
        # forward reads h at the sources, the backward g at the destinations
        bnds = {d: spmm_bound(case.e_real, case.n, case.rows_read[i], f)
                for i, d in enumerate(("fwd", "bwd"))}
        calls = {}
        for kname, launch in (("spmm_rows", cuda_rows), ("spmm_edge_block", cuda_edge_block)):
            calls[kname] = (
                lambda launch=launch: launch(o.row_ptr, o.perm, case.dst, case.src,
                                             case.w, h, False),
                lambda launch=launch: launch(o.row_ptrT, o.permT, case.src, case.dst,
                                             case.w, g, True))
        calls["spmm_block_coo"] = (
            lambda: _cuda_spmm(bo.row_ptr, bo.perm, s.item_c, s.ls, case.w_pad, h, False),
            lambda: _cuda_spmm(bo.row_ptrT, bo.permT, s.item_cT, s.lsT, case.w_padT, g,
                               True))
        calls["spmm_block_coo_abuild"] = (lambda: case.abuild(h, False),
                                          lambda: case.abuild(g, True))
        calls = {k: v for k, v in calls.items() if k in kernels}
        plain = {
            "fwd": device_ms(lambda: spmm_plain(case.src, case.dst, case.w, h, case.n)),
            "bwd": device_ms(lambda: spmm_plain(case.dst, case.src, case.w, g, case.n)),
        }
        lib = {}
        for d, tr, x in (("fwd", False, h), ("bwd", True, g)):
            try:
                call = library_csr(case, f, x, tr)
                want = (spmm_plain(case.dst, case.src, case.w, g, case.n) if tr
                        else spmm_plain(case.src, case.dst, case.w, h, case.n))
                err, _, ok = rel_err(call(), want)
                if not ok:
                    raise AssertionError(f"CSR product disagrees ({err:.3e})")
                lib[d] = events_ms(call)
            except (RuntimeError, AssertionError, NotImplementedError) as e:
                log(f"  library CSR {d} F={f}: {type(e).__name__}: {str(e)[:200]} → null")
                lib[d] = None
        for kname, (fwd, bwd) in calls.items():
            for d, fn in (("fwd", fwd), ("bwd", bwd)):
                bnd = bnds[d]
                row = {
                    "ms": device_ms(fn), "ms_l2_flushed": device_ms(fn, flush),
                    "plain_ms": plain[d], "library_ms": lib[d],
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "edges": case.e_real, "n": case.n, "f": f,
                    "items": case.items[0 if d == "fwd" else 1], "slots": case.slots,
                }
                rows[(kname, d, f)] = row
                log(f"  {kname} {d} F={f} edges {case.e_real} N {case.n}"
                    + (f" items {row['items']} of {case.slots}, longest row "
                       f"{case.longest_row} slots" if kname in BLOCK_COO_TIMED else "")
                    + f": kernel warm {row['ms']:.4f} ms, L2-flushed "
                    f"{row['ms_l2_flushed']:.4f} ms; plain {row['plain_ms']:.4f} ms; "
                    f"library {'null' if lib[d] is None else f'{lib[d]:.4f} ms'}; "
                    f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return rows


def spmm_step_ms(rows, kname):
    """A COO train step's SpMM time on one kernel: three F=32 and one F=1
    SpMM, forward and backward (the block-COO kernel's slot order not
    included)."""
    return sum(3 * rows[(kname, d, 32)]["ms"] + rows[(kname, d, 1)]["ms"]
               for d in ("fwd", "bwd"))


# -- phase 4: main paths ----------------------------------------------------


def count_steps(data_type, y, folds_n, epochs, batch, data_dir):
    from dgcnn_tpu_torch.data.folds import get_folds

    folds = get_folds(y, data_dir, folds_n, 324, data_type=data_type)
    train = sum(epochs * -(-len(tr) // batch) for tr, _ in folds)
    evals = sum(epochs * -(-len(te) // batch) for _, te in folds)
    return train, evals


def check_artifacts(tmp, data_type, folds_n, epochs):
    for f in range(1, folds_n + 1):
        path = os.path.join(tmp, "statistics", f"{data_type}_results_{f}.csv")
        rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        if rows.shape != (epochs, 5) or not np.isfinite(rows).all():
            raise AssertionError(f"{path}: bad metrics {rows}")
        log(f"  fold {f}: " + "; ".join(
            f"epoch {int(r[0])} train loss {r[1]:.4f} acc {r[3]:.2f}% "
            f"test loss {r[2]:.4f} acc {r[4]:.2f}%" for r in rows))
        if not os.path.exists(os.path.join(tmp, "epochs", f"{data_type}_{f}.npz")):
            raise AssertionError(f"fold {f}: no epochs/ bundle")
    with open(os.path.join(tmp, "statistics", f"{data_type}_events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    log("  epoch seconds (train + eval, host clock): " + ", ".join(
        f"fold {e['fold']} epoch {e['epoch']} {e['epoch_seconds']:.4f}"
        for e in events if e["kind"] == "epoch"))
    return events


def run_cli(data_type, extra, folds_n, epochs, tmp):
    from dgcnn_tpu_torch import cli

    argv = ["--data_type", data_type, "--synthetic", *extra,
            "--num_folds", str(folds_n), "--num_epochs", str(epochs),
            "--batch_size", "50", "--data_root", os.path.join(tmp, "data"),
            "--out_root", tmp]
    t0 = time.perf_counter()
    result = cli.main(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def card_vs_cpu(name, make_batch, model):
    """log-probs and every parameter gradient of one batch on the card and
    on the CPU, the same weights; returns the worst relative error."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

    outs = {}
    for dev in ("cpu", "cuda"):
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model, dev))
        b, kw = make_batch(dev)
        lp = net(b, **kw)
        loss, _ = nll_loss_and_correct(lp, b.y, b.graph_mask)
        loss.backward()
        outs[dev] = [lp.detach()] + [p.grad for p in net.parameters()]
    worst = 0.0
    for a, c in zip(outs["cuda"], outs["cpu"]):
        err, rel, ok = rel_err(a.cpu(), c)
        worst = max(worst, rel)
        if not ok or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: card vs CPU disagree (max abs {err:.3e})")
    log(f"  {name}: log_probs and {len(outs['cpu']) - 1} parameter gradients "
        f"agree, worst rel {worst:.3e}")
    return worst


# -- phase 6: one profiled train step ---------------------------------------


def profile_step(name, net, optimizer, batch, fwd_kw):
    from dgcnn_tpu_torch.train.loop import train_step

    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        train_step(net, optimizer, batch, gen, **fwd_kw)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        train_step(net, optimizer, batch, gen, **fwd_kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(net, optimizer, batch, gen, **fwd_kw)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    def self_dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    # device-side events only (kernels, memcpy, memset): the CPU ops'
    # device totals, and the GPU spans of annotations such as
    # "Optimizer.step#Adam.step", would count the same kernels again
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and "#" not in e.key),
                     key=self_dev_us, reverse=True)
    total = sum(self_dev_us(e) for e in kernels)
    log(f"  {name} train step: wall median {np.median(walls):.3f} ms "
        f"(min {min(walls):.3f}, host clock, 10 steps); profiler device time "
        f"{total / 1e3:.3f} ms over {sum(e.count for e in kernels)} kernel launches")
    if total == 0:
        log("  the profiler recorded no device time on this machine")
    for e in kernels[:10]:
        log(f"    {self_dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return float(np.median(walls)), total / 1e3, sum(e.count for e in kernels)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card")
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.kernels import dense_trunk as dt
    from dgcnn_tpu_torch.train.cv import fp32_only

    fp32_only()
    device = torch.device("cuda")
    t_start = time.perf_counter()

    log("== phase 1: card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    log("== phase 2: build kernels")
    _build.build_all()
    rep = _build.build_report()
    log(f"built {sorted(rep['ptxas'])} in {rep['seconds']:.1f} s")
    for src, text in rep["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {src}: {line.strip()}")

    stats = {f"{k}_{d}": 0.0 for k in ("gcn_trunk", *BLOCK_KERNELS, *SPMM_KERNELS,
                                        "spmm_block_coo_abuild")
             for d in ("fwd", "bwd")}

    log("== phase 3a: trunk kernel vs plain version on the card")
    datasets = {n: synthesize_tu_dataset(n) for n in ("MUTAG", "NCI1", "PROTEINS")}
    from dgcnn_tpu_torch.batching.dense import dense_tile

    t_main = dense_tile(datasets["NCI1"])
    shapes = check_trunk(datasets, device, dt, stats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("== phase 3b: block kernels vs plain version on the card")
    ctx = DDContext(device)
    if ctx.layout != "block":
        raise AssertionError(f"choose_layout gave {ctx.layout} for DD, not block")
    check_blocks(ctx, device, stats)

    log("== phase 3c: SpMM kernels vs plain version on the card")
    dd_coo = CooContext("DD", device, gs=ctx.gs)
    nci1_coo = CooContext("NCI1", device, gs=datasets["NCI1"])
    spmm_cases = {}  # the batches phase 5 times, by label
    for label, key, c, r in (("DD mean", "mean", dd_coo, dd_coo.mean_row),
                             ("DD largest", "max", dd_coo, dd_coo.max_row),
                             ("NCI1", "NCI1 dev", nci1_coo, nci1_coo.mean_row)):
        case = spmm_cases[key] = SpmmCase(c.batch(r), seed=r, device=device)
        compare_spmm(f"{label} COO batch (row {r}, {case.e_real} edges, N {case.n}, "
                     f"block-COO items {case.items} of {case.slots})", case, device, stats)
    dd_host = HostCooContext("DD", ctx.gs, device)
    nci1_host_coo = HostCooContext("NCI1", datasets["NCI1"], device)
    for label, key, c, r in (
            ("DD mean", "host mean", dd_host, dd_host.mean_row),
            ("DD largest", "host max", dd_host, dd_host.max_row),
            ("NCI1 mean", "NCI1 host mean", nci1_host_coo, nci1_host_coo.mean_row)):
        case = spmm_cases[key] = c.case(r)
        compare_spmm(f"{label} CooEngine batch (row {r}, {case.e_real} edges, N "
                     f"{case.n}, block-COO items {case.items} of {case.slots})",
                     case, device, stats)
    spmm_cases["NCI1 filled"] = check_filled(
        "NCI1 bucket-filling batch", filled_batch(datasets["NCI1"], device), device, stats)
    from dgcnn_tpu_torch.tools.probe_kernel_anatomy import LONG_ROW_EDGES, STANDARD

    for key, e in (("probe standard", STANDARD[1]), ("probe long row", LONG_ROW_EDGES)):
        case = spmm_cases[key] = probe_case(device, e)
        compare_spmm(f"{key} shape ({case.e_real} edges, N {case.n}, every edge real, "
                     f"longest row {case.longest_row} slots, block-COO items "
                     f"{case.items} of {case.slots})", case, device, stats)

    log("== phase 4a: main path, synthetic NCI1, dense, 2 folds x 2 epochs")
    with tempfile.TemporaryDirectory() as tmp:
        dt.launches.reset()
        result, wall = run_cli("NCI1", ["--layout", "dense"], 2, 2, tmp)
        trunk_fwd_n, trunk_bwd_n = dt.launches.fwd_launches, dt.launches.bwd_launches
        tr_n, ev_n = count_steps("NCI1", datasets["NCI1"].y, 2, 2, 50,
                                 os.path.join(tmp, "data", "NCI1", "10fold_idx"))
        log(f"main path: {wall:.1f} s; train steps {tr_n}, eval steps {ev_n}; "
            f"trunk launches fwd {trunk_fwd_n} bwd {trunk_bwd_n}")
        if trunk_fwd_n != tr_n + ev_n or trunk_bwd_n != tr_n:
            raise AssertionError("trunk launch counts do not match the steps run")
        by_regime = (dt.launches.resident_fwd, dt.launches.resident_bwd,
                     dt.launches.streamed_fwd, dt.launches.streamed_bwd)
        log(f"  trunk calls by regime (resident fwd, bwd, streamed fwd, bwd): "
            f"{by_regime}; plan at T={t_main}: {dt.trunk_plan(S, t_main, DIMS)}")
        if by_regime != (trunk_fwd_n, trunk_bwd_n, 0, 0):
            raise AssertionError("a main-path trunk call did not run resident")
        check_artifacts(tmp, "NCI1", 2, 2)
        log(f"accuracies: train {result['train_accuracies']} "
            f"test {result['test_accuracies']}")

    from dgcnn_tpu_torch.batching.dense import batch_to_device, pack_dense_batch
    from dgcnn_tpu_torch.models.dgcnn import DGCNN

    nci1 = datasets["NCI1"]
    nci1_model = DGCNN(num_features=nci1.num_features, num_classes=nci1.num_classes)
    nci1_host = pack_dense_batch(nci1, np.arange(100, 150), t_main, S)
    card_vs_cpu("NCI1 dense batch",
                lambda dev: (batch_to_device(nci1_host, dev), {}), nci1_model)

    from dgcnn_tpu_torch.config import Config

    auto_impl = Config().resolved_block_impl()
    other_impl = {"pallas": "xla", "xla": "pallas"}[auto_impl]
    kernel_of = {"pallas": "block_csr", "xla": "block_resident"}
    log(f"== phase 4b: main path, synthetic DD, --layout auto (block, "
        f"block_impl auto = {auto_impl}), 2 folds x 2 epochs; then "
        f"--block_impl {other_impl}, 1 fold x 1 epoch")
    mods = {k: m for k, (m, _) in block_kernels().items()}
    dd_launches = {}
    for impl, extra, folds_n, epochs in (
        (auto_impl, ["--layout", "auto"], 2, 2),
        (other_impl, ["--block_impl", other_impl], 1, 1),
    ):
        with tempfile.TemporaryDirectory() as tmp:
            for m in mods.values():
                m.launches.reset()
            _, wall = run_cli("DD", extra, folds_n, epochs, tmp)
            counts = {k: (m.launches.fwd_launches, m.launches.bwd_launches)
                      for k, m in mods.items()}
            tr_n, ev_n = count_steps("DD", ctx.gs.y, folds_n, epochs, 50,
                                     os.path.join(tmp, "data", "DD", "10fold_idx"))
            used = kernel_of[impl]
            idle = kernel_of[{"pallas": "xla", "xla": "pallas"}[impl]]
            f1 = (mods[used].launches.f1_fwd, mods[used].launches.f1_bwd)
            log(f"DD {' '.join(extra)}: {wall:.1f} s; train steps {tr_n}, eval "
                f"steps {ev_n}; propagations (fwd, bwd) {counts}, of width 1 on "
                f"{used} {f1}")
            if (counts[used] != (4 * (tr_n + ev_n), 4 * tr_n) or counts[idle] != (0, 0)
                    or f1 != (tr_n + ev_n, tr_n)):
                raise AssertionError(
                    f"block launch counts do not match the steps run on {used}")
            dd_launches[used] = counts[used]
            dd_launches[used + "_f1"] = f1
            events = check_artifacts(tmp, "DD", folds_n, epochs)
            start = events[0]
            if (start["kind"] != "run_start" or start["layout"] != "block"
                    or start["block_impl"] != impl):
                raise AssertionError(f"run_start says {start}")
            log(f"  run_start: layout {start['layout']}, block_impl {start['block_impl']}")
            if impl == auto_impl:
                dd_epoch_s = [e["epoch_seconds"] for e in events if e["kind"] == "epoch"]

    from dgcnn_tpu_torch.batching.block_sparse import (
        block_graphset_to_device, build_block_graphset, gather_block_batch)

    dd = ctx.gs
    dd_model = DGCNN(num_features=dd.num_features, num_classes=dd.num_classes)
    dd_cpu = block_graphset_to_device(build_block_graphset(dd), "cpu")
    dd_row = ctx.rows[ctx.mean_row]

    def dd_batch(impl):
        def make(dev):
            gsd = ctx.engine.dev if dev == "cuda" else dd_cpu
            row = torch.from_numpy(dd_row).to(dev)
            return (gather_block_batch(gsd, row, ctx.nb, ctx.w),
                    {"pool": gsd.pool, "block_impl": impl})
        return make

    for impl in ("pallas", "xla"):
        card_vs_cpu(f"DD block batch (block_impl {impl})", dd_batch(impl), dd_model)
    del dd_cpu

    spmm_auto = Config().resolved_spmm_impl()
    spmm_other = {"xla": "onehot", "onehot": "xla"}[spmm_auto]
    log(f"== phase 4c: main path, synthetic DD, --layout coo: --spmm auto "
        f"(= {spmm_auto}) 2 folds x 2 epochs, then --spmm {spmm_other} and "
        f"--spmm pallas 1 fold x 1 epoch; synthetic NCI1 --layout coo --spmm "
        f"pallas 1 fold x 1 epoch")
    counters = spmm_counters()
    coo_launches, coo_epoch_s = {}, {}
    for data_type, impl, name, folds_n, epochs in (
        ("DD", spmm_auto, "auto", 2, 2),
        ("DD", spmm_other, spmm_other, 1, 1),
        ("DD", "pallas", "pallas", 1, 1),
        ("NCI1", "pallas", "pallas", 1, 1),
    ):
        extra = ["--layout", "coo", "--spmm", name]
        with tempfile.TemporaryDirectory() as tmp:
            for c in counters.values():
                c.reset()
            _, wall = run_cli(data_type, extra, folds_n, epochs, tmp)
            counts = {k: (c.fwd_launches, c.bwd_launches) for k, c in counters.items()}
            gs = ctx.gs if data_type == "DD" else nci1
            tr_n, ev_n = count_steps(data_type, gs.y, folds_n, epochs, 50,
                                     os.path.join(tmp, "data", data_type, "10fold_idx"))
            used = SPMM_KERNEL_OF[impl]
            log(f"{data_type} {' '.join(extra)}: {wall:.1f} s; train steps {tr_n}, "
                f"eval steps {ev_n}; launches (fwd, bwd) {counts}")
            want = {k: (4 * (tr_n + ev_n), 4 * tr_n) if k == used else (0, 0)
                    for k in SPMM_KERNELS}
            if counts != want:
                raise AssertionError(f"SpMM launch counts {counts}, expected {want}")
            if data_type == "DD" and used not in coo_launches:
                coo_launches[used] = counts[used]
            events = check_artifacts(tmp, data_type, folds_n, epochs)
            start = events[0]
            if (start["kind"] != "run_start" or start["layout"] != "coo"
                    or start["spmm_impl"] != impl):
                raise AssertionError(f"run_start says {start}")
            log(f"  run_start: layout {start['layout']}, spmm_impl {start['spmm_impl']}")
            coo_epoch_s[(data_type, name)] = [
                e["epoch_seconds"] for e in events if e["kind"] == "epoch"]

    from dgcnn_tpu_torch.batching.packer import batch_to_device as coo_to_device

    def coo_batch(c, r, impl):
        def make(dev):
            return coo_to_device(c.host_batch(r), dev), {"spmm_impl": impl}
        return make

    def host_coo_batch(hc, r):
        return lambda dev: (hc.batch(r, dev), {"spmm_impl": "pallas"})

    for c, hc, model in ((dd_coo, dd_host, dd_model),
                         (nci1_coo, nci1_host_coo, nci1_model)):
        for impl in ("xla", "onehot"):
            card_vs_cpu(f"{c.name} COO batch (row {c.mean_row}, spmm_impl {impl})",
                        coo_batch(c, c.mean_row, impl), model)
        card_vs_cpu(f"{c.name} CooEngine batch (row {hc.mean_row}, spmm_impl pallas)",
                    host_coo_batch(hc, hc.mean_row), model)

    log("== phase 5: device times (CUDA-graph replay, CUDA events)")
    log(card)
    flush = Flush(device)
    log(f"  L2 flush: {FLUSH_BYTES >> 20} MB write, {flush.ms:.4f} ms")
    trunk_times = {}
    t_prot = dense_tile(datasets["PROTEINS"])
    timed = [(t, None) for t in (t_main, 112, t_prot, 624)] + [
        (t, dt.trunk_plan(S, t, DIMS, c=c)) for t in (t_main, t_prot) for c in dt.CLUSTERS]
    for t, plan in timed:
        adj, mask = shapes[t]
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, 1, seed=1, device=device)
        with torch.no_grad():
            cat = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
        g = torch.randn_like(cat)
        fwd = lambda: dt._cuda_fwd(DIMS, adj, hw1, mask, wsel, ws, bs, 1, plan)  # noqa: E731
        bwd = lambda: dt._cuda_bwd(DIMS, adj, mask, wsel, ws, cat, g, 1, plan)  # noqa: E731
        fits = plan is None or plan.bwd_smem <= dt.SMEM_MAX
        row = {
            "fwd": device_ms(fwd), "fwd_flushed": device_ms(fwd, flush),
            "bwd": device_ms(bwd) if fits else math.nan,
            "bwd_flushed": device_ms(bwd, flush) if fits else math.nan,
        }
        if plan is None:
            row["fwd_plain"] = device_ms(
                lambda: dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs))
            row["bwd_plain"] = device_ms(
                lambda: dt.gcn_trunk_plain_bwd(DIMS, adj, mask, wsel, ws, cat, g))
        (fb, fby), (bb, bby) = trunk_bounds(S, t, 1)
        used = plan or dt.trunk_plan(S, t, DIMS)
        row.update(bound_fwd=fb, bound_fwd_by=fby, bound_bwd=bb, bound_bwd_by=bby,
                   plan=f"{used.regime}" + (f" C={used.c}" if used.c else ""))
        trunk_times[(t, None if plan is None else plan.c)] = row
        plain = (f" plain {row['fwd_plain']:.4f}" if plan is None else "",
                 f" plain {row['bwd_plain']:.4f}" if plan is None else "")
        log(f"  trunk S={S} T={t} {row['plan']}{' (forced)' if plan else ''}: fwd "
            f"kernel {row['fwd']:.4f} ms (flushed {row['fwd_flushed']:.4f}){plain[0]} "
            f"bound {fb:.4f} ({fby}) | bwd kernel {row['bwd']:.4f} ms (flushed "
            f"{row['bwd_flushed']:.4f}){plain[1]} bound {bb:.4f} ({bby})")
    for t in (t_main, 112, t_prot, 624):
        row = trunk_times[(t, None)]
        log(f"  trunk T={t}: below the plain chain forward "
            f"{'yes' if row['fwd'] < row['fwd_plain'] else 'NO'}, backward "
            f"{'yes' if row['bwd'] < row['bwd_plain'] else 'NO'}")
    block_times = {}
    for label, r in (("mean", ctx.mean_row), ("max", ctx.max_row),
                     ("largest graph", ctx.big_row)):
        log(f"  DD {label} batch (row {r}):")
        block_times[label] = time_block(ctx, r, flush, device)
    for label, rows in block_times.items():
        steps = {k: block_step_ms(rows, k) for k in BLOCK_KERNELS}
        log(f"  DD {label} batch, one train step's propagations (3 x F=32 + F=1, fwd + "
            f"bwd): " + ", ".join(f"{k} {v:.4f} ms" for k, v in steps.items())
            + f"; faster: {min(steps, key=steps.get)}")
        if label == "mean":
            for k in BLOCK_KERNELS:
                log(f"    {k} by design: " + ", ".join(
                    f"[{lab}] {block_step_ms(rows, k, lab):.4f} ms"
                    for lab, _ in block_variants(k)))
        for k in BLOCK_KERNELS:
            shapes = [(d, f) for d in ("fwd", "bwd") for f in (32, 1)]
            beats = all(block_row(rows, k, d, f)["library_ms"] is not None
                        and block_row(rows, k, d, f)["ms"] < block_row(rows, k, d, f)["library_ms"]
                        for d, f in shapes)
            ratios = ", ".join(f"{d} F={f} {block_row(rows, k, d, f)['ms'] / block_row(rows, k, d, f)['bound_ms']:.2f}x"
                               for d, f in shapes)
            log(f"    {k}: below cuSPARSE BSR at every F and direction: "
                f"{'yes' if beats else 'no'}; time over bound {ratios}")
    spmm_times = {}
    for label, what in (("mean", "DD COO mean batch"), ("max", "DD COO largest batch"),
                        ("host mean", "DD CooEngine mean batch (what --spmm pallas "
                                      "trains on)"),
                        ("host max", "DD CooEngine largest batch")):
        log(f"  {what}:")
        spmm_times[label] = time_spmm(spmm_cases[label], flush, device)
    for label in ("NCI1 dev", "NCI1 host mean", "NCI1 filled", "probe standard",
                  "probe long row"):
        log(f"  {label} batch (block-COO only):")
        spmm_times[label] = time_spmm(spmm_cases[label], flush, device,
                                      kernels=BLOCK_COO_TIMED)
    for label in ("mean", "max", "host mean", "host max"):
        rows = spmm_times[label]
        log(f"  DD COO {label} batch, one train step's SpMMs (3 x F=32 + F=1, fwd + "
            f"bwd): " + ", ".join(f"{k} {spmm_step_ms(rows, k):.4f} ms"
                                  for k in SPMM_KERNELS + ("spmm_block_coo_abuild",)))
    for label, rows in spmm_times.items():
        beats = all(rows[("spmm_block_coo", d, 32)]["library_ms"] is not None
                    and rows[("spmm_block_coo", d, 32)]["ms"]
                    < rows[("spmm_block_coo", d, 32)]["library_ms"] for d in ("fwd", "bwd"))
        log(f"  {label}: block-COO F=32 fwd and bwd below cuSPARSE: "
            f"{'yes' if beats else 'no'}")
    del flush

    log("== phase 6: one profiled train step (torch.profiler)")
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import make_optimizer

    net = DGCNNNet(nci1_model, init_params(torch.Generator().manual_seed(0), nci1_model, device))
    nci1_step = profile_step("NCI1 dense", net, make_optimizer(net),
                             batch_to_device(nci1_host, device), {})
    for impl in (auto_impl, other_impl):
        net = DGCNNNet(dd_model, init_params(torch.Generator().manual_seed(0), dd_model,
                                             device))
        profile_step(f"DD block ({impl} = {kernel_of[impl]}, mean batch)", net,
                     make_optimizer(net), ctx.batch(ctx.mean_row),
                     {"pool": ctx.pool, "block_impl": impl})
    net = DGCNNNet(dd_model, init_params(torch.Generator().manual_seed(0), dd_model, device))
    profile_step(f"DD COO ({spmm_auto}, mean batch)", net, make_optimizer(net),
                 dd_coo.batch(dd_coo.mean_row), {"spmm_impl": spmm_auto})
    net = DGCNNNet(dd_model, init_params(torch.Generator().manual_seed(0), dd_model, device))
    profile_step("DD COO (pallas, CooEngine mean batch; the slot order's sorts included)",
                 net, make_optimizer(net), dd_host.batch(dd_host.mean_row),
                 {"spmm_impl": "pallas"})

    log("== phase 7: the block-COO cost-split probe "
        "(dgcnn_tpu_torch.tools.probe_kernel_anatomy)")
    from dgcnn_tpu_torch.tools import probe_kernel_anatomy as probe

    probe_shapes = [probe.standard_shape(device),
                    probe.standard_shape(device, probe.LONG_ROW_EDGES),
                    probe.stack_shape(f"DD CooEngine mean batch (row {dd_host.mean_row})",
                                      dd_host.stack, dd_host.mean_row, device)]
    probe_result = probe.run(probe_shapes, device)  # checks, then counts 0, then times
    if probe_result["launches"] == 0 or probe_result["launches"] != probe.launches.fwd_launches:
        raise AssertionError(f"probe launches {probe_result['launches']}")
    log("probe: " + json.dumps(probe_result))

    log(f"== phase 8: summary ({time.perf_counter() - t_start:.0f} s)")
    (fb, fby), (bb, bby) = trunk_bounds(S, t_main, 1)
    trunk_src = "dgcnn_tpu_torch/csrc/dense_trunk.cu"
    tm = trunk_times[(t_main, None)]
    kernels = [
        {"name": "gcn_trunk_fwd", "route": "cuda", "source": trunk_src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:232",
         "launches": trunk_fwd_n, "max_abs_err": stats["gcn_trunk_fwd"],
         "ms": tm["fwd"], "ms_l2_flushed": tm["fwd_flushed"],
         "plain_ms": tm["fwd_plain"], "bound_ms": fb, "bound_by": fby,
         "library_ms": None, "plan": tm["plan"]},
        {"name": "gcn_trunk_bwd", "route": "cuda", "source": trunk_src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:310",
         "launches": trunk_bwd_n, "max_abs_err": stats["gcn_trunk_bwd"],
         "ms": tm["bwd"], "ms_l2_flushed": tm["bwd_flushed"],
         "plain_ms": tm["bwd_plain"], "bound_ms": bb, "bound_by": bby,
         "library_ms": None, "plan": tm["plan"]},
    ]
    replaces = {"block_csr": "dgcnn_tpu/kernels/block_pallas.py:152",
                "block_resident": "dgcnn_tpu/kernels/block_resident.py:130"}
    for kname in BLOCK_KERNELS:
        for i, d in enumerate(("fwd", "bwd")):
            f1_n = dd_launches[kname + "_f1"][i]
            for f, suffix, n in ((32, "", dd_launches[kname][i] - f1_n), (1, "_f1", f1_n)):
                row = block_row(block_times["mean"], kname, d, f)
                kernels.append({
                    "name": f"{kname}_{d}{suffix}", "route": "cuda",
                    "source": f"dgcnn_tpu_torch/csrc/{kname}.cu",
                    "replaces": replaces[kname],
                    "launches": n,
                    "max_abs_err": stats[f"{kname}_{d}"],
                    "ms": row["ms"], "ms_l2_flushed": row["ms_l2_flushed"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "shape": (f"DD mean batch: {row['n_items']} items, nb {row['nb']}, "
                              f"F {f}; {row['design']}"),
                })
    spmm_replaces = {
        "spmm_rows": "dgcnn_tpu/kernels/spmm_pallas.py:102",
        "spmm_edge_block": "dgcnn_tpu/kernels/spmm_pallas.py:170",
        "spmm_block_coo": "dgcnn_tpu/kernels/spmm_block_coo.py:399",
    }
    for kname in SPMM_KERNELS:
        # each kernel at the mean batch of the engine its name trains on
        where = "host mean" if kname == "spmm_block_coo" else "mean"
        engine = "CooEngine" if where == "host mean" else "DeviceCooEngine"
        for i, d in enumerate(("fwd", "bwd")):
            row = spmm_times[where][(kname, d, 32)]
            kernels.append({
                "name": f"{kname}_{d}", "route": "cuda",
                "source": f"dgcnn_tpu_torch/csrc/{kname}.cu",
                "replaces": spmm_replaces[kname],
                "launches": coo_launches[kname][i],
                "max_abs_err": stats[f"{kname}_{d}"],
                "ms": row["ms"], "ms_l2_flushed": row["ms_l2_flushed"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": (f"DD COO mean batch ({engine}): {row['edges']} edges, "
                          f"N {row['n']}, F 32"
                          + (f", {row['items']} items of {row['slots']}"
                             if kname == "spmm_block_coo" else "")),
            })
            if kname == "spmm_block_coo":
                kernels[-1]["abuild_ms"] = spmm_times[where][
                    ("spmm_block_coo_abuild", d, 32)]["ms"]
                kernels[-1]["slot_order_ms"] = spmm_times[where]["order_ms"]
    std = probe_result["shapes"][probe_shapes[0].label]
    kernels.append({
        "name": "probe_kernel_anatomy", "route": "cuda",
        "source": "dgcnn_tpu_torch/csrc/spmm_block_coo_probe.cu",
        "replaces": "tools/probe_kernel_anatomy.py:199",
        "launches": probe_result["launches"],
        "max_abs_err": max(std["max_abs_err"].values()),
        "ms": std["variants"]["abuild"]["ms"],
        "ms_l2_flushed": std["variants"]["abuild"]["ms_l2_flushed"],
        "plain_ms": std["plain_ms"], "bound_ms": std["bound_ms"],
        "bound_by": std["bound_by"], "library_ms": std["library_ms"],
        "shape": f"the abuild variant at the {probe_shapes[0].label}",
        "variants_ms": {v: t["ms"] for v, t in std["variants"].items()},
    })
    log(f"DD epoch seconds (main path, block_impl {auto_impl}): {dd_epoch_s}")
    log(f"COO epoch seconds: {coo_epoch_s}")
    log(f"NCI1 dense train step: wall {nci1_step[0]:.3f} ms, device {nci1_step[1]:.3f} "
        f"ms over {nci1_step[2]} kernel launches")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
