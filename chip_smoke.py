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
        the lockstep step's trunk: the ten folds' first train batches of
        synthetic NCI1 (T=88, plan resident C=1) and PROTEINS (T=176, C=2)
        stacked on the slot axis, S = 560, K = 10, slot s on weight set
        s // 56; the two tile classes of synthetic COLLAB's multi-tile
        layout at fold 1's first batch that holds both (T=256 at the
        engine's slot floor, resident; T=464 at S=4, streamed), and the
        same two classes repeated for 10 folds in lockstep (S = 10 × the
        class's slots, K = 10, slot s on weight set s // (S / 10)); the
        bf16 mode (adjacency rounded to bf16; with and without `round_h`,
        the bf16-compute flag; forward and backward against the plain
        version within 5e-3, two runs bitwise, the regime by the counts,
        every call a bf16 one) at NCI1 T=88, PROTEINS T=176, COLLAB's two
        classes, the lockstep step S=560 K=10, T=624 (streamed) and the
        bf16 resident cap ± 8, `trunk_plan`'s bytes at 2 bytes an element
        against the kernels', the regime logged at each T;
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
        the stress batch, forward and transposed; and the 10-fold merged
        stream of DD's mean lockstep step (`gather_block_batch_folds`,
        nb' = 10 × nb block-rows), every design, F ∈ {32, 1}; the bf16
        mode of both kernels (bf16 pool and hb) at the DD mean and
        largest batch and the 10-fold merged step, F ∈ {32, 1}, forward
        and transposed against the plain version within the fp32
        tolerance, two runs bitwise, the autograd entry's output and
        bf16 d_hb the launches' bits;
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
        edge exactly 0; the row and edge-block kernels forward and dh
        bitwise equal to their earlier designs (the C entries' `design` 1:
        one edge at a time through perm → col → h); the earlier A-build design of the block-COO kernel
        (the probe's `abuild`) forward and transposed against the same; on
        an NCI1 batch that fills its bucket, padded edges (weight 0, into
        the real node N−1) add exactly nothing; the row and edge-block
        kernels also on an unsorted stream with one row over ≥ 3 blocks of
        256 positions both ways, and on the same stream with no real edge;
  4. the main paths, each with its launch counts set to 0 just before
     and read just after. "A batch on the card against the CPU" holds
     the log-probs and every parameter gradient of one batch within rel
     1e-4 of each tensor's largest value (1e-2 under bf16), the CPU run
     on the branches the card took (`Branches`: each ReLU, max-pool
     select and sort-pool order; one the CPU's own values would take
     otherwise passes only as a near-tie, its deciding values within
     that tolerance of the boundary):
     a. `run_cross_validation` trains synthetic NCI1 (layout auto →
        dense, batch 50, `cv_parallel` auto → fold-lockstep) for 10 folds
        × 4 epochs with `max_fused_epochs` 2, through the fused runner
        (epoch 1 eager, the warm-up; epochs 2-4 CUDA-graph replays): every
        epoch event says `folds_in_lockstep` 10 and `chunk_epochs` 2,
        trunk launches exactly 4 × (train + eval lockstep steps) forward
        and 4 × train steps backward, counted per replay, all resident;
        then the same run with every epoch eager (`graphs=False`), every
        fold's row of every epoch bitwise equal; the sequential driver on
        the same folds, 10 × 2 (`max_fused_epochs` 1), graphed and eager,
        rows bitwise equal and epoch 1 within rtol/atol 5e-4 of
        lockstep's; synthetic PROTEINS lockstep (T=176, resident C=2),
        10 × 2, graphed and eager, rows bitwise equal; the fused runners
        built directly (lockstep, and fold 1 alone): one eager epoch of
        each body under `torch.cuda.set_sync_debug_mode("error")`, then 3
        epochs graphed against 3 eager from the same seeds — rows,
        parameters, optimizer state and dropout generators' states
        bitwise equal — and the peak memory of each; each fold's dropout
        mask in a lockstep forward is bitwise the sequential one; one
        lockstep batch (10 folds stacked) and one NCI1 batch on the card
        against the CPU;
     b. `run_cross_validation` trains synthetic DD (layout auto → block,
        the kernel `block_impl` auto names, `cv_parallel` sequential: the
        folds one after another, where `auto` would lockstep them, phase
        4e) for 2 folds × 4 epochs in
        chunks of `max_fused_epochs` 2 through the block layout's fused
        runner (each fold's chunk 1: a warm-up epoch, the capture and a
        replay; chunk 2: two replays), then 1 fold × 3 epochs with the
        other `block_impl` (CSR kernel = pallas, item-parallel kernel =
        xla); each run graphed (launches counted per replay: exactly
        4 × (train + eval steps) forward and 4 × train steps backward, a
        quarter of each of width 1, 0 on the other kernel) and again eager
        (`graphs=False`): every fold's rows and `epochs/` bundle
        (parameters, optimizer state) bitwise equal, the fold-epoch seconds
        of chunk 2 graphed beside eager; one DD batch on the card against
        the CPU through each kernel;
     c. the same for synthetic DD `--layout coo` (`DeviceCooEngine`):
        `--spmm auto` 2 × 4, the other device-assembled name 1 × 3, and
        `--spmm pallas` (`CooEngine`: host-packed sub-chunks, each epoch
        staged into one static device stack, block-pair structures padded
        to the sub-chunk's grow-only item budget; every epoch packed by the
        C++ packer) 2 × 4, and synthetic NCI1
        `--layout coo --spmm pallas` 1 × 2, graphed and eager, launches
        exact on the named kernel and 0 on the others; then the block and
        COO runners built directly (fold 1 of DD, its first 3 epochs at
        their budgets, `run_fold`'s seeds): one eager epoch of every new
        body (both block kernels, both device-assembled SpMM kernels, NCI1
        `CooEngine` with a staged epoch) under
        `torch.cuda.set_sync_debug_mode("error")`, 3 epochs graphed against
        3 eager (rows, parameters, optimizer state, generator states
        bitwise), capture seconds and peak memory; a forced budget growth
        on the block and the device-COO engine (two chunks at one budget,
        then a chunk with the fold's largest graphs in one batch): the
        budget grows there and only there, the old runner's graph is
        destroyed at its drop (memory before and after), exactly one new
        runner captures, and 5 epochs' rows, state and launch counts are
        eager's; one DD and one NCI1 COO batch on the card against the CPU
        through each kernel (the block-COO kernel on a `CooEngine` batch);
     d. synthetic COLLAB (5,000 graphs): `choose_layout` → multi, tiles
        (256, 464), the graphs of each class; the engine's device densify
        (seconds, peak memory), every class bitwise the host builder's
        (`build_multi_dense`); `run_cross_validation` (layout auto,
        `cv_parallel` sequential: at 2 folds the dense lockstep gate would
        engage, at the default 10 it does not) for 2 folds × 4 epochs in
        chunks of `max_fused_epochs` 2, graphed then eager: rows and
        `epochs/` bundles bitwise equal, trunk calls exact per replay by regime (the T=256
        class resident, the T=464 class streamed: L launches forward, L + 2
        backward), the slot floors, chunk 2's fold-epoch seconds; fold 1's
        runner built directly (one eager epoch under
        `set_sync_debug_mode("error")`, 3 epochs graphed against eager); a
        forced slot growth (the fold's largest graphs in one batch: the
        T=464 class's slots grow there and only there, one new runner);
        phase 3a's COLLAB batch on the card against the CPU; then
        `--layout dense` (T=464, S=56, streamed), 1 fold × 4 epochs graphed, for the
        record beside multi;
     e. synthetic DD in block fold-lockstep, chunks of `max_fused_epochs`
        2: `cv_parallel` folds at 2 folds × 4 epochs, graphed then eager
        (rows, `epochs/` bundles and launch counts bitwise equal, launches
        exactly 4 × (train + eval lockstep steps) forward and 4 × train
        steps backward per replay, every fold's rows within rtol/atol
        5e-4 of phase 4b's sequential run); the default, `auto` at 10
        folds × 4 epochs graphed (every event `folds_in_lockstep` 10, the
        merged budgets by chunk), 10 × 2 eager (epochs 1-2 bitwise), 10 ×
        2 through the other `block_impl` (within 5e-4); the 10-fold
        lockstep runner built directly (one eager epoch under
        `set_sync_debug_mode("error")`, 3 epochs graphed against eager);
        a forced budget growth over three chunks of the 10 folds (one new
        runner, one capture a budget, rows, state and launches bitwise
        eager); one 10-fold lockstep batch on the card against the CPU;
     f. synthetic COLLAB in multi-tile fold-lockstep (`layout` multi,
        `cv_parallel` folds), 2 folds × 4 epochs in chunks of 2, graphed
        then eager: rows, `epochs/` bundles and counts bitwise equal,
        trunk calls and kernel launches exact per replay by regime (each
        class's trunk on 2 × S_c slots), the rows' distance from phase
        4d's logged; one lockstep step of the 2 folds against each fold's
        own step (log-probs, gradients within rel 1e-4, masks bitwise);
     g. mixed precision on the main paths, chunks of 2, graphed then
        eager (rows and `epochs/` bundles bitwise, finite losses, launch
        counts exact per replay and every one in bf16): synthetic NCI1
        `--dtype bfloat16` (dense, 10-fold lockstep) 10 × 4, synthetic DD
        `--dtype bfloat16` (block, 10-fold lockstep, the CSR kernel) 10 ×
        4 and `--block_impl xla` 10 × 2 graphed, synthetic COLLAB
        `--adj_dtype bfloat16` (multi, sequential) 2 × 4 (trunk calls by
        regime at 2 bytes an element); each run's fold-epoch seconds and
        peak memory beside the fp32 run of 4a, 4e or 4d; one batch of
        each on the card against the CPU within rel 1e-2; the bf16
        lockstep runners (NCI1, DD) built directly;
     h. resume and inference: phase 4a's NCI1 dense lockstep run (10 × 4),
        phase 4e's DD block lockstep run (10 × 4) and phase 4c's DD
        `--layout coo` run (2 × 4) again with `--ckpt_every 2`, graphed,
        crashed by the event log (the lockstep runs at epoch 4, their
        bundle on disk epoch 2's; the COO run in fold 2, once at epoch 3
        and once at epoch 1, before fold 2's first in-flight bundle) and
        resumed: every fold's CSV byte for byte, its rows and `epochs/`
        bundle bitwise the uninterrupted run's, no in-flight bundle or
        floors file left, each in-flight save timed, fold 1's fold-epoch
        seconds with `--ckpt_every 2` beside the uninterrupted runs';
        `predict_dataset` of synthetic NCI1 (4,110 graphs) and DD (1,178)
        from fold 1's bundle of 4a and 4e: the row kernel's launches
        counted (3 at F=32 and 1 at F=1 a batch, exact per replay, none on
        the other kernels), graphed bitwise eager, the card within rel
        1e-4 of the CPU, one replay under `set_sync_debug_mode("error")`,
        graphs/s over a pass of replays and over a whole call;
     i. the COO layout under bf16 compute, the native packer, the parity
        harness and the forward entry: synthetic DD `--layout coo --dtype
        bfloat16` 2 × 4 under `--spmm auto` (`DeviceCooEngine`) and
        `pallas` (`CooEngine`), in chunks of 2, graphed then eager as in
        4c (the SpMM kernels fp32, launches exact per replay, rows and
        bundles bitwise), fold-epoch seconds and peak memory beside 4c's
        fp32 runs, one batch of each on the card against the CPU within
        rel 1e-2; the C++ packer built on the host, every `CooEngine` of
        4c packed through it (`CooEngine.packed`), one DD epoch packed
        both ways byte-equal, the seconds of each pack and of
        `add_blockcoo`; the parity harness's CLI, each step a fresh
        process: `dump` on the card, `dump --platform cpu` with its
        weights, `compare` at its defaults (MUTAG's first 50 graphs, COO),
        and this process's `dump_activations` against the card dump;
        `graft_entry.entry()`
        eager against `torch.compile`, allclose at rtol 1e-5, the row
        kernel launched by both;
  5. device times (utils/profiling.py `device_ms`): each call captured
     10 times in one CUDA graph, the graph replayed and timed with CUDA
     events, so the host's launch rate is out of the number; warm
     (operands left in L2 by the previous call) and after a 64 MB
     L2-flushing write (the write's own time, measured the same way,
     subtracted). The trunk at T = 88, 112, 176, 624 and each forced
     C at 88 and 176, and the lockstep step's trunk (S = 560, K = 10) at
     T = 88 and 176, and COLLAB's two tile classes (T=256 resident, T=464
     streamed) at that batch, one fold and 10 folds in lockstep, beside
     its bound (and its kind) and the plain chain; the bf16 mode at the
     lockstep step (round_h), S=56 at T=88 and 624 (round_h) and COLLAB's
     classes (bf16 adjacency), beside the fp32 times, bounds at 2 bytes
     an adjacency element.
     The block kernels at the DD mean and largest batch, the batch of
     the largest graph and the 10-fold merged mean lockstep step (beside
     10 × the one-fold mean batch), F ∈ {32, 1}, each design (the CSR kernel at
     P ∈ {2, 4, 6} and one piece per row; the item-parallel one at
     G ∈ {2, 4, 8}), each kernel's
     plan build, and one train step's propagations per kernel (the
     measure `block_impl` auto is chosen by).
     Kernel, plain version, bound and the library yardstick
     (`torch.sparse_bsr_tensor` @ dense for the block kernels,
     `torch.sparse_csr_tensor` @ dense, cuSPARSE, for the SpMM kernels at
     the DD COO mean and largest batch, both the device-assembled and the
     `CooEngine` ones), F ∈ {32, 1}; the row and edge-block kernels' earlier
     designs beside them at the device-assembled batches, and one train
     step's SpMMs on each (the measure `spmm_impl` auto is chosen by); the
     block-COO kernel, its earlier A-build design
     and its slot order's build also at every other batch of phase 3c;
     the block kernels' bf16 mode (the wrapper's design) at the DD mean
     batch and the merged step, beside fp32, bounds at 2 bytes an
     element, the library call on the widened operands; the row kernel
     at phase 4h's median inference batch of NCI1 and DD;
  6. one `torch.profiler` table of a single eager train step for NCI1
     dense (one fold, and the lockstep step of all ten, in fp32 and under
     bf16 compute), DD block through each `--block_impl` (one fold, and
     the 10-fold lockstep step at the merged mean step, in fp32 and under
     bf16 compute), DD COO, DD COO `--spmm pallas` and COLLAB multi
     (top 10 CUDA kernels) and each step's wall time and launches; the
     same for one epoch of each epoch graph (a replay): the NCI1 lockstep
     runner's, fold 1's one-fold runner's, DD's block and COO runners',
     DD's 10-fold block lockstep runner's, COLLAB's multi-tile
     runner's and the bf16 NCI1 and DD lockstep runners', with the
     replay's span between CUDA events, the per-step wall and device time,
     the device's idle share, the capture seconds and the peak memory;
  7. the block-COO cost-split probe (dgcnn_tpu_torch/tools/
     probe_kernel_anatomy.py) at its standard shape, its long-row variant
     and DD's `CooEngine` mean batch, its launch count set to 0 after its checks and read
     after its timing; its JSON line;
  8. one JSON line describing every kernel (the trunk at the lockstep
     step's shape with the lockstep main path's launches, replays
     counted, its one-fold
     shape and the COLLAB multi path's and multi lockstep path's calls,
     launches and class shapes beside it; the block and SpMM kernels once
     per width, F=32 and `_f1`, with the graphed main path's launches of
     that width, replays counted, the block kernels' DD lockstep path's
     launches and merged-step times beside them; the three kernels' bf16
     modes as `*_bf16_*` entries with phase 4g's launches; the row
     kernel's entries carry phase 4h's inference launches and graphs/s),
     the resume and inference numbers with the card line, the card line
     again, and the final `{"ok": true, ...}` line.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

from dgcnn_tpu_torch.utils.profiling import (
    ATOL, FLUSH_BYTES, RTOL, Flush, block_bounds, card_line, device_ms, events_ms,
    rel_err, spmm_bound, trunk_bounds,
)

S = 56  # graph slots: batch 50 rounded up to graph_pad_multiple 8
FOLDS = 10  # the reference's CV folds, stacked on the slot axis in lockstep
SL = FOLDS * S  # slots of one lockstep step
DIMS = (32, 32, 32, 1)
WIDE = ((64, 64, 64, 1), (128, 128, 128, 1))  # the two wider width buckets
BS = 128


T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("== phase"):
        msg += f" [{time.perf_counter() - T0:.0f} s]"
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


def lockstep_wsel(s, folds, device):
    """The weight set of each of `s` slots: slot i reads set i // (s / folds),
    its fold's."""
    return torch.arange(folds, dtype=torch.int32, device=device).repeat_interleave(
        s // folds)


def compare_trunk(name, adj, mask, device, dt, stats, dims=DIMS, plan=None,
                  folds=None):
    """The kernel against the plain version at K ∈ {1, 10}: forward, and
    every gradient against autograd of the plain chain, two backward runs
    bitwise equal. `plan` forces a regime / cluster size (the kernels are
    then called directly and their flat gradients summed as `GcnTrunkFn`
    does); else `gcn_trunk` runs the plan it picks. Checks that the
    planned regime ran. `folds` runs K = folds only, with the lockstep
    step's `wsel` (each fold's run of slots on its own weight set)."""
    sym = (adj - adj.mT).abs().max().item()
    if sym > 1e-7:
        raise AssertionError(f"{name}: adjacency not symmetric ({sym:.3g})")
    s, t = adj.shape[0], adj.shape[1]
    want_plan = plan or dt.trunk_plan(s, t, dims)
    n = len(dims)
    for k in (folds,) if folds else (1, 10):
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, k, seed=17 + k, device=device,
                                         dims=dims)
        if folds:
            wsel = lockstep_wsel(s, folds, device)
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
        per_fwd, per_bwd = dt.launches_per_call(want_plan, dims)
        if ran[f"{regime}_fwd"] < 1 or ran[f"{regime}_bwd"] != 2 or (
                ran["resident_fwd"] + ran["streamed_fwd"] != ran["fwd_launches"]) or (
                ran["kernel_fwd"] != per_fwd * ran["fwd_launches"]
                or ran["kernel_bwd"] != per_bwd * 2):
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


def resident_cap(dims=DIMS, es=4):
    """The largest multiple of 8 that the plan keeps resident at S slots,
    for an adjacency of `es` bytes an element."""
    from dgcnn_tpu_torch.kernels import dense_trunk as dt

    t = 8
    while dt.trunk_plan(S, t + 8, dims, es=es).regime == "resident":
        t += 8
    return t


# bf16 trunk vs its plain version: both round hw, d_pre (and with round_h
# each h) to bf16 where the kernel does, from fp32 sums taken in different
# orders, so a value at a rounding boundary may round one bf16 ulp apart
# (2^-8 relative) and carry that through the later layers: the reference's
# own bf16 tolerance for its kernel (tests/test_dense_trunk.py:78).
TRUNK_BF16_RTOL = 5e-3


def bf16_err(got, want, rtol=TRUNK_BF16_RTOL):
    """(max abs error, that over the largest |want|, within rtol of it)."""
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    scale = want.double().abs().max().item() if want.numel() else 0.0
    return err, err / max(scale, 1e-6), err <= 1e-6 + rtol * scale


def compare_trunk_bf16(name, adj32, mask, device, dt, stats, dims=DIMS, plan=None,
                       folds=None):
    """The bf16 mode against its plain version: the adjacency rounded to
    bf16, with and without `round_h` (then W_i passed rounded, as the
    model passes them), K ∈ {1, 10} (or K = folds with the lockstep
    `wsel`): forward, and the kernel's backward against the plain reverse
    recurrence (`gcn_trunk_plain_bwd`, the same rounding points) within
    `TRUNK_BF16_RTOL`, two backward runs bitwise equal, the planned regime
    and the bf16 entries checked by the launch counts. `plan` forces a
    regime or cluster size. Returns the plan that ran."""
    adj = adj32.to(torch.bfloat16)
    s, t = adj.shape[0], adj.shape[1]
    want_plan = plan or dt.trunk_plan(s, t, dims, es=2)
    n = len(dims)
    for round_h in (False, True):
        for k in (folds,) if folds else (1, 10):
            hw1, wsel, ws, bs = trunk_inputs(adj32, mask, k, seed=29 + k, device=device,
                                             dims=dims)
            if folds:
                wsel = lockstep_wsel(s, folds, device)
            if round_h:
                ws = [dt.round_bf16(w) for w in ws]
            before = dict(vars(dt.launches))
            with torch.no_grad():
                if plan is None:
                    cat_k = dt.gcn_trunk(dims, adj, hw1, mask, wsel, ws, bs, round_h)
                else:
                    cat_k = dt._cuda_fwd(dims, adj, hw1, mask, wsel, ws, bs, k, plan,
                                         round_h=round_h)
                cat_p = dt.gcn_trunk_plain(dims, adj, hw1, mask, wsel, ws, bs, round_h)
            err, rel, ok = bf16_err(cat_k, cat_p)
            stats["gcn_trunk_bf16_fwd"] = max(stats.get("gcn_trunk_bf16_fwd", 0.0), err)
            tag = f"{name} bf16{' round_h' if round_h else ''} K={k}"
            if not ok:
                raise AssertionError(f"{tag}: forward disagrees (max abs {err:.3e}, "
                                     f"rel {rel:.3e})")
            g = torch.randn(cat_p.shape, generator=torch.Generator(device=device)
                            .manual_seed(k), device=device)

            def kernel_grads():
                if plan is None:
                    xs = [x.detach().clone().requires_grad_() for x in [hw1, *ws, *bs]]
                    cat = dt.gcn_trunk(dims, adj, xs[0], mask, wsel, xs[1:n], xs[n:],
                                       round_h)
                    return list(torch.autograd.grad(cat, xs, g))
                d_hw1, flat = dt._cuda_bwd(dims, adj, mask, wsel, ws, cat_k, g, k, plan)
                dws, dbs = dt._split_grads(dt._segment_sum(flat, wsel, k), dims)
                return [d_hw1, *dws, *dbs]

            d_hw1, dws_slot, dbs_slot = dt.gcn_trunk_plain_bwd(dims, adj, mask, wsel,
                                                               ws, cat_p, g)
            flat = torch.cat([x.reshape(s, -1) for x in (*dws_slot, *dbs_slot)], 1)
            dws, dbs = dt._split_grads(dt._segment_sum(flat, wsel, k), dims)
            want = [d_hw1, *dws, *dbs]
            got, again = kernel_grads(), kernel_grads()
            ran = {key: v - before[key] for key, v in vars(dt.launches).items()}
            regime = want_plan.regime
            per_fwd, per_bwd = dt.launches_per_call(want_plan, dims)
            if ran[f"{regime}_fwd"] < 1 or ran[f"{regime}_bwd"] != 2 or (
                    ran["bf16_fwd"] != ran["fwd_launches"] or ran["bf16_bwd"] != 2) or (
                    ran["kernel_fwd"] != per_fwd * ran["fwd_launches"]
                    or ran["kernel_bwd"] != per_bwd * 2):
                raise AssertionError(f"{tag}: expected the {regime} bf16 kernels, "
                                     f"counts moved {ran}")
            names = ["d_hw1"] + [f"dW{i + 2}" for i in range(n - 1)] + [
                f"db{i + 1}" for i in range(n)]
            worst = (0.0, 0.0, "")
            for nm, a, b, c in zip(names, got, want, again):
                e, r, ok = bf16_err(a, b)
                if not ok:
                    raise AssertionError(f"{tag} {nm}: backward disagrees "
                                         f"(max abs {e:.3e}, rel {r:.3e})")
                if not torch.equal(a, c):
                    raise AssertionError(f"{tag} {nm}: two backward runs differ")
                stats["gcn_trunk_bf16_bwd"] = max(stats.get("gcn_trunk_bf16_bwd", 0.0), e)
                if r >= worst[1]:
                    worst = (e, r, nm)
            log(f"  {tag}: forward max abs {err:.3e} rel {rel:.3e}; backward worst "
                f"{worst[2]} max abs {worst[0]:.3e} rel {worst[1]:.3e} (ok within "
                f"{TRUNK_BF16_RTOL}; two runs bitwise equal; {regime}"
                f"{f', C={want_plan.c}' if regime == 'resident' else ''})")
    return want_plan


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


def check_trunk_bf16(shapes, lock_shapes, collab, t_main, t_prot, device, dt, stats):
    """Phase 3a's bf16 cases (`compare_trunk_bf16`: with and without
    `round_h`, forward and backward, two runs bitwise equal, the planned
    regime by the launch counts): NCI1 T=t_main and PROTEINS T=t_prot at
    S=56, COLLAB's two classes at fold 1's batch, the lockstep step S=560
    K=10 at T=t_main, T=624 (streamed), and random cases at the bf16
    resident cap and the cap + 8; `trunk_plan`'s bytes at 2 bytes an
    element against the kernels'. Logs the regime the plan picks at every
    T it checks. Returns the bf16 resident cap."""
    cap = resident_cap(es=2)
    log(f"  bf16 adjacency: the resident cap at S={S}, dims {DIMS} is T={cap} "
        f"(fp32: {resident_cap()})")
    for t in sorted(set(shapes) | {cap, cap + 8, *collab.tiles}):
        for plan in [dt.trunk_plan(S, t, DIMS, c=c, es=2) for c in dt.CLUSTERS] + [
                dt.trunk_plan(S, t, DIMS, regime="streamed", es=2)]:
            if dt.kernel_smem(plan, t, DIMS, es=2) != (plan.fwd_smem, plan.bwd_smem):
                raise AssertionError(f"bf16 plan {plan} at T={t}: the kernels count "
                                     f"{dt.kernel_smem(plan, t, DIMS, es=2)}")
    log("  trunk_plan's shared-memory bytes at 2 bytes an element equal the kernels'")
    cases = [(f"NCI1 T={t_main}", *shapes[t_main], None),
             (f"PROTEINS T={t_prot}", *shapes[t_prot], None),
             *[(name, adj, mask, None) for name, adj, mask in collab.shapes(device)],
             (f"lockstep S={SL} K={FOLDS} T={t_main}", *lock_shapes[t_main], FOLDS),
             ("PROTEINS T=624", *shapes[624], None)]
    for t in (cap, cap + 8):
        cases.append((f"random T={t} ({'bf16 resident cap' if t == cap else 'cap + 8'})",
                      *random_symmetric_case(t, seed=t + 1, device=device), None))
    for name, adj, mask, folds in cases:
        s, t = adj.shape[0], adj.shape[1]
        p32, p16 = dt.trunk_plan(s, t, DIMS), dt.trunk_plan(s, t, DIMS, es=2)
        log(f"  {name}: plan bf16 {p16.regime}{f' C={p16.c}' if p16.c else ''} (fp32 "
            f"{p32.regime}{f' C={p32.c}' if p32.c else ''})")
        compare_trunk_bf16(name, adj, mask, device, dt, stats, folds=folds)
    return cap


def dense_case(gs, n_tile, device):
    from dgcnn_tpu_torch.batching.dense import pack_dense_batch

    b = pack_dense_batch(gs, np.arange(50), n_tile, S)
    return torch.from_numpy(b.adj).to(device), torch.from_numpy(b.node_mask).to(device)


def lockstep_parts(gs, n_tile, data_type):
    """The lockstep main path's first train step, one host batch per fold:
    fold f's first 50 graphs of its epoch-1 shuffle
    (`default_rng(SeedSequence([324, f]))`, as the CV drivers draw it)."""
    from dgcnn_tpu_torch.batching.dense import pack_dense_batch
    from dgcnn_tpu_torch.data.folds import get_folds

    parts = []
    for f, (tr, _) in enumerate(get_folds(gs.y, "", FOLDS, 324, data_type=data_type),
                                start=1):
        perm = np.random.default_rng(np.random.SeedSequence([324, f])).permutation(len(tr))
        parts.append(pack_dense_batch(gs, np.asarray(tr)[perm][:50], n_tile, S))
    return parts


def stack_batches(parts):
    """F host batches → one of F·S slots, fold f's in slots [f·S, (f+1)·S)."""
    import dataclasses

    from dgcnn_tpu_torch.batching.dense import DenseGraphBatch

    return DenseGraphBatch(**{
        fld.name: (np.asarray(sum(int(p.num_graphs) for p in parts), np.int32)
                   if fld.name == "num_graphs" else
                   np.concatenate([getattr(p, fld.name) for p in parts]))
        for fld in dataclasses.fields(DenseGraphBatch)})


def check_lockstep_trunk(datasets, device, dt, stats):
    """Phase 3a's lockstep cases: the ten folds' first train rows of
    synthetic NCI1 (T=88, plan resident C=1) and PROTEINS (T=176, C=2)
    stacked on the slot axis, S = 560, K = 10; returns the shapes by T."""
    from dgcnn_tpu_torch.batching.dense import dense_tile

    shapes = {}
    for name, want_c in (("NCI1", 1), ("PROTEINS", 2)):
        t = dense_tile(datasets[name])
        b = stack_batches(lockstep_parts(datasets[name], t, name))
        adj = torch.from_numpy(b.adj).to(device)
        mask = torch.from_numpy(b.node_mask).to(device)
        plan = dt.trunk_plan(SL, t, DIMS)
        log(f"  lockstep {name} T={t} S={SL} K={FOLDS}: plan {plan}")
        if plan.regime != "resident" or plan.c != want_c:
            raise AssertionError(f"lockstep {name}: plan {plan}, expected resident "
                                 f"C={want_c}")
        compare_trunk(f"lockstep {name} T={t} S={SL}", adj, mask, device, dt, stats,
                      folds=FOLDS)
        shapes[t] = (adj, mask)
    return shapes


def time_trunk(dt, adj, mask, plan, flush, device, folds=None, round_h=False):
    """Phase 5's times of one trunk shape: kernel forward and backward warm
    and flushed, the plain chain (unforced plans), the bounds. K = 1, or
    K = `folds` with the lockstep `wsel`. A bf16 `adj` times the bf16 mode
    (`round_h`: bf16 compute, W_i rounded as the model passes them), its
    bounds at 2 bytes an adjacency element."""
    k = folds or 1
    s, t = adj.shape[0], adj.shape[1]
    es = adj.element_size()
    hw1, wsel, ws, bs = trunk_inputs(adj, mask, k, seed=1, device=device)
    if folds:
        wsel = lockstep_wsel(s, folds, device)
    if round_h:
        ws = [dt.round_bf16(w) for w in ws]
    with torch.no_grad():
        cat = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs, round_h)
    g = torch.randn_like(cat)
    fwd = lambda: dt._cuda_fwd(DIMS, adj, hw1, mask, wsel, ws, bs, k, plan,  # noqa: E731
                               round_h=round_h)
    bwd = lambda: dt._cuda_bwd(DIMS, adj, mask, wsel, ws, cat, g, k, plan)  # noqa: E731
    fits = plan is None or plan.bwd_smem <= dt.SMEM_MAX
    row = {
        "fwd": device_ms(fwd), "fwd_flushed": device_ms(fwd, flush),
        "bwd": device_ms(bwd) if fits else math.nan,
        "bwd_flushed": device_ms(bwd, flush) if fits else math.nan,
    }
    if plan is None:
        row["fwd_plain"] = device_ms(
            lambda: dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs, round_h))
        row["bwd_plain"] = device_ms(
            lambda: dt.gcn_trunk_plain_bwd(DIMS, adj, mask, wsel, ws, cat, g))
    (fb, fby), (bb, bby) = trunk_bounds(s, t, k, DIMS, es, round_h)
    used = plan or dt.trunk_plan(s, t, DIMS, es=es)
    row.update(bound_fwd=fb, bound_fwd_by=fby, bound_bwd=bb, bound_bwd_by=bby,
               plan=f"{used.regime}" + (f" C={used.c}" if used.c else ""))
    return row


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


class DDLockstepContext:
    """Synthetic DD's default run, 10 folds in lockstep (seed 324, batch
    50), as the block kernels see it: epoch 1's [steps, F, slots] orders
    of every fold (each fold's shuffle stream, as the driver draws it)
    and the folds' test orders, the merged stream's budgets (nb per fold,
    W per step: `block_fold_extents` on the reference's grid, floors 8 and
    64) and the train step whose merged items are nearest the mean: the
    shape phase 3b checks and phase 5 times."""

    def __init__(self, ctx):
        from dgcnn_tpu_torch.batching.block_sparse import block_fold_extents
        from dgcnn_tpu_torch.data.folds import get_folds
        from dgcnn_tpu_torch.train.cv import _geom_round
        from dgcnn_tpu_torch.train.cv_vmap import stacked_orders

        self.ctx = ctx
        folds = get_folds(ctx.gs.y, "", FOLDS, 324, data_type="DD")
        train = [np.asarray(tr, np.int32) for tr, _ in folds]
        test = [np.asarray(te, np.int32) for _, te in folds]
        self.steps = max(-(-len(t) // 50) for t in train)
        self.t_steps = max(-(-len(t) // 50) for t in test)
        self.epochs = []  # 3 epochs' orders, each fold on its shuffle stream
        rngs = [np.random.default_rng(np.random.SeedSequence([324, f]))
                for f in range(1, FOLDS + 1)]
        for _ in range(3):
            self.epochs.append(stacked_orders(
                [t[r.permutation(len(t))] for t, r in zip(train, rngs)], 50, S,
                self.steps))
        self.order = self.epochs[0]
        self.test = stacked_orders(test, 50, S, self.t_steps)
        nb, w = block_fold_extents(ctx.engine._nb, ctx.engine._block_counts,
                                   np.concatenate([self.order, self.test]))
        self.nb, self.w = _geom_round(nb, 8), _geom_round(w, 64)
        counts = ctx.engine._block_counts
        self.items = (counts[np.maximum(self.order, 0)] * (self.order >= 0)).sum((1, 2))
        self.mean_step = int(np.argmin(np.abs(self.items - self.items.mean())))
        log(f"DD lockstep ({FOLDS} folds): {self.steps} train + {self.t_steps} test "
            f"steps an epoch; merged items a train step mean {self.items.mean():.1f} "
            f"(one fold's mean batch {ctx.row_items[ctx.mean_row]}), max "
            f"{self.items.max()}; budgets nb {self.nb} a fold (nb' = {FOLDS * self.nb} "
            f"block-rows merged), W {self.w}; mean step {self.mean_step} "
            f"({self.items[self.mean_step]} items)")

    def batch(self, step=None, w=None):
        """Step `step` of epoch 1 (the mean step by default) as a
        `FoldBlockBatch` on the card."""
        from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch_folds

        s = self.mean_step if step is None else step
        row = torch.from_numpy(self.order[s]).to(self.ctx.pool.device)
        return gather_block_batch_folds(self.ctx.engine.dev, row, self.nb, w or self.w)


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


def compare_block_bf16(name, b, nb, pool16, device, stats, widths=(32, 1)):
    """Both kernels' bf16 mode (bf16 pool and hb) against the plain
    version at each width: the forward and the transposed launch, each
    fp32 out, within the fp32 tolerance (the products of two bf16 values
    are exact, so only the order of the fp32 sums differs); two runs
    bitwise equal; through the autograd entry, the output is the forward
    launch's bits and d_hb is the transposed launch on the cotangent
    rounded to bf16, rounded to bf16 itself; the bf16 counts move."""
    from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain

    n_items = int(b.num_items)
    gen = torch.Generator(device=device).manual_seed(3 * nb + n_items)
    for f in widths:
        hb = torch.randn((nb, BS, f), generator=gen, device=device).bfloat16()
        g = torch.randn((nb, BS, f), generator=gen, device=device)
        g16 = g.bfloat16()
        for kname, (mod, fn) in block_kernels().items():
            items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
            plan = mod.make_plan(*items, nb)
            want = block_propagate_plain(hb, pool16, plan.fwd.ip, plan.fwd.seg,
                                         plan.fwd.src)
            want_t = block_propagate_plain(g16, pool16, plan.bwd.ip, plan.bwd.seg,
                                           plan.bwd.src, transpose=True)
            before = dict(vars(mod.launches))
            runs = [(mod._cuda_prop(hb, pool16, plan, plan.fwd, b.num_items, False),
                     mod._cuda_prop(g16, pool16, plan, plan.bwd, b.num_items, True))
                    for _ in range(2)]
            x = hb.clone().requires_grad_()
            out = fn(x, pool16, *items, b.num_items, plan)
            out.backward(g)
            ran = {key: v - before[key] for key, v in vars(mod.launches).items()}
            got, got_t = runs[0]
            err, rel, ok = rel_err(got, want)
            terr, trel, tok = rel_err(got_t, want_t)
            if not ok or not tok:
                raise AssertionError(
                    f"{name} bf16 F={f} {kname}: disagrees with the plain version "
                    f"(fwd abs {err:.3e} rel {rel:.3e}; transposed abs {terr:.3e} "
                    f"rel {trel:.3e})")
            if not all(torch.equal(a, c) for a, c in zip(runs[0], runs[1])):
                raise AssertionError(f"{name} bf16 F={f} {kname}: two runs differ")
            if (out.dtype != torch.float32 or not torch.equal(out.detach(), got)
                    or x.grad.dtype != torch.bfloat16
                    or not torch.equal(x.grad, got_t.bfloat16())):
                raise AssertionError(f"{name} bf16 F={f} {kname}: the autograd entry "
                                     f"is not the launches' bits")
            if ran["bf16_fwd"] != 3 or ran["bf16_bwd"] != 3:
                raise AssertionError(f"{name} bf16 F={f} {kname}: counts moved {ran}")
            stats[f"{kname}_bf16_fwd"] = max(stats.get(f"{kname}_bf16_fwd", 0.0), err)
            stats[f"{kname}_bf16_bwd"] = max(stats.get(f"{kname}_bf16_bwd", 0.0), terr)
            log(f"  {name} bf16 F={f} {kname}: fwd max abs {err:.3e} rel {rel:.3e}; "
                f"transposed max abs {terr:.3e} rel {trel:.3e}; two runs bitwise "
                f"equal; autograd entry = the launches' bits")
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


def check_lockstep_blocks(lctx, device, stats):
    """Phase 3b's lockstep case: both kernels on the 10-fold merged stream
    of DD's mean lockstep step (nb' = 10 × nb block-rows), 64 items of
    headroom, F ∈ {32, 1}, each design phase 5 times."""
    b = lctx.batch(w=lctx.w + 64)
    compare_block(f"DD {FOLDS}-fold merged mean step (step {lctx.mean_step}, "
                  f"{int(b.num_items)} items, nb' {FOLDS * lctx.nb})", b,
                  FOLDS * lctx.nb, lctx.ctx.pool, device, stats, variants=True)


def check_blocks_bf16(ctx, lctx, pool16, device, stats):
    """Phase 3b's bf16 cases (`compare_block_bf16`: both kernels, forward
    and transposed, F ∈ {32, 1}): DD's mean and largest batch and the
    10-fold merged mean lockstep step, with headroom (padded items and
    unvisited block-rows), over the pool rounded to bf16."""
    nb, w = ctx.nb + 8, ctx.w + 64
    for label, r in (("mean", ctx.mean_row), ("max", ctx.max_row)):
        compare_block_bf16(f"DD {label} batch (row {r}, {ctx.row_items[r]} items)",
                           ctx.batch(r, nb, w), nb, pool16, device, stats)
    b = lctx.batch(w=lctx.w + 64)
    compare_block_bf16(f"DD {FOLDS}-fold merged mean step ({int(b.num_items)} items, "
                       f"nb' {FOLDS * lctx.nb})", b, FOLDS * lctx.nb, pool16, device,
                       stats)


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
        row_ptr(seg, nb).long(), src[:n].long(), vals.float().contiguous(),
        size=(nb * BS, nb * BS),
    )
    x = hb.reshape(nb * BS, f).float()  # bf16 operands widen exactly: the same function
    return lambda: a @ x


def time_block(b, nb, pool, flush, device, variants=True):
    """Per kernel, design and F: warm and flushed device ms of the kernel
    on batch `b` of `nb` block-rows (its plan built outside the timed
    call), warm ms of the plain version and of the library call, and the
    bound; each kernel's plan build. A bf16 pool times the bf16 mode (hb
    in bf16, the bound at 2 bytes an element, the library call on the
    widened operands); `variants=False` times the wrapper's design only."""
    from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain

    n_items = int(b.num_items)
    items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
    gen = torch.Generator(device=device).manual_seed(7)
    rows = {}
    for kname, (mod, _) in block_kernels().items():
        rows[(kname, "plan")] = device_ms(lambda mod=mod: mod.make_plan(*items, nb))
        log(f"  {kname} plan build (once per batch): {rows[(kname, 'plan')]:.4f} ms")
    tplan = block_kernels()["block_csr"][0].make_plan(*items, nb).bwd
    for f in (32, 1):
        hb = torch.randn((nb, BS, f), generator=gen, device=device).to(pool.dtype)
        bnd = block_bounds(n_items, nb, f, es=pool.element_size())

        def plain_fwd():
            return block_propagate_plain(hb, pool, b.item_pool, b.item_row, b.item_col)

        def plain_bwd():
            return block_propagate_plain(hb, pool, tplan.ip, tplan.seg, tplan.src,
                                         transpose=True)

        plain = {"fwd": device_ms(plain_fwd), "bwd": device_ms(plain_bwd)}
        lib = {}
        for d, tr in (("fwd", False), ("bwd", True)):
            try:
                call = library_bsr(b, nb, pool, f, hb, tr)
                want = plain_bwd() if tr else plain_fwd()
                err, _, ok = rel_err(call().reshape(nb, BS, f), want)
                if not ok:
                    raise AssertionError(f"BSR product disagrees ({err:.3e})")
                lib[d] = events_ms(call)
            except (RuntimeError, AssertionError, NotImplementedError) as e:
                log(f"  library BSR {d} F={f}: {type(e).__name__}: {str(e)[:200]} → null")
                lib[d] = None
        for kname, (mod, _) in block_kernels().items():
            for label, size in block_variants(kname)[:None if variants else 1]:
                plan = variant_plan(mod, b, nb, size)
                for d, tr in (("fwd", False), ("bwd", True)):
                    dr = plan.bwd if tr else plan.fwd
                    fn = (lambda mod=mod, plan=plan, dr=dr, tr=tr:
                          mod._cuda_prop(hb, pool, plan, dr, b.num_items, tr))
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

    def __init__(self, b, seed, device, item_headroom=16, structure=None,
                 block_coo=True, dst_sorted=True):
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
                                dst_sorted=dst_sorted)
        self.e_real = int(self.order.row_ptr[-1])
        real = b.edge_mask.cpu().numpy() > 0
        w_r = self.w.cpu().numpy()[real]
        src_r, dst_r = self.src.cpu().numpy()[real], self.dst.cpu().numpy()[real]
        # rows of the input each direction reads: h at the sources, g at
        # the destinations
        self.rows_read = (len(np.unique(src_r)), len(np.unique(dst_r)))
        # the most 256-edge blocks one row's positions span, each direction
        self.spans = tuple(int((((rp[1:] - 1) // 256 - rp[:-1] // 256 + 1)
                                * (rp[1:] > rp[:-1])).max())
                           for rp in (self.order.row_ptr, self.order.row_ptrT))
        self.block_coo = block_coo
        if not block_coo:
            self.items, self.slots, self.longest_row = (0, 0), 0, 0
            return
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
        fns = {
            "spmm_rows": lambda h: spmm_pallas(self.src, self.dst, self.w, h, o),
            "spmm_edge_block": lambda h: spmm_pallas_mxu(self.src, self.dst, self.w, h, o),
        }
        if self.block_coo:
            fns["spmm_block_coo"] = lambda h: spmm_block_coo(self.structure, self.w_pad,
                                                            self.w_padT, h)
        return fns

    def launch(self, kname, x, transpose: bool, design=None):
        """One launch of an edge-stream kernel's wrapper over one direction of
        the order (`design`: the C entry's, default the current one)."""
        from dgcnn_tpu_torch.kernels import spmm_pallas as sp

        fn = {"spmm_rows": sp.cuda_rows, "spmm_edge_block": sp.cuda_edge_block}[kname]
        o, kw = self.order, {} if design is None else {"design": design}
        if transpose:
            return fn(o.row_ptrT, o.permT, self.src, self.dst, o.colT, self.w, x, True, **kw)
        return fn(o.row_ptr, o.perm, self.dst, self.src, o.col, self.w, x, False, **kw)

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
EARLIER = 1  # the C entries' earlier design (kernels/spmm_pallas.py EARLIER)
EARLIER_TIMED = ("spmm_rows", "spmm_edge_block")  # kernels with an earlier design


def compare_spmm(name, case, device, stats):
    """Every SpMM kernel vs the plain version on one batch, F ∈ SPMM_WIDTHS:
    forward; dh against autograd of the plain forward; two runs bitwise
    equal; rows with no edge (padding nodes included) exactly 0 both ways.
    The row and edge-block kernels forward and dh bitwise equal to their
    earlier designs (the C entries' `design` 1). The block-COO
    kernel, and its earlier A-build design (the probe's `abuild`, forward
    and transposed), also against `block_coo_plain` (cases that carry a
    block-pair structure)."""
    o = case.order
    empty = o.row_ptr[1:] == o.row_ptr[:-1]
    emptyT = o.row_ptrT[1:] == o.row_ptrT[:-1]
    gen = torch.Generator(device=device).manual_seed(case.n)
    for f in SPMM_WIDTHS:
        h = torch.randn((case.n, f), generator=gen, device=device)
        g = torch.randn((case.n, f), generator=gen, device=device)
        with torch.no_grad():
            want = case.plain(h)
            want_bc = ((case.block_plain(h, False), case.block_plain(g, True))
                       if case.block_coo else None)
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
            same = ""
            if kname in EARLIER_TIMED:
                with torch.no_grad():
                    old = (case.launch(kname, h, False, EARLIER),
                           case.launch(kname, g, True, EARLIER))
                if not (torch.equal(outs[0], old[0]) and torch.equal(grads[0], old[1])):
                    raise AssertionError(
                        f"{name} F={f} {kname}: not bitwise equal to its earlier design "
                        f"(fwd max abs {(outs[0] - old[0]).abs().max():.3e}, dh "
                        f"{(grads[0] - old[1]).abs().max():.3e})")
                same = "; fwd and dh bitwise equal to the earlier design"
            log(f"  {name} F={f} {kname}: fwd max abs {err:.3e} rel {rel:.3e}; dh vs "
                f"autograd of plain max abs {gerr:.3e} rel {grel:.3e}; two runs bitwise "
                f"equal; {int(empty.sum())} empty rows fwd, {int(emptyT.sum())} bwd, "
                f"exactly 0{same}")
        if not case.block_coo:
            continue
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


def edge_block_cases(device):
    """Two streams for the edge-block kernel's straddling and empty-row
    logic (unsorted, so both directions go through a sort): 4,096 nodes
    and 8,192 edges with one row of 900 in-edges from one source (a row
    over at least 3 blocks of 256 positions both ways) among random
    edges; and the same stream with every edge masked (no real edge:
    row_ptr[N] = 0)."""
    import types

    n, e, star = 4096, 8192, 900
    rng = np.random.default_rng(7)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    hub = rng.choice(e, star, replace=False)
    src[hub], dst[hub] = 1234, 2345
    cases = {}
    for label, mask in (("one row over >= 3 blocks", np.ones(e, np.float32)),
                        ("no real edge", np.zeros(e, np.float32))):
        b = types.SimpleNamespace(
            x=torch.zeros((n, 1), device=device), edge_src=torch.from_numpy(src).to(device),
            edge_dst=torch.from_numpy(dst).to(device),
            edge_mask=torch.from_numpy(mask).to(device))
        cases[label] = SpmmCase(b, seed=6, device=device, block_coo=False, dst_sorted=False)
    if min(cases["one row over >= 3 blocks"].spans) < 3 or cases["no real edge"].e_real:
        raise AssertionError("the edge-block cases lack their row over 3 blocks or "
                             "have a real edge")
    return cases


BLOCK_COO_TIMED = ("spmm_block_coo", "spmm_block_coo_abuild")


def time_spmm(case, flush, device, kernels=SPMM_KERNELS + ("spmm_block_coo_abuild",)):
    """Per kernel of `kernels` (an edge-stream kernel's earlier design as
    `<name>_earlier`), direction and F: warm and flushed device ms, the
    plain version's and the library call's ms, and the bound; the
    block-COO slot order's build time."""
    from dgcnn_tpu_torch.kernels.spmm_block_coo import _cuda_spmm, block_coo_order
    from dgcnn_tpu_torch.ops.spmm import spmm_plain

    s, bo = case.structure, case.bc_order
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
        for kname in EARLIER_TIMED:
            for suffix, design in (("", None), ("_earlier", EARLIER)):
                calls[kname + suffix] = (
                    lambda k=kname, d=design: case.launch(k, h, False, d),
                    lambda k=kname, d=design: case.launch(k, g, True, d))
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


SPMM_TIMED = SPMM_KERNELS + ("spmm_block_coo_abuild",) + tuple(
    k + "_earlier" for k in EARLIER_TIMED)


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


def lockstep_steps(data_type, y, folds_n, batch, data_dir):
    """(train, eval) lockstep steps of one epoch: the longest fold's."""
    from dgcnn_tpu_torch.data.folds import get_folds

    folds = get_folds(y, data_dir, folds_n, 324, data_type=data_type)
    return (max(-(-len(tr) // batch) for tr, _ in folds),
            max(-(-len(te) // batch) for _, te in folds))


def folds_net(model, device, seed=3):
    """A `DGCNNFoldsNet` of FOLDS folds' weights, fold f's from seed + f."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, init_params, stack_params

    return DGCNNFoldsNet(model, stack_params([
        init_params(torch.Generator().manual_seed(seed + f), model, device)
        for f in range(FOLDS)]))


def host_cpu():
    """The host CPU's model name as Linux reports it, and its architecture."""
    import platform

    name = "model name not reported"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() in ("model name", "Model", "Hardware", "vendor_id"):
                    name = value.strip()
                    if key.strip() == "model name":
                        break
    except OSError:
        pass
    return f"{name} ({platform.machine()})"


def fp32_matmul_error():
    """{device: max abs of a 512 x 512 fp32 product from its float64 value},
    on the card and on the CPU: whether either multiplies at reduced
    precision in this process."""
    a = torch.randn(512, 512, generator=torch.Generator().manual_seed(0))
    want = a.double() @ a.double()
    return {dev: f"{((a.to(dev) @ a.to(dev)).double().cpu() - want).abs().max().item():.3e}"
            for dev in ("cuda", "cpu")}


class _TorchWith:
    """`torch` with some functions replaced (`Branches.taken`)."""

    def __init__(self, **fns):
        self.__dict__.update(fns)

    def __getattr__(self, name):
        return getattr(torch, name)


def _inversion(v):
    """How far the sequence v breaks descending order: the largest
    v[j] − v[i] over i < j along the last axis (0 if it is sorted)."""
    lo = torch.cummin(v, dim=-1).values
    return torch.where(v == lo, torch.zeros_like(v), v - lo).max().item()


class Branches:
    """The branches one forward takes, so that a card-vs-CPU check holds
    both devices' gradients on the same ones. Autodiff of ReLU, of the
    max-pool's pairwise select and of SortPooling's order is piecewise:
    where a deciding value lies within rounding of its boundary (a ReLU
    input at 0, two equal pooled values, two equal sort keys), the card
    and the CPU, whose fp32 sums run in other orders, may take different
    branches, and a gradient then flows through another unit: the
    forward moves by the gap, the gradients by a unit's share. `record`
    (the card's run) notes each decision; `replay` (the CPU's) takes the
    card's, and raises unless every one the CPU's own values would make
    otherwise is a near-tie: its deciding values within `tol` of the
    boundary, `tol(t)` the tolerance the check holds a tensor t to. The
    decisions are the ReLUs of ops/readout.py and models/dgcnn.py, the
    max-pool select of ops/readout.py, `top_k_order` (the dense layout's
    per-slot order and the block layout's row-block prefilter) and the
    float sort of ops/sort_pool.py `sort_pool`."""

    def __init__(self, tol):
        self.tol = tol
        self.log = []
        self.at = 0
        self.mode = None
        self.inside = 0
        self.near = {}  # kind → [near-ties replayed, the worst gap over tol]

    @contextlib.contextmanager
    def taken(self, mode):
        import importlib

        ro = importlib.import_module("dgcnn_tpu_torch.ops.readout")
        md = importlib.import_module("dgcnn_tpu_torch.models.dgcnn")
        sp = importlib.import_module("dgcnn_tpu_torch.ops.sort_pool")
        saved = ro.torch, md.torch, sp.torch, sp.top_k_order
        top_k = sp.top_k_order
        self.mode, self.at = mode, 0
        ro.torch = _TorchWith(relu=self.relu, where=self.select)
        md.torch = _TorchWith(relu=self.relu)
        sp.torch = _TorchWith(sort=self.sort)
        sp.top_k_order = lambda key, k: self.top_k(top_k, key, k)
        try:
            yield self
            if mode == "replay" and self.at != len(self.log):
                raise AssertionError(f"the CPU took {self.at} decisions, the card "
                                     f"{len(self.log)}")
        finally:
            ro.torch, md.torch, sp.torch, sp.top_k_order = saved

    def _take(self, kind, own):
        if self.mode == "record":
            self.log.append((kind, own))
            return own
        if self.at >= len(self.log) or self.log[self.at][0] != kind or \
                self.log[self.at][1].shape != own.shape:
            raise AssertionError(f"decision {self.at} ({kind}, {tuple(own.shape)}) is "
                                 f"not the card's")
        self.at += 1
        return self.log[self.at - 1][1].cpu()

    def _near(self, kind, n, gap, t):
        """n decisions of `kind` differ from the CPU's own, the worst `gap`
        from its boundary, against the tolerance t."""
        if n and gap > t:
            raise AssertionError(f"{kind}: the card decides {n} cases otherwise than "
                                 f"the CPU, one {gap:.3e} from its boundary, over the "
                                 f"tolerance {t:.3e}")
        seen = self.near.setdefault(kind, [0, 0.0])
        seen[0] += n
        seen[1] = max(seen[1], gap / t if n else 0.0)

    def relu(self, x):
        m = self._take("ReLU", x > 0)
        if self.mode == "record":
            return torch.relu(x)
        off = m != (x > 0)
        n = int(off.sum())
        self._near("ReLU", n, x[off].abs().max().item() if n else 0.0, self.tol(x))
        return torch.where(m, x, torch.zeros_like(x))

    def select(self, c, a, b):  # readout's max-pool: where(h0 >= h1, h0, h1)
        m = self._take("max-pool", c)
        if self.mode == "record":
            return torch.where(c, a, b)
        off = m != c
        n = int(off.sum())
        self._near("max-pool", n, (a - b)[off].abs().max().item() if n else 0.0,
                   self.tol(torch.maximum(a.abs(), b.abs())))
        return torch.where(m, a, b)

    def top_k(self, top_k, key, k):
        self.inside += 1  # its sorts are its own decision
        try:
            vals, idx = top_k(key, k)
        finally:
            self.inside -= 1
        forced = self._take("sort-pool top-k", idx)
        if self.mode == "record":
            return vals, idx
        v = torch.gather(key, 1, forced)
        n = int((forced != idx).any(dim=1).sum())
        gap = 0.0
        if n:  # the forced rows out of order, or a key left out above them
            rest = key.scatter(1, forced, float("-inf")).max(dim=1).values
            last = v[:, -1]
            over = torch.where(rest == last, torch.zeros_like(last), rest - last)
            gap = max(_inversion(v), over.max().item(), 0.0)
        fin = key[torch.isfinite(key)]
        self._near("sort-pool top-k", n, gap, self.tol(fin))
        return v, forced

    def sort(self, x, *args, **kw):
        out = torch.sort(x, *args, **kw)
        if self.inside or not x.is_floating_point():
            return out
        if x.dim() != 1 or not kw.get("descending"):
            raise AssertionError("sort_pool's key sort is one descending axis")
        forced = self._take("sort-pool order", out.indices)
        if self.mode == "record":
            return out
        v = x[forced]
        n = int((forced != out.indices).sum())
        self._near("sort-pool order", n, _inversion(v) if n else 0.0,
                   self.tol(x[torch.isfinite(x)]))
        return torch.return_types.sort((v, forced))

    def summary(self):
        return ", ".join(f"{kind} {n} (worst {w:.3g} of the tolerance)"
                         for kind, (n, w) in self.near.items() if n) or "none"


def card_vs_cpu(name, make_batch, model, folds=False, rtol=None):
    """log-probs and every parameter gradient of one batch on the card and
    on the CPU, the same weights, the CPU on the card's branches
    (`Branches`); returns the worst relative error. `folds`: a lockstep
    batch of FOLDS folds through `DGCNNFoldsNet`, the sum of the per-fold
    losses backpropagated. `rtol` (bf16 runs) holds each tensor within
    rtol of its largest value instead of the fp32 tolerance: both sides
    round to bf16 at the same points, from fp32 sums taken in other
    orders."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.tools.probe_repeat import digest
    from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

    def err_of(got, want):
        return rel_err(got, want) if rtol is None else bf16_err(got, want, rtol)

    def tol(t):
        t = t.detach().cpu()
        scale = t.double().abs().max().item() if t.numel() else 0.0
        return ATOL + RTOL * scale if rtol is None else 1e-6 + rtol * scale

    branches = Branches(tol)

    def run(dev, mode):
        b, kw = make_batch(dev)
        net = folds_net(model, dev) if folds else DGCNNNet(
            model, init_params(torch.Generator().manual_seed(3), model, dev))
        with branches.taken(mode) if mode else contextlib.nullcontext():
            lp = net(b, **kw)
        if folds:
            loss, _ = nll_loss_and_correct(lp, b.y.view(FOLDS, -1),
                                           b.graph_mask.view(FOLDS, -1))
            loss = loss.sum()
        else:
            loss, _ = nll_loss_and_correct(lp, b.y, b.graph_mask)
        loss.backward()
        return [("log_probs", lp.detach())] + [(n, p.grad.cpu())
                                               for n, p in net.named_parameters()]

    card = run("cuda", "record")
    cpu = run("cpu", "replay")
    worst, worst_at = 0.0, None
    for (what, a), (_, c) in zip(card, cpu):
        err, rel, ok = err_of(a.cpu(), c)
        if worst_at is None or rel > worst:
            worst, worst_at = rel, what
        if not ok or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: card vs CPU disagree on {what} (max abs "
                                 f"{err:.3e}, its largest value {c.abs().max().item():.3e})")
    # what the check saw before it replayed the card's branches (reported only)
    cpu_own = run("cpu", None)
    own = [(what, *err_of(a.cpu(), c)) for (what, a), (_, c) in zip(card, cpu_own)]
    own_worst = max(own, key=lambda e: e[2])
    beyond = [what for what, _, _, ok in own if not ok]
    log(f"  {name}: log_probs and {len(cpu) - 1} parameter gradients agree on the "
        f"card's branches, worst rel {worst:.3e} ({worst_at}); near-ties the CPU would "
        f"have branched otherwise: {branches.summary()}; on its own branches the CPU "
        f"is at worst rel {own_worst[2]:.3e} ({own_worst[0]}), beyond the tolerance in "
        f"{beyond or 'no tensor'}; bits (tools/probe_repeat.py digest) card "
        f"{digest([(n, t.cpu()) for n, t in card])}, CPU {digest(cpu_own)}")
    return worst


def check_lockstep_dropout(model, parts, device):
    """On the card, each fold's dropout mask in one lockstep forward is
    bitwise the mask the sequential forward draws from the same seed."""
    from dgcnn_tpu_torch.batching.dense import batch_to_device
    from dgcnn_tpu_torch.models.dgcnn import apply_dense
    from dgcnn_tpu_torch.parity.convert import state_to_params

    net_f = folds_net(model, device)
    gens = [torch.Generator(device=device).manual_seed(50 + f) for f in range(FOLDS)]
    _, acts = net_f(batch_to_device(stack_batches(parts), device), deterministic=False,
                    dropout_gens=gens, return_activations=True)
    for f, part in enumerate(parts):
        gen = torch.Generator(device=device).manual_seed(50 + f)
        _, one = apply_dense(state_to_params(net_f.fold_state_dict(f)), model,
                             batch_to_device(part, device), deterministic=False,
                             dropout_gen=gen, return_activations=True)
        if not torch.equal(acts["dropout_keep"][f], one["dropout_keep"]):
            raise AssertionError(f"fold {f + 1}: lockstep dropout mask differs")
        if not torch.equal(gens[f].get_state(), gen.get_state()):
            raise AssertionError(f"fold {f + 1}: generator states differ")
    log(f"  lockstep dropout: {FOLDS} folds' masks bitwise the sequential ones, "
        f"generators in the same state")


def cv_config(tmp, sub, data_type, folds_n, epochs, **kw):
    """A run of `folds_n` folds x `epochs` epochs at batch 50, its
    artifacts under tmp/sub."""
    from dgcnn_tpu_torch.config import Config

    return Config(data_type=data_type, num_folds=folds_n, num_epochs=epochs,
                  batch_size=50, data_root=os.path.join(tmp, "data"),
                  statistics_dir=os.path.join(tmp, sub, "statistics"),
                  epochs_dir=os.path.join(tmp, sub, "epochs"), **kw)


PEAK_MIB = {}  # a run's statistics_dir → its peak memory above what was allocated before
# the graphed runs phase 4h resumes against: name → a copy of the run's
# artifacts (its config, statistics_dir and epochs_dir in the copy)
KEPT = {}


def keep_run(name, cfg):
    """Copy a finished run's artifacts out of its phase's temporary
    directory (phase 4h's reference); removed when the script exits."""
    if not KEPT:
        root = tempfile.mkdtemp(prefix="chip_smoke_kept_")
        atexit.register(shutil.rmtree, root, True)
        KEPT[None] = root
    dst = os.path.join(KEPT[None], name.replace(" ", "_"))
    shutil.copytree(cfg.statistics_dir, os.path.join(dst, "statistics"))
    shutil.copytree(cfg.epochs_dir, os.path.join(dst, "epochs"))
    KEPT[name] = dataclasses.replace(cfg, statistics_dir=os.path.join(dst, "statistics"),
                                     epochs_dir=os.path.join(dst, "epochs"))
# synthetic datasets the contexts have already made (the loader's own:
# `synthesize_tu_dataset(name)`), handed to the runs so that each does not
# synthesize its dataset again (COLLAB's takes ~7 s)
SYNTH = {}


def run_cv(cfg, graphs):
    """`run_cross_validation` on the card (`graphs=False`: every epoch
    eager), on the dataset in `SYNTH` or else the one the loader
    synthesizes; (result, wall seconds). Records the run's peak memory
    (engine, data and runners included) in `PEAK_MIB`."""
    from dgcnn_tpu_torch.train.cv import run_cross_validation

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run_cross_validation(cfg, dataset=SYNTH.get(cfg.data_type),
                                  allow_synthetic=True, graphs=graphs)
    torch.cuda.synchronize()
    PEAK_MIB[cfg.statistics_dir] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return result, time.perf_counter() - t0


def fold_rows(cfg):
    """Every fold's CSV rows [epochs, 5] as the run wrote them."""
    return [np.loadtxt(os.path.join(cfg.statistics_dir,
                                    f"{cfg.data_type}_results_{f}.csv"),
                       delimiter=",", skiprows=1, ndmin=2)
            for f in range(1, cfg.num_folds + 1)]


def epoch_events(cfg):
    with open(os.path.join(cfg.statistics_dir, f"{cfg.data_type}_events.jsonl")) as fh:
        return [e for e in map(json.loads, fh) if e["kind"] == "epoch"]


def same_bits(name, got, want):
    """Raise unless every array of `got` is bitwise `want`'s."""
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = np.abs(a - b).max() if a.shape == b.shape else "shape"
            raise AssertionError(f"{name}: item {i} differs (max abs {diff})")


def counted_run(cfg, graphs, dt, want):
    """`run_cv` with the trunk's counts set to 0 just before and read just
    after; raises unless they are `want` (fwd, bwd), all resident, each
    call one kernel launch. Returns (result, wall seconds, (fwd, bwd)
    kernel launches)."""
    dt.launches.reset()
    result, wall = run_cv(cfg, graphs)
    got = (dt.launches.fwd_launches, dt.launches.bwd_launches)
    kern = (dt.launches.kernel_fwd, dt.launches.kernel_bwd)
    by_regime = (dt.launches.resident_fwd, dt.launches.resident_bwd,
                 dt.launches.streamed_fwd, dt.launches.streamed_bwd)
    log(f"  {cfg.data_type} {cfg.cv_parallel} {cfg.num_folds} x {cfg.num_epochs}, "
        f"max_fused_epochs {cfg.max_fused_epochs}, {'graphed' if graphs else 'eager'}: "
        f"{wall:.1f} s; trunk calls {got} (want {want}), by regime (resident fwd, "
        f"bwd, streamed fwd, bwd) {by_regime}")
    if got != want or by_regime != (*want, 0, 0) or kern != want:
        raise AssertionError(f"trunk launches {got} {by_regime}, kernels {kern}, "
                             f"expected {want} all resident")
    return result, wall, kern


def graphed_vs_eager(tmp, label, data_type, folds_n, epochs, dt, want, **kw):
    """One run graphed (launches counted) and one eager, each fold's rows
    bitwise equal; returns (graphed cfg, trunk launches, graphed and
    eager epoch events)."""
    cfg = cv_config(tmp, label, data_type, folds_n, epochs, **kw)
    eager = cv_config(tmp, label + "_eager", data_type, folds_n, epochs, **kw)
    _, _, launches = counted_run(cfg, True, dt, want)
    run_cv(eager, False)
    same_bits(f"{label}: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
    log(f"  {label}: every fold's rows of every epoch bitwise equal, graphed and eager")
    return cfg, launches, epoch_events(cfg), epoch_events(eager)


def chunk_seconds(events, per):
    """Each epoch's `epoch_seconds` (the first fold's event) over `per`."""
    first = min(e["fold"] for e in events)
    return [e["epoch_seconds"] / per for e in events if e["fold"] == first]


def lockstep_main_path(nci1, t_main, dt):
    """Phase 4a: synthetic NCI1 (layout auto → dense, cv_parallel auto →
    lockstep) for FOLDS folds x 4 epochs in chunks of max_fused_epochs 2,
    graphed (trunk launches counted exactly per replay, all resident,
    every event `chunk_epochs` 2) and eager, rows bitwise equal; the
    sequential driver on the same folds, 10 x 2 graphed and eager, rows
    bitwise equal and epoch 1 within rtol/atol 5e-4 of lockstep's;
    synthetic PROTEINS lockstep (T=176, C=2), 10 x 2, graphed and eager."""
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data", "NCI1", "10fold_idx")
        steps_max, t_steps_max = lockstep_steps("NCI1", nci1.y, FOLDS, 50, data_dir)
        log(f"NCI1 lockstep steps an epoch: train {steps_max}, eval {t_steps_max}; "
            f"plan at S={SL} T={t_main}: {dt.trunk_plan(SL, t_main, DIMS)}")
        cfg, trunk_n, ev, ev_eager = graphed_vs_eager(
            tmp, "lockstep", "NCI1", FOLDS, 4, dt,
            (4 * (steps_max + t_steps_max), 4 * steps_max), max_fused_epochs=2)
        keep_run("NCI1 lockstep", cfg)
        result = {"train_accuracies": [r[-1, 3] for r in fold_rows(cfg)],
                  "test_accuracies": [r[-1, 4] for r in fold_rows(cfg)]}
        events = check_artifacts(os.path.join(tmp, "lockstep"), "NCI1", FOLDS, 4)
        epochs = [e for e in events if e["kind"] == "epoch"]
        if events[0]["kind"] != "run_start" or events[0]["layout"] != "dense":
            raise AssertionError(f"run_start says {events[0]}")
        if [(e["epoch"], e["fold"]) for e in epochs] != [
                (ep, f) for ep in (1, 2, 3, 4) for f in range(1, FOLDS + 1)] or any(
                e.get("folds_in_lockstep") != FOLDS or e["chunk_epochs"] != 2
                for e in epochs):
            raise AssertionError("the epoch events are not a chunked lockstep run's")
        lock_s, lock_eager_s = chunk_seconds(ev, FOLDS), chunk_seconds(ev_eager, FOLDS)
        log(f"  every epoch event: folds_in_lockstep {FOLDS}, chunk_epochs 2; "
            f"fold-epoch seconds (epoch seconds / {FOLDS}) graphed {lock_s} (chunk 1 "
            f"holds the warm-up and the capture) vs eager {lock_eager_s}")
        log(f"accuracies: train {result['train_accuracies']} "
            f"test {result['test_accuracies']}")

        tr_n, ev_n = count_steps("NCI1", nci1.y, FOLDS, 2, 50, data_dir)
        seq, seq_n, seq_ev, seq_eager_ev = graphed_vs_eager(
            tmp, "sequential", "NCI1", FOLDS, 2, dt, (tr_n + ev_n, tr_n),
            cv_parallel="sequential", max_fused_epochs=1)
        worst = 0.0
        for f, (lock, one) in enumerate(zip(fold_rows(cfg), fold_rows(seq)), start=1):
            if not np.allclose(lock[0], one[0], rtol=5e-4, atol=5e-4):
                raise AssertionError(f"fold {f}: lockstep epoch 1 {lock[0]} vs "
                                     f"sequential {one[0]}")
            worst = max(worst, float(np.abs(lock[0] - one[0]).max()))
        seq_s = [e["epoch_seconds"] for e in seq_ev]
        seq_eager_s = [e["epoch_seconds"] for e in seq_eager_ev]
        log(f"  sequential: every fold's epoch-1 row within rtol/atol 5e-4 of "
            f"lockstep's (worst abs {worst:.3e}); fold-epoch seconds, epoch 2 (a "
            f"replay) median graphed {np.median(seq_s[1::2]):.4f} vs eager "
            f"{np.median(seq_eager_s[1::2]):.4f}; epoch 1 (warm-up + capture) "
            f"median {np.median(seq_s[::2]):.4f}")

        from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset

        proteins = synthesize_tu_dataset("PROTEINS")
        p_steps, p_t_steps = lockstep_steps(
            "PROTEINS", proteins.y, FOLDS, 50,
            os.path.join(tmp, "data", "PROTEINS", "10fold_idx"))
        _, _, p_ev, p_eager_ev = graphed_vs_eager(
            tmp, "proteins", "PROTEINS", FOLDS, 2, dt,
            (2 * (p_steps + p_t_steps), 2 * p_steps), max_fused_epochs=1)
        log(f"  PROTEINS lockstep (T=176, resident C=2 inside the graph): fold-epoch "
            f"seconds graphed {chunk_seconds(p_ev, FOLDS)} vs eager "
            f"{chunk_seconds(p_eager_ev, FOLDS)}")

    return {"trunk_launches": trunk_n, "lockstep_epoch_s": lock_s,
            "lockstep_eager_epoch_s": lock_eager_s, "sequential_epoch_s": seq_s,
            "sequential_eager_epoch_s": seq_eager_s,
            "steps": (steps_max, t_steps_max), "peak_mib": PEAK_MIB[cfg.statistics_dir]}


def epoch_runners(gs, model, n_tile, device, graphs, data=None):
    """The fused runners as the drivers build them, the drivers' seeds:
    synthetic NCI1's FOLDS-fold lockstep runner and fold 1's one-fold
    runner, each with its first 3 epochs' orders and a `state()` of what
    an epoch updates (parameters, optimizer state, generator states), over
    `data` (the fp32 dense dataset when None)."""
    from dgcnn_tpu_torch.batching.dense import build_dense_dataset, order_matrix
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, init_params, stack_params
    from dgcnn_tpu_torch.train.cv import _stream_seed
    from dgcnn_tpu_torch.train.cv_vmap import fold_pattern, stacked_orders
    from dgcnn_tpu_torch.train.loop import (FoldAdam, make_dense_gather_run,
                                            make_dense_lockstep_run)

    data = build_dense_dataset(gs, n_tile, device) if data is None else data
    folds = get_folds(gs.y, "", FOLDS, 324, data_type="NCI1")
    train = [np.asarray(tr, np.int32) for tr, _ in folds]
    test = [np.asarray(te, np.int32) for _, te in folds]
    steps = max(-(-len(t) // 50) for t in train)
    t_steps = max(-(-len(t) // 50) for t in test)
    rngs = [np.random.default_rng(np.random.SeedSequence([324, f]))
            for f in range(1, FOLDS + 1)]
    orders = np.stack([stacked_orders([t[r.permutation(len(t))] for t, r in zip(train, rngs)],
                                      50, S, steps) for _ in range(3)])
    net_f = DGCNNFoldsNet(model, stack_params([
        init_params(torch.Generator().manual_seed(_stream_seed(324, f, 1)), model, device)
        for f in range(1, FOLDS + 1)]))
    adam_f = FoldAdam(net_f)
    gens = [torch.Generator(device=device).manual_seed(_stream_seed(324, f, 2))
            for f in range(1, FOLDS + 1)]
    lock = make_dense_lockstep_run(
        net_f, adam_f, data, stacked_orders(test, 50, S, t_steps),
        fold_pattern([len(t) for t in train], 50, steps), gens, graphs)

    net, opt, gen = fold_seeds(model, device)
    rng = np.random.default_rng(np.random.SeedSequence([324, 1]))
    one_orders = np.stack([order_matrix(train[0][rng.permutation(len(train[0]))], 50, S)
                           for _ in range(3)])
    one = make_dense_gather_run(net, opt, data, order_matrix(test[0], 50, S),
                                one_orders.shape[1], gen, graphs)

    def lock_state():
        return [net_f.flat, adam_f.exp_avg, adam_f.exp_avg_sq, adam_f.steps,
                *(g.get_state() for g in gens)]

    return {"lockstep": (lock, orders, lock_state, steps + t_steps),
            "one fold": (one, one_orders, seq_state(net, opt, gen),
                         one_orders.shape[1] + -(-len(test[0]) // 50))}


def new_stream_workspace(device):
    """Log what a first matmul on a new stream allocates (cuBLAS's
    workspace): the part of a runner's memory that is not its graph's."""
    side, a = torch.cuda.Stream(), torch.ones(64, 64, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.cuda.stream(side):
        a @ a
    torch.cuda.synchronize()
    log(f"  a first matmul on a new stream allocates "
        f"{(torch.cuda.memory_allocated() - base) / 2**20:.1f} MiB (its cuBLAS workspace)")


def check_runners(build):
    """The runners `build(graphs)` gives (name → (runner, 3 epochs' orders,
    `state()`, steps an epoch)), eager and graphed: one eager epoch of each
    body under `set_sync_debug_mode("error")` (no host sync in it), then 3
    epochs eager against 3 graphed (warm-up, capture, 2 replays) from the
    same seeds: rows, parameters, optimizer state and dropout generators'
    states bitwise equal; the peak memory of each above what was allocated
    before. Returns the graphed runners for phase 6."""
    eager = build(False)
    graphed = build(True)
    out = {}
    for name, (run_e, orders, state_e, steps) in eager.items():
        run_g, _, state_g, _ = graphed[name]
        run_e.order.copy_(torch.from_numpy(orders[0]).to(run_e.order.device))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_e.body()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        first = run_e.rows.cpu().double().numpy()
        log(f"  {name}: one eager epoch of the body ran under "
            f"set_sync_debug_mode('error'): no host sync")
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows_e = np.concatenate([first[None], run_e.run_epochs(orders[1:])])
        peak_e_abs = torch.cuda.max_memory_allocated()
        peak_e = peak_e_abs - base
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows_g = run_g.run_epochs(orders)
        torch.cuda.synchronize()
        if run_g.graph is None:
            raise AssertionError(f"{name} runner: no graph was captured")
        peak_g = torch.cuda.max_memory_allocated() - base
        held_g = torch.cuda.memory_allocated() - base
        same_bits(f"{name} runner: graphed vs eager rows", [rows_g], [rows_e])
        same_bits(f"{name} runner: graphed vs eager state",
                  [t.detach().cpu().numpy() for t in state_g()],
                  [t.detach().cpu().numpy() for t in state_e()])
        log(f"  {name} runner: 3 epochs graphed (warm-up, capture {run_g.capture_seconds:.3f} s, "
            f"2 replays) bitwise the eager epochs: rows, parameters, optimizer state, "
            f"generator states; peak memory over the epochs above what was allocated: "
            f"eager {peak_e / 2**20:.1f} MiB, graphed {peak_g / 2**20:.1f} MiB "
            f"(held after: {held_g / 2**20:.1f} MiB: the graph's pool, the state and "
            f"what the runner's stream allocated); torch.cuda.max_memory_allocated "
            f"eager {peak_e_abs / 2**20:.1f} MiB, graphed "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        out[name] = {"runner": run_g, "orders": orders, "steps": steps,
                     "capture_s": run_g.capture_seconds, "peak_eager_mib": peak_e / 2**20,
                     "peak_graphed_mib": peak_g / 2**20}
    return out


# -- phases 4b and 4c: the block and COO layouts' fused runners -------------


def bundles(cfg):
    """Every fold's `epochs/` bundle (parameters and Adam's state) as the
    run wrote it, one array a key."""
    out = []
    for f in range(1, cfg.num_folds + 1):
        with np.load(os.path.join(cfg.epochs_dir, f"{cfg.data_type}_{f}.npz")) as z:
            out.extend(z[k] for k in sorted(z.files))
    return out


def sparse_graphed_vs_eager(tmp, label, data_type, gs, folds_n, epochs, counters,
                            used, want_layout, keep=None, **kw):
    """`run_cross_validation` of synthetic `data_type` on the card in
    chunks of `max_fused_epochs` 2, graphed with every kernel's counts set
    to 0 just before and read just after, then eager (`graphs=False`):
    launches exactly 4 × (train + eval steps) forward and 4 × train steps
    backward on `used` (a quarter of each of width 1), 0 on the others,
    counted per replay; every fold's rows and `epochs/` bundle (parameters,
    optimizer state) bitwise equal; `keep` names the graphed run for phase
    4h (`keep_run`). Returns (launches of `used` (fwd, bwd), of width 1,
    graphed and eager epoch events, every fold's rows)."""
    cfg = cv_config(tmp, label, data_type, folds_n, epochs, max_fused_epochs=2, **kw)
    eager = cv_config(tmp, label + "_eager", data_type, folds_n, epochs,
                      max_fused_epochs=2, **kw)
    for c in counters.values():
        c.reset()
    _, wall = run_cv(cfg, True)
    counts = {k: (c.fwd_launches, c.bwd_launches) for k, c in counters.items()}
    f1 = (counters[used].f1_fwd, counters[used].f1_bwd)
    tr_n, ev_n = count_steps(data_type, gs.y, folds_n, epochs, 50,
                             os.path.join(tmp, "data", data_type, "10fold_idx"))
    log(f"{label}: {data_type} {folds_n} x {epochs}, chunks of 2, graphed: {wall:.1f} s; "
        f"train steps {tr_n}, eval steps {ev_n}; launches (fwd, bwd) {counts}, of "
        f"width 1 on {used} {f1}")
    want = {k: (4 * (tr_n + ev_n), 4 * tr_n) if k == used else (0, 0) for k in counters}
    if counts != want or f1 != (tr_n + ev_n, tr_n):
        raise AssertionError(f"{label}: launch counts {counts} (F=1 {f1}), expected "
                             f"{want}, a quarter of width 1")
    if keep:
        keep_run(keep, cfg)
    _, wall_e = run_cv(eager, False)
    same_bits(f"{label}: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
    same_bits(f"{label}: graphed vs eager epochs/ bundles", bundles(cfg), bundles(eager))
    events = check_artifacts(os.path.join(tmp, label), data_type, folds_n, epochs)
    start = events[0]
    impl_key = "block_impl" if want_layout == "block" else "spmm_impl"
    if start["kind"] != "run_start" or start["layout"] != want_layout:
        raise AssertionError(f"run_start says {start}")
    ev, ev_e = epoch_events(cfg), epoch_events(eager)
    chunk2 = [(e["fold"], e["epoch_seconds"]) for e in ev if e["epoch"] > 2]
    chunk2_e = [(e["fold"], e["epoch_seconds"]) for e in ev_e if e["epoch"] > 2]
    log(f"  {label}: run_start layout {start['layout']}, {impl_key} {start[impl_key]}; "
        f"eager run {wall_e:.1f} s; every fold's rows and epochs/ bundle bitwise "
        f"equal, graphed and eager; fold-epoch seconds (fold, s) of chunk 2 and "
        f"after: graphed {chunk2} vs eager {chunk2_e}; chunk 1 (warm-up + "
        f"capture): graphed {[e['epoch_seconds'] for e in ev if e['epoch'] <= 2]} vs "
        f"eager {[e['epoch_seconds'] for e in ev_e if e['epoch'] <= 2]}")
    return counts[used], f1, ev, ev_e, fold_rows(cfg)


def fold_seeds(model, device):
    """Fold 1's net, optimizer and dropout generator from `run_fold`'s
    seeds (seed 324)."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.train.cv import _stream_seed
    from dgcnn_tpu_torch.train.loop import make_optimizer

    net = DGCNNNet(model, init_params(
        torch.Generator().manual_seed(_stream_seed(324, 1, 1)), model, device))
    gen = torch.Generator(device=device).manual_seed(_stream_seed(324, 1, 2))
    return net, make_optimizer(net), gen


def seq_state(net, opt, gen):
    """What an epoch updates: parameters, optimizer state, generator state."""
    return lambda: [*net.parameters(), *(st[k] for st in opt.state.values()
                                         for k in ("step", "exp_avg", "exp_avg_sq")),
                    gen.get_state()]


def dd_fold_orders(gs, slots, epochs=3, data_type="DD"):
    """Fold 1 of synthetic `data_type` (2 folds, seed 324): its first
    `epochs` epochs' orders as `run_fold` shuffles them, and its test
    order."""
    from dgcnn_tpu_torch.batching.dense import order_matrix
    from dgcnn_tpu_torch.data.folds import get_folds

    tr, te = get_folds(gs.y, "", 2, 324, data_type=data_type)[0]
    tr = np.asarray(tr, np.int32)
    rng = np.random.default_rng(np.random.SeedSequence([324, 1]))
    orders = np.stack([order_matrix(tr[rng.permutation(len(tr))], 50, slots)
                       for _ in range(epochs)])
    return (tr, np.asarray(te, np.int32)), orders, order_matrix(te, 50, slots)


def sparse_runners(ctx, dd_coo, model, device, graphs, impls=None):
    """The fused runners of fold 1 of synthetic DD as the engines build
    them, at the budgets of its first 3 epochs: the block layout's
    (`make_block_run`, block_impl auto unless `impls` says) and the
    device-assembled COO layout's (`make_device_coo_run`, spmm auto), each
    with the 3 orders and a `state()`."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.train.loop import make_block_run, make_device_coo_run

    block_impl, spmm_impl = impls or (Config().resolved_block_impl(),
                                      Config().resolved_spmm_impl())
    _, orders, test = dd_fold_orders(ctx.gs, S)
    steps = orders.shape[1] + test.shape[0]
    nb, w = ctx.engine.budget_for(orders, test)
    bucket = dd_coo.engine.bucket_for(orders, test)
    net, opt, gen = fold_seeds(model, device)
    block = make_block_run(net, opt, ctx.engine.dev, test, nb, w, orders.shape[1], gen,
                           block_impl, graphs)
    out = {f"DD block ({block_impl})": (block, orders, seq_state(net, opt, gen), steps)}
    net, opt, gen = fold_seeds(model, device)
    coo = make_device_coo_run(net, opt, dd_coo.engine.dev, test, bucket, orders.shape[1],
                              gen, spmm_impl, graphs)
    out[f"DD COO ({spmm_impl})"] = (coo, orders, seq_state(net, opt, gen), steps)
    return out


def check_sync_only(ctx, dd_coo, nci1, model, nci1_model, device, impls):
    """One eager epoch of the bodies `check_runners` does not build under
    `set_sync_debug_mode("error")`: the other block kernel, the other
    device-assembled SpMM kernel, and NCI1 `--spmm pallas` (`CooEngine`:
    its first sub-chunk run once to stage a packed epoch, then the body
    alone with epoch 0 staged again)."""
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.train.cv import CooEngine

    order = torch.from_numpy(dd_fold_orders(ctx.gs, S)[1][0]).to(device)
    bodies = [(name, r, lambda r=r: r.order.copy_(order)) for name, (r, _, _, _) in
              sparse_runners(ctx, dd_coo, model, device, False, impls).items()]
    cfg = Config(data_type="NCI1", batch_size=50, layout="coo", spmm_impl="pallas")
    engine = CooEngine(cfg, nci1, device, graphs=False)
    tr, te = get_folds(nci1.y, "", 2, 324, data_type="NCI1")[0]
    engine.begin_fold(tr, te)
    net, opt, gen = fold_seeds(nci1_model, device)
    engine.run_epochs(net, opt, gen, np.stack([np.arange(len(tr))]))
    host = engine.runners.runner
    bodies.append(("NCI1 COO (pallas, CooEngine)", host, lambda: host.stage(0)))
    for name, r, prepare in bodies:
        prepare()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            r.body()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not torch.isfinite(r.rows).all():
            raise AssertionError(f"{name}: non-finite rows {r.rows}")
        log(f"  {name}: one eager epoch of the body ran under "
            f"set_sync_debug_mode('error'): no host sync")
    engine.end_fold()


def forced_growth(label, engine, gs, floors, sizes, model, device, counters,
                  data_type="DD"):
    """`engine` (a block, device-COO or multi-tile engine on the card, over
    synthetic `data_type` `gs`) on fold 1, graphed and then eager from the
    same seeds and from the budget floors `floors` (attribute → a new
    engine's value): chunk 1 (2 epochs) and chunk 2 (1 epoch, the same
    batches) at one budget, chunk 3 with the fold's largest graphs by
    `sizes` (per graph of `gs`, what drives the budget: stored blocks,
    edges or nodes) in its first batch. The budget grows at chunk
    3 and only there; chunk 2 replays chunk 1's runner; chunk 3 drops it
    (its CUDA graph destroyed, the memory it held freed) and builds
    exactly one new runner, which captures once; rows, parameters,
    optimizer state, generator state and every kernel's launch counts
    equal, graphed and eager."""
    (tr, te), _, _ = dd_fold_orders(gs, S, 1, data_type)
    sizes = np.asarray(sizes)[tr]
    rng = np.random.default_rng(7)
    p1 = np.stack([rng.permutation(len(tr)) for _ in range(2)])
    chunks = [p1, p1[:1], np.stack([np.argsort(-sizes, kind="stable"), p1[0]])]
    slot = engine.runners
    saved = {f: getattr(engine, f) for f in floors}
    got = {}
    for graphs in (True, False):
        for f, v in floors.items():
            setattr(engine, f, v)
        engine.graphs = graphs
        engine.begin_fold(tr, te)
        net, opt, gen = fold_seeds(model, device)
        made, drops, keys = [], [], []
        real_get, real_drop = slot.get, slot.drop

        def get(key, make):
            return real_get(key, lambda: made.append(key) or make())

        def drop():
            old = slot.runner
            torch.cuda.synchronize()
            before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
            ref = (weakref.ref(old.graph.graph)
                   if old is not None and old.graph is not None else None)
            del old
            real_drop()
            gc.collect()
            torch.cuda.empty_cache()
            drops.append((ref, before, (torch.cuda.memory_allocated(),
                                        torch.cuda.memory_reserved())))

        slot.get, slot.drop = get, drop
        for c in counters.values():
            c.reset()
        rows = []
        try:
            for perms in chunks:
                rows.append(engine.run_epochs(net, opt, gen, perms))
                keys.append(slot.key)
                if graphs and slot.runner.graph is None:
                    raise AssertionError(f"{label}: chunk {len(keys)}: no graph captured")
            engine.end_fold()
        finally:
            del slot.get, slot.drop
        counts = {k: dict(vars(c)) for k, c in counters.items()}
        got[graphs] = (np.concatenate(rows), [t.detach().cpu().numpy()
                                              for t in seq_state(net, opt, gen)()],
                       counts, keys, made, drops)
    for f, v in saved.items():
        setattr(engine, f, v)
    rows_g, state_g, counts_g, keys, made, drops = got[True]
    rows_e, state_e, counts_e, keys_e, _, _ = got[False]
    keys, keys_e = [k[1:] for k in keys], [k[1:] for k in keys_e]  # (fold, budget)
    if not (keys[0] == keys[1] != keys[2]) or keys != keys_e:
        raise AssertionError(f"{label}: budgets {keys} (eager {keys_e}): chunk 3 must "
                             f"grow the budget and only chunk 3")
    if [k[1:] for k in made] != [keys[0], keys[2]]:
        raise AssertionError(f"{label}: runners built for {made}, want one a budget")
    grown = [d for d in drops if d[0] is not None]
    if len(grown) != 2 or grown[0][0]() is not None:
        raise AssertionError(f"{label}: the old runner's graph outlived its drop")
    (_, (a0, r0), (a1, r1)) = grown[0]
    if not a1 < a0:
        raise AssertionError(f"{label}: memory_allocated {a0} -> {a1} at the drop")
    same_bits(f"{label}: forced growth, graphed vs eager rows", [rows_g], [rows_e])
    same_bits(f"{label}: forced growth, graphed vs eager state", state_g, state_e)
    if counts_g != counts_e:
        raise AssertionError(f"{label}: launches graphed {counts_g} vs eager {counts_e}")
    log(f"  {label} forced growth: budgets by chunk {keys[0]} → {keys[1]} → "
        f"{keys[2]}; runners built {len(made)} (one a budget, each captured once); "
        f"the old graph destroyed at the drop, memory_allocated {a0 / 2**20:.1f} → "
        f"{a1 / 2**20:.1f} MiB, memory_reserved (after empty_cache) {r0 / 2**20:.1f} → "
        f"{r1 / 2**20:.1f} MiB; 5 epochs' rows, parameters, optimizer and generator "
        f"state bitwise eager; launches equal to eager's")


# -- phase 4e: block fold-lockstep (DD) --------------------------------------


class ChunkSpy:
    """Records the runner key (budget or slot tuple) of every chunk the
    lockstep driver runs, by wrapping `cv_vmap.lockstep_chunk`; a context
    manager that puts the driver back."""

    def __enter__(self):
        from dgcnn_tpu_torch.train import cv_vmap

        self.keys, self.mod, real = [], cv_vmap, cv_vmap.lockstep_chunk

        def spy(engine, *a):
            out = real(engine, *a)
            self.keys.append(engine.runners.key)
            return out

        cv_vmap.lockstep_chunk, self.real = spy, real
        return self

    def __exit__(self, *exc):
        self.mod.lockstep_chunk = self.real


def lockstep_events_ok(label, cfg, folds_n, epochs):
    """Raise unless every epoch event is a chunked lockstep run's: epoch by
    epoch, fold by fold, `folds_in_lockstep` the fold count, chunks of 2."""
    ev = epoch_events(cfg)
    if [(e["epoch"], e["fold"]) for e in ev] != [
            (ep, f) for ep in range(1, epochs + 1) for f in range(1, folds_n + 1)] or any(
            e.get("folds_in_lockstep") != folds_n or e["chunk_epochs"] != min(2, epochs)
            for e in ev):
        raise AssertionError(f"{label}: the epoch events are not a chunked lockstep run's")
    return ev


def counted_lockstep_run(label, cfg, graphs, counters, used, want):
    """`run_cv` with every block kernel's counts set to 0 just before and
    read just after; raises unless `used` launched `want` (fwd, bwd), a
    quarter of each of width 1, and the other kernel nothing. Returns
    (wall seconds, launches (fwd, bwd), of width 1, the chunks' budgets)."""
    for c in counters.values():
        c.reset()
    with ChunkSpy() as spy:
        _, wall = run_cv(cfg, graphs)
    counts = {k: (c.fwd_launches, c.bwd_launches) for k, c in counters.items()}
    f1 = (counters[used].f1_fwd, counters[used].f1_bwd)
    log(f"  {label} ({'graphed' if graphs else 'eager'}): {wall:.1f} s; budgets (nb a "
        f"fold, W a step) by chunk {spy.keys}; launches (fwd, bwd) {counts}, of width "
        f"1 on {used} {f1} (want {want}, a quarter of width 1)")
    if counts != {k: want if k == used else (0, 0) for k in counters} or (
            4 * f1[0], 4 * f1[1]) != want:
        raise AssertionError(f"{label}: launch counts {counts} (F=1 {f1}), expected "
                             f"{want} on {used}")
    return wall, counts[used], f1, spy.keys


def block_lockstep_main_path(ctx, counters, seq_rows, auto_impl, other_impl):
    """Phase 4e: `run_cross_validation` of synthetic DD on the block layout
    in lockstep, chunks of `max_fused_epochs` 2. (i) `cv_parallel="folds"`
    at 2 folds x 4 epochs, graphed then eager: rows, `epochs/` bundles and
    launch counts bitwise equal, launches exact per replay, rows within
    rtol/atol 5e-4 of phase 4b's sequential run (same seed and split).
    (ii) The default: `auto` at 10 folds x 4 epochs graphed (budgets and
    launches by replay), 10 x 2 eager (epochs 1-2 bitwise the graphed
    run's: the same chunk, the same budget), and 10 x 2 with the other
    `block_impl` (rows within 5e-4 of the auto run's). Returns the launch
    counts and fold-epoch seconds."""
    kernel_of = {"pallas": "block_csr", "xla": "block_resident"}
    used = kernel_of[auto_impl]
    out = {}

    def props(steps, epochs):
        """Propagations (fwd, bwd) of `epochs` lockstep epochs of (train,
        eval) steps: one a layer, 4 a step, the backward on train steps."""
        return 4 * epochs * sum(steps), 4 * epochs * steps[0]

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data", "DD", "10fold_idx")
        steps2 = lockstep_steps("DD", ctx.gs.y, 2, 50, data_dir)
        want = props(steps2, 4)
        cfg = cv_config(tmp, "lock2", "DD", 2, 4, max_fused_epochs=2, cv_parallel="folds")
        eager = cv_config(tmp, "lock2_eager", "DD", 2, 4, max_fused_epochs=2,
                          cv_parallel="folds")
        _, n, f1, keys = counted_lockstep_run(
            f"DD block lockstep 2 x 4 ({auto_impl}), steps {steps2}", cfg, True, counters,
            used, want)
        counted_lockstep_run("  the same, eager", eager, False, counters, used, want)
        same_bits("DD lockstep 2 x 4: graphed vs eager rows", fold_rows(cfg),
                  fold_rows(eager))
        same_bits("DD lockstep 2 x 4: graphed vs eager epochs/ bundles", bundles(cfg),
                  bundles(eager))
        ev = lockstep_events_ok("DD lockstep 2 x 4", cfg, 2, 4)
        worst = 0.0
        for f, (lock, one) in enumerate(zip(fold_rows(cfg), seq_rows), start=1):
            if not np.allclose(lock, one, rtol=5e-4, atol=5e-4):
                raise AssertionError(f"DD lockstep fold {f}: rows {lock} vs sequential {one}")
            worst = max(worst, float(np.abs(lock - one).max()))
        log(f"  DD block lockstep 2 x 4: rows, epochs/ bundles and launches bitwise "
            f"graphed vs eager; every event folds_in_lockstep 2, chunk_epochs 2; every "
            f"fold's rows within rtol/atol 5e-4 of phase 4b's sequential run (worst abs "
            f"{worst:.3e}); fold-epoch seconds (epoch seconds / 2) "
            f"{chunk_seconds(ev, 2)}")
        out["two_folds"] = {"launches": n, "f1": f1, "budgets": keys,
                            "epoch_s": chunk_seconds(ev, 2)}

        steps10 = lockstep_steps("DD", ctx.gs.y, FOLDS, 50, data_dir)
        cfg = cv_config(tmp, "lock10", "DD", FOLDS, 4, max_fused_epochs=2)
        wall, n, f1, keys = counted_lockstep_run(
            f"DD block lockstep {FOLDS} x 4 (cv_parallel auto, {auto_impl}), steps "
            f"{steps10}", cfg, True, counters, used, props(steps10, 4))
        ev = lockstep_events_ok(f"DD auto {FOLDS} x 4", cfg, FOLDS, 4)
        keep_run("DD block lockstep", cfg)
        start = check_artifacts(os.path.join(tmp, "lock10"), "DD", FOLDS, 4)[0]
        if start["layout"] != "block" or start["block_impl"] != auto_impl:
            raise AssertionError(f"run_start says {start}")
        eager = cv_config(tmp, "lock10_eager", "DD", FOLDS, 2, max_fused_epochs=2)
        wall_e, _, _, keys_e = counted_lockstep_run(
            f"DD block lockstep {FOLDS} x 2 eager", eager, False, counters, used,
            props(steps10, 2))
        same_bits(f"DD lockstep {FOLDS}: epochs 1-2 graphed vs eager",
                  [r[:2] for r in fold_rows(cfg)], fold_rows(eager))
        ev_e = epoch_events(eager)
        other = cv_config(tmp, "lock10_other", "DD", FOLDS, 2, max_fused_epochs=2,
                          block_impl=other_impl)
        counted_lockstep_run(f"DD block lockstep {FOLDS} x 2 (block_impl {other_impl})",
                             other, True, counters, kernel_of[other_impl],
                             props(steps10, 2))
        worst = max(float(np.abs(a - b[:2]).max())
                    for a, b in zip(fold_rows(other), fold_rows(cfg)))
        if not all(np.allclose(a, b[:2], rtol=5e-4, atol=5e-4)
                   for a, b in zip(fold_rows(other), fold_rows(cfg))):
            raise AssertionError(f"DD lockstep, block_impl {other_impl}: rows off by {worst}")
        graphed_s, eager_s = chunk_seconds(ev, FOLDS), chunk_seconds(ev_e, FOLDS)
        other_s = chunk_seconds(epoch_events(other), FOLDS)
        log(f"  DD block lockstep {FOLDS} folds (the default run): every event "
            f"folds_in_lockstep {FOLDS}; epochs 1-2 bitwise eager; block_impl "
            f"{other_impl} within 5e-4 (worst abs {worst:.3e}); fold-epoch seconds "
            f"(epoch seconds / {FOLDS}): graphed {graphed_s} (chunk 1 holds the warm-up "
            f"and the capture), eager {eager_s}, block_impl {other_impl} graphed "
            f"{other_s}; against the sequential graphed fold-epoch of phase 4b")
        out["ten_folds"] = {"launches": n, "f1": f1, "budgets": keys, "steps": steps10,
                            "epoch_s": graphed_s, "eager_epoch_s": eager_s,
                            "other_epoch_s": other_s, "wall_s": wall, "eager_wall_s": wall_e,
                            "peak_mib": PEAK_MIB[cfg.statistics_dir]}
    return out


def dd_lockstep_runners(ctx, lctx, model, device, graphs, dev=None):
    """The 10-fold DD block lockstep runner as the driver builds it (the
    driver's seeds; `block_impl` auto), at the budgets of its first 3
    epochs and the test order, with the 3 orders and a `state()`, over the
    graphset `dev` (the engine's, fp32, when None)."""
    from dgcnn_tpu_torch.batching.block_sparse import block_fold_extents
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, init_params, stack_params
    from dgcnn_tpu_torch.train.cv import _geom_round, _stream_seed
    from dgcnn_tpu_torch.train.loop import FoldAdam, make_block_lockstep_run

    orders = np.stack(lctx.epochs)
    nb, w = block_fold_extents(ctx.engine._nb, ctx.engine._block_counts,
                               np.concatenate([orders.reshape(-1, FOLDS, S), lctx.test]))
    nb, w = _geom_round(nb, 8), _geom_round(w, 64)
    net_f = DGCNNFoldsNet(model, stack_params([
        init_params(torch.Generator().manual_seed(_stream_seed(324, f, 1)), model, device)
        for f in range(1, FOLDS + 1)]))
    adam_f = FoldAdam(net_f)
    gens = [torch.Generator(device=device).manual_seed(_stream_seed(324, f, 2))
            for f in range(1, FOLDS + 1)]
    run = make_block_lockstep_run(net_f, adam_f, ctx.engine.dev if dev is None else dev,
                                  lctx.test, nb, w,
                                  (orders[0] >= 0).any(-1), gens,
                                  Config().resolved_block_impl(), graphs)

    def state():
        return [net_f.flat, adam_f.exp_avg, adam_f.exp_avg_sq, adam_f.steps,
                *(g.get_state() for g in gens)]

    return {"DD block lockstep": (run, orders, state, lctx.steps + lctx.t_steps)}


def lockstep_forced_growth(ctx, lctx, model, device, counters):
    """The block engine's lockstep budgets (`cv_vmap.lockstep_chunk`) over
    three chunks of the 10 folds, graphed and then eager, from the floors
    (8, 64) and the driver's seeds: chunk 1 (2 epochs of each fold's
    smallest graphs first) and chunk 2 (1 epoch, the same) at one budget,
    chunk 3 with each fold's largest graphs first. The budget grows at
    chunk 3 and only there, exactly one new runner captures, and rows,
    parameters, optimizer and generator state and every kernel's launch
    counts equal, graphed and eager."""
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, init_params, stack_params
    from dgcnn_tpu_torch.train.cv import _stream_seed
    from dgcnn_tpu_torch.train.cv_vmap import lockstep_chunk
    from dgcnn_tpu_torch.train.loop import FoldAdam

    engine = ctx.engine
    folds = get_folds(ctx.gs.y, "", FOLDS, 324, data_type="DD")
    train = [np.asarray(tr, np.int32) for tr, _ in folds]
    test = [np.asarray(te, np.int32) for _, te in folds]
    sizes = engine._block_counts[:-1]
    asc = [t[np.argsort(sizes[t], kind="stable")] for t in train]
    desc = [t[np.argsort(-sizes[t], kind="stable")] for t in train]
    saved = (engine.floor_nb, engine.floor_w, engine.graphs)
    got = {}
    for graphs in (True, False):
        engine.floor_nb, engine.floor_w, engine.graphs = 8, 64, graphs
        net_f = DGCNNFoldsNet(model, stack_params([
            init_params(torch.Generator().manual_seed(_stream_seed(324, f, 1)), model,
                        device) for f in range(1, FOLDS + 1)]))
        adam_f = FoldAdam(net_f)
        gens = [torch.Generator(device=device).manual_seed(_stream_seed(324, f, 2))
                for f in range(1, FOLDS + 1)]
        for c in counters.values():
            c.reset()
        keys, runners, rows = [], [], []
        for ids_k in ([asc, asc], [asc], [desc, asc]):
            runner, orders = lockstep_chunk(engine, net_f, adam_f, gens, ids_k, test)
            rows.append(runner.run_epochs(orders))
            keys.append(engine.runners.key)
            if runner not in runners:
                runners.append(runner)
            if graphs and runner.graph is None:
                raise AssertionError(f"lockstep chunk {len(keys)}: no graph captured")
        captures = sum(r.capture_seconds is not None for r in runners)
        engine.end_fold()
        got[graphs] = (np.concatenate(rows), [
            t.detach().cpu().numpy() for t in (net_f.flat, adam_f.exp_avg,
                                               adam_f.exp_avg_sq, adam_f.steps)] +
            [g.get_state().numpy() for g in gens],
            {k: dict(vars(c)) for k, c in counters.items()}, keys, len(runners), captures)
        del runners, runner
    engine.floor_nb, engine.floor_w, engine.graphs = saved
    rows_g, state_g, counts_g, keys, made, captures = got[True]
    rows_e, state_e, counts_e, keys_e, _, _ = got[False]
    if not (keys[0] == keys[1] != keys[2]) or keys != keys_e or made != 2 or captures != 2:
        raise AssertionError(f"DD lockstep forced growth: budgets {keys} (eager {keys_e}), "
                             f"{made} runners, {captures} captures; want a growth at "
                             f"chunk 3 only, one runner and one capture a budget")
    same_bits("DD lockstep forced growth: graphed vs eager rows", [rows_g], [rows_e])
    same_bits("DD lockstep forced growth: graphed vs eager state", state_g, state_e)
    if counts_g != counts_e:
        raise AssertionError(f"DD lockstep forced growth: launches {counts_g} vs {counts_e}")
    log(f"  DD block lockstep forced growth ({FOLDS} folds): budgets by chunk {keys}; "
        f"{made} runners, {captures} captures (one a budget); 5 epochs' rows, "
        f"parameters, optimizer and generator state bitwise eager; launches equal")
    return keys


# -- phase 4d: the multi-tile dense layout (COLLAB) -------------------------


class CollabContext:
    """Synthetic COLLAB (5,000 graphs) as the multi-tile layout sees it:
    the layout `choose_layout` gives, the tile ladder and its class sizes,
    a `MultiDenseEngine` on the card (its device densify timed, with its
    peak memory) and fold 1's first train batch that holds a graph of
    every class (`run_fold`'s epoch-1 shuffle, seed 324; most batches
    hold no T=464 graph) routed into the classes at the engine's slot
    floors, packed on the host at each class's tile: the shapes phase 3a
    checks and phase 5 times."""

    def __init__(self, device):
        from dgcnn_tpu_torch.batching.dense import pack_dense_batch
        from dgcnn_tpu_torch.batching.multi_dense import class_batch_counts, route_order_rows
        from dgcnn_tpu_torch.config import Config
        from dgcnn_tpu_torch.data.folds import get_folds
        from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
        from dgcnn_tpu_torch.train.cv import MultiDenseEngine, choose_layout

        t0 = time.perf_counter()
        self.gs = synthesize_tu_dataset("COLLAB")
        self.cfg = Config(data_type="COLLAB", batch_size=50)
        self.layout = choose_layout(self.cfg, self.gs)
        log(f"  synthetic COLLAB: {self.gs.num_graphs} graphs, {self.gs.total_edges} "
            f"edges, largest {int(self.gs.node_counts().max())} nodes, made in "
            f"{time.perf_counter() - t0:.1f} s; choose_layout -> {self.layout}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        self.engine = MultiDenseEngine(self.cfg, self.gs, device)
        torch.cuda.synchronize()
        self.densify_s = time.perf_counter() - t0
        self.densify_peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        self.held_mib = (torch.cuda.memory_allocated() - base) / 2**20
        self.tiles = self.engine.tiles
        r = self.engine.routing
        self.sizes = [int((r.class_of == c).sum()) for c in range(len(self.tiles))]
        log(f"  MultiDenseEngine on the card: tiles {self.tiles}, graphs by class "
            f"{self.sizes}, slot floors {self.engine.slot_floor.tolist()}; engine "
            f"build (graphset to the card + densify) {self.densify_s:.2f} s, peak "
            f"{self.densify_peak_mib:.1f} MiB above what was allocated, held "
            f"{self.held_mib:.1f} MiB")
        tr, te = get_folds(self.gs.y, "", 2, 324, data_type="COLLAB")[0]
        self.fold = (np.asarray(tr, np.int64), np.asarray(te, np.int64))
        perm = np.random.default_rng(np.random.SeedSequence([324, 1])).permutation(len(tr))
        order = self.fold[0][perm]
        per_batch = class_batch_counts(r, order, 50)
        self.step = int(np.flatnonzero((per_batch > 0).all(axis=1))[0])
        ids = order[50 * self.step:50 * (self.step + 1)]
        counts = per_batch[self.step]
        self.slots = tuple(max(int(f), -(-int(n) // 4) * 4)
                           for f, n in zip(self.engine.slot_floor, counts))
        rows = route_order_rows(r, ids, self.slots)
        self.host = []  # that batch, class by class
        for c, (t, s) in enumerate(zip(self.tiles, self.slots)):
            members = ids[r.class_of[ids] == c]
            self.host.append(pack_dense_batch(self.gs, members, t, s))
            assert (rows[c] >= 0).sum() == len(members)
        log(f"  fold 1's first batch with every class (step {self.step} of epoch 1): "
            f"{counts.tolist()} graphs by class in {list(self.slots)} slots")

    def batch(self, device):
        """That batch as a `MultiDenseBatch` on `device`."""
        from dgcnn_tpu_torch.batching.dense import batch_to_device
        from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch

        return MultiDenseBatch(tuple(batch_to_device(b, device) for b in self.host))

    def shapes(self, device):
        """(label, adj, mask) of each class of that batch on `device`."""
        return [(f"COLLAB multi class T={t} S={s}", torch.from_numpy(b.adj).to(device),
                 torch.from_numpy(b.node_mask).to(device))
                for t, s, b in zip(self.tiles, self.slots, self.host)]


def check_collab_trunk(collab, device, dt, stats):
    """Phase 3a's COLLAB cases: each tile class of fold 1's first batch
    with every class, at its tile and slot count, the plan's regime named (resident at T=256,
    streamed at T=464 at dims (32,32,32,1))."""
    for name, adj, mask in collab.shapes(device):
        s, t = adj.shape[0], adj.shape[1]
        plan = dt.trunk_plan(s, t, DIMS)
        want = "resident" if t <= resident_cap() else "streamed"
        log(f"  {name}: plan {plan}")
        if plan.regime != want:
            raise AssertionError(f"{name}: plan {plan}, expected {want}")
        compare_trunk(f"{name} ({want})", adj, mask, device, dt, stats)


def trunk_calls_want(dt, tiles, slot_sets, steps, train_steps, es=4):
    """Trunk calls by regime of `steps` forwards and `train_steps` backwards
    of every class: the counters' (resident_fwd, resident_bwd, streamed_fwd,
    streamed_bwd), and the kernel launches (fwd, bwd) they make
    (`launches_per_call`), for an adjacency of `es` bytes an element. Each
    class must keep one regime over `slot_sets`."""
    regimes = []
    for c, t in enumerate(tiles):
        plans = {dt.trunk_plan(sl[c], t, DIMS, es=es).regime for sl in slot_sets}
        if len(plans) != 1:
            raise AssertionError(f"class T={t}: regimes {plans} over slots {slot_sets}")
        regimes.append(plans.pop())
    n_res = regimes.count("resident")
    n_str = regimes.count("streamed")
    per = {r: dt.launches_per_call(dt.TrunkPlan(r, 1 if r == "resident" else 0, 0, 0),
                                   DIMS) for r in ("resident", "streamed")}
    calls = (n_res * steps, n_res * train_steps, n_str * steps, n_str * train_steps)
    kernels = (n_res * per["resident"][0] * steps + n_str * per["streamed"][0] * steps,
               n_res * per["resident"][1] * train_steps
               + n_str * per["streamed"][1] * train_steps)
    return calls, kernels, regimes


def multi_main_path(collab, dt, device):
    """Phase 4d's run: the device densify bitwise the host builder's, then
    `run_cross_validation` of synthetic COLLAB (layout auto → multi, the
    folds one after another) for 2 folds x 4 epochs in chunks of
    `max_fused_epochs` 2, graphed (trunk calls counted per replay, by
    regime) and eager: every fold's rows and `epochs/` bundle bitwise
    equal; the fold-epoch seconds of chunk 2; then one fold x 4 epochs of
    `--layout dense` (T=464, S=56, streamed), graphed, for the record.
    Both runs say `cv_parallel="sequential"`: at 10 folds the dense
    lockstep step (580 MB) is over its 128 MB gate and `auto` runs the
    folds one after another, but the gate scales with the fold count, and
    at the smoke's 2 folds (97 MB) `auto` would lockstep dense instead."""
    from dgcnn_tpu_torch.batching.multi_dense import build_multi_dense

    t0 = time.perf_counter()
    host, _ = build_multi_dense(collab.gs, collab.tiles, device)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    for c, (a, b) in enumerate(zip(host, collab.engine.classes)):
        for f in ("x", "adj", "node_mask", "y"):
            u, v = getattr(a, f), getattr(b, f)
            if u.dtype != v.dtype or u.shape != v.shape or not torch.equal(u, v):
                where = ""
                if u.shape == v.shape:
                    d = (u.double() - v.double()).abs()
                    at = tuple(int(i) for i in (d > 0).nonzero()[0])
                    where = (f"largest difference {d.max().item():.3e} over {int((d > 0).sum())} "
                             f"entries; first at {at}: host {u[at].item()!r}, device "
                             f"{v[at].item()!r}")
                raise AssertionError(f"class {c} {f}: device densify differs from the "
                                     f"host builder ({where or 'shape or dtype'})")
    del host
    torch.cuda.empty_cache()
    log(f"  device densify: every class's x, adj, node_mask, y bitwise the host "
        f"builder's (host pack + copy {host_s:.1f} s against the device build "
        f"{collab.densify_s:.2f} s)")
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(max_fused_epochs=2, cv_parallel="sequential")
        cfg = cv_config(tmp, "collab", "COLLAB", 2, 4, **kw)
        eager = cv_config(tmp, "collab_eager", "COLLAB", 2, 4, **kw)
        dt.launches.reset()
        _, wall = run_cv(cfg, True)
        got = (dt.launches.resident_fwd, dt.launches.resident_bwd,
               dt.launches.streamed_fwd, dt.launches.streamed_bwd)
        kern = (dt.launches.kernel_fwd, dt.launches.kernel_bwd)
        tr_n, ev_n = count_steps("COLLAB", collab.gs.y, 2, 4, 50,
                                 os.path.join(tmp, "data", "COLLAB", "10fold_idx"))
        events = check_artifacts(os.path.join(tmp, "collab"), "COLLAB", 2, 4)
        start = events[0]
        if start["kind"] != "run_start" or start["layout"] != "multi" or tuple(
                start["tiles"]) != collab.tiles:
            raise AssertionError(f"run_start says {start}")
        want, want_kern, regimes = trunk_calls_want(
            dt, collab.tiles, [start["slot_floors"]], tr_n + ev_n, tr_n)
        log(f"  COLLAB multi 2 x 4, chunks of 2, graphed: {wall:.1f} s; train steps "
            f"{tr_n}, eval steps {ev_n}; classes {collab.tiles} run {regimes}; slot "
            f"floors at run start {start['slot_floors']}; trunk calls by regime "
            f"(resident fwd, bwd, streamed fwd, bwd) {got} (want {want}), kernel "
            f"launches counted (fwd, bwd) {kern} (want {want_kern})")
        if got != want or (dt.launches.fwd_launches, dt.launches.bwd_launches) != (
                want[0] + want[2], want[1] + want[3]) or kern != want_kern:
            raise AssertionError(f"COLLAB multi: trunk calls {got}, kernels {kern}, "
                                 f"expected {want}, {want_kern}")
        _, wall_e = run_cv(eager, False)
        same_bits("COLLAB multi: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
        same_bits("COLLAB multi: graphed vs eager epochs/ bundles", bundles(cfg),
                  bundles(eager))
        ev, ev_e = epoch_events(cfg), epoch_events(eager)
        chunk2 = [(e["fold"], e["epoch_seconds"]) for e in ev if e["epoch"] > 2]
        chunk2_e = [(e["fold"], e["epoch_seconds"]) for e in ev_e if e["epoch"] > 2]
        log(f"  COLLAB multi: eager run {wall_e:.1f} s; every fold's rows and epochs/ "
            f"bundle bitwise equal, graphed and eager; fold-epoch seconds (fold, s) "
            f"of chunk 2: graphed {chunk2} vs eager {chunk2_e}; chunk 1 (warm-up + "
            f"capture): graphed {[e['epoch_seconds'] for e in ev if e['epoch'] <= 2]} "
            f"vs eager {[e['epoch_seconds'] for e in ev_e if e['epoch'] <= 2]}")

        dense = cv_config(tmp, "collab_dense", "COLLAB", 1, 4, max_fused_epochs=2,
                          layout="dense", cv_parallel="sequential")
        dt.launches.reset()
        _, wall_d = run_cv(dense, True)
        d_tr, d_ev = count_steps("COLLAB", collab.gs.y, 1, 4, 50,
                                 os.path.join(tmp, "data", "COLLAB", "10fold_idx"))
        d_calls = (dt.launches.resident_fwd, dt.launches.resident_bwd,
                   dt.launches.streamed_fwd, dt.launches.streamed_bwd)
        d_kern = (dt.launches.kernel_fwd, dt.launches.kernel_bwd)
        d_want = trunk_calls_want(dt, collab.tiles[-1:], [(S,)], d_tr + d_ev, d_tr)
        if (d_calls, d_kern, d_want[2]) != (*d_want[:2], ["streamed"]):
            raise AssertionError(f"COLLAB dense: trunk calls {d_calls}, kernels "
                                 f"{d_kern}, expected all streamed {d_want[:2]}")
        d_ev_s = epoch_events(dense)
        dense_chunk2 = [e["epoch_seconds"] for e in d_ev_s if e["epoch"] > 2]
        log(f"  COLLAB --layout dense (T=464, S=56, streamed; host-built 4.32 GB "
            f"adjacency), 1 x 4, graphed, for the record: {wall_d:.1f} s; trunk calls "
            f"{d_calls}, kernel launches {d_kern}; fold-epoch seconds chunk 2 "
            f"{dense_chunk2} (chunk 1 "
            f"{[e['epoch_seconds'] for e in d_ev_s if e['epoch'] <= 2]}) against "
            f"multi's {[s for f, s in chunk2 if f == 1]}")
        rows = fold_rows(cfg)
    return {"calls": got, "kernel_launches": kern, "regimes": regimes,
            "slot_floors": start["slot_floors"], "steps": (tr_n, ev_n),
            "epoch_s": chunk2, "eager_epoch_s": chunk2_e, "dense_epoch_s": dense_chunk2,
            "rows": rows, "peak_mib": PEAK_MIB[cfg.statistics_dir]}


def check_collab_lockstep_trunk(collab, device, dt, stats):
    """Phase 3a's multi-lockstep cases: each tile class of phase 3a's
    COLLAB batch repeated for the default 10 folds on the class's slot
    axis (T=256 at S = 10 × its slots, T=464 at 10 × 4), K = 10 with the
    lockstep `wsel`; returns (label, adj, mask) of each."""
    shapes = []
    for name, adj, mask in collab.shapes(device):
        adj, mask = adj.repeat(FOLDS, 1, 1), mask.repeat(FOLDS, 1)
        s, t = adj.shape[0], adj.shape[1]
        label = f"COLLAB multi lockstep class T={t} S={s} ({FOLDS} folds x {s // FOLDS})"
        log(f"  {label}: plan {dt.trunk_plan(s, t, DIMS)}")
        compare_trunk(label, adj, mask, device, dt, stats, folds=FOLDS)
        shapes.append((label, adj, mask))
    return shapes


def check_multi_lockstep_step(collab, model, device):
    """On the card, one multi-tile lockstep train step of 2 folds (each
    fold's first batch of its epoch-1 shuffle, the driver's seeds, dropout
    on) against the one-fold forward of each fold on its own batch:
    log-probs and every parameter gradient within rel 1e-4, dropout masks
    bitwise, generators in the same state. This holds the step to the
    sequential step where the rows of 4 epochs cannot be held: rounding
    differences grow over Adam's steps."""
    from dgcnn_tpu_torch.batching.dense import gather_dense_batch
    from dgcnn_tpu_torch.batching.multi_dense import (
        MultiDenseBatch, class_batch_counts, route_order_rows)
    from dgcnn_tpu_torch.data.folds import get_folds
    from dgcnn_tpu_torch.models.dgcnn import (
        DGCNNFoldsNet, DGCNNNet, init_params, stack_params)
    from dgcnn_tpu_torch.parity.convert import state_to_params
    from dgcnn_tpu_torch.train.cv import _stream_seed
    from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

    engine = collab.engine
    ids = []
    for f, (tr, _) in enumerate(get_folds(collab.gs.y, "", 2, 324, data_type="COLLAB"),
                                start=1):
        perm = np.random.default_rng(np.random.SeedSequence([324, f])).permutation(len(tr))
        ids.append(np.asarray(tr)[perm][:50])
    need = np.max([class_batch_counts(engine.routing, i, 50)[0] for i in ids], axis=0)
    slots = tuple(int(max(a, -(-b // 4) * 4)) for a, b in zip(engine.slot_floor, need))
    rows = [route_order_rows(engine.routing, i, slots) for i in ids]
    flat = [torch.from_numpy(np.concatenate([r[c] for r in rows])).to(device)
            for c in range(len(slots))]
    batch = MultiDenseBatch(tuple(gather_dense_batch(d, r)
                                  for d, r in zip(engine.classes, flat)), num_folds=2)
    net_f = DGCNNFoldsNet(model, stack_params([
        init_params(torch.Generator().manual_seed(_stream_seed(324, f, 1)), model, device)
        for f in (1, 2)]))
    gens = [torch.Generator(device=device).manual_seed(_stream_seed(324, f, 2))
            for f in (1, 2)]
    lp, acts = net_f(batch, deterministic=False, dropout_gens=gens, return_activations=True)
    nll_loss_and_correct(lp, batch.y.view(2, -1), batch.graph_mask.view(2, -1))[0].sum(
        ).backward()
    worst = 0.0
    for f in range(2):
        net = DGCNNNet(model, state_to_params(net_f.fold_state_dict(f)))
        gen = torch.Generator(device=device).manual_seed(_stream_seed(324, f + 1, 2))
        own = MultiDenseBatch(tuple(gather_dense_batch(d, torch.from_numpy(r).to(device))
                                    for d, r in zip(engine.classes, rows[f])))
        lp1, acts1 = net(own, deterministic=False, dropout_gen=gen, return_activations=True)
        nll_loss_and_correct(lp1, own.y, own.graph_mask)[0].backward()
        if not torch.equal(acts["dropout_keep"][f], acts1["dropout_keep"]) or not \
                torch.equal(gens[f].get_state(), gen.get_state()):
            raise AssertionError(f"COLLAB lockstep step, fold {f + 1}: dropout differs")
        for a, b in [(lp[f], lp1)] + [(p_f.grad[f], p.grad) for p_f, p in
                                      zip(net_f.parameters(), net.parameters())]:
            err, rel, ok = rel_err(a.detach(), b.detach())
            if not ok:
                raise AssertionError(f"COLLAB lockstep step, fold {f + 1}: lockstep vs "
                                     f"one-fold step differ (max abs {err:.3e})")
            worst = max(worst, rel)
    log(f"  COLLAB multi lockstep step (2 folds' first batches, slots {list(slots)}): "
        f"each fold's log-probs and 16 parameter gradients within rel 1e-4 of its own "
        f"step (worst rel {worst:.3e}), dropout masks bitwise, generators in the same "
        f"state")


def multi_lockstep_main_path(collab, dt, seq_rows):
    """Phase 4f: `run_cross_validation` of synthetic COLLAB on the multi-tile
    layout (`layout="multi"`: under `cv_parallel="folds"` the lockstep
    gate holds and `auto` keeps dense, as in the reference) with
    `cv_parallel="folds"` at 2 folds x 4 epochs in chunks of
    `max_fused_epochs` 2, graphed (trunk calls and kernel launches counted
    per replay, by regime: each class's trunk on its 2 × S_c slots) and
    eager: rows, `epochs/` bundles and counts bitwise equal; the rows'
    distance from phase 4d's sequential run is logged, not held: on the
    card it leaves 5e-4 within the first epochs (the folds' batched
    products and Adam round differently from the sequential step, and
    Adam's steps on a loss near chance, ln 3, carry it on), so
    `check_multi_lockstep_step` holds one step instead."""
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(max_fused_epochs=2, cv_parallel="folds", layout="multi")
        runs = {}
        for graphs, sub in ((True, "mlock"), (False, "mlock_eager")):
            cfg = cv_config(tmp, sub, "COLLAB", 2, 4, **kw)
            dt.launches.reset()
            with ChunkSpy() as spy:
                _, wall = run_cv(cfg, graphs)
            runs[graphs] = (cfg, wall, spy.keys, (
                dt.launches.resident_fwd, dt.launches.resident_bwd,
                dt.launches.streamed_fwd, dt.launches.streamed_bwd),
                (dt.launches.kernel_fwd, dt.launches.kernel_bwd))
        cfg, wall, keys, got, kern = runs[True]
        eager, wall_e, keys_e, got_e, kern_e = runs[False]
        steps = lockstep_steps("COLLAB", collab.gs.y, 2, 50,
                               os.path.join(tmp, "data", "COLLAB", "10fold_idx"))
        want, want_kern, regimes = trunk_calls_want(
            dt, collab.tiles, [tuple(2 * s for s in k) for k in keys], 4 * sum(steps),
            4 * steps[0])
        log(f"  COLLAB multi lockstep 2 x 4, chunks of 2: graphed {wall:.1f} s, eager "
            f"{wall_e:.1f} s; lockstep steps {steps}; slot tuples by chunk {keys}; "
            f"classes {collab.tiles} run {regimes} at 2 x S_c slots; trunk calls by "
            f"regime {got} (want {want}), kernel launches {kern} (want {want_kern})")
        if got != want or kern != want_kern or (got_e, kern_e, keys_e) != (got, kern, keys):
            raise AssertionError(f"COLLAB multi lockstep: calls {got} / {got_e}, kernels "
                                 f"{kern} / {kern_e}, expected {want}, {want_kern}")
        same_bits("COLLAB multi lockstep: graphed vs eager rows", fold_rows(cfg),
                  fold_rows(eager))
        same_bits("COLLAB multi lockstep: graphed vs eager epochs/ bundles", bundles(cfg),
                  bundles(eager))
        ev = lockstep_events_ok("COLLAB multi lockstep", cfg, 2, 4)
        with open(os.path.join(cfg.statistics_dir, "COLLAB_events.jsonl")) as fh:
            start = json.loads(fh.readline())
        if start["layout"] != "multi" or tuple(start["tiles"]) != collab.tiles:
            raise AssertionError(f"run_start says {start}")
        by_epoch = [[float(d) for d in np.abs(a - b).max(axis=1)]
                    for a, b in zip(fold_rows(cfg), seq_rows)]
        lock_s = chunk_seconds(ev, 2)
        log(f"  COLLAB multi lockstep: rows, epochs/ bundles and counts bitwise graphed "
            f"vs eager; distance from phase 4d's sequential rows by fold and epoch "
            f"(largest of losses and accuracies in points; not held: see the step "
            f"check below) {by_epoch}; fold-epoch seconds (epoch seconds / 2) graphed "
            f"{lock_s}, eager {chunk_seconds(epoch_events(eager), 2)}")
    return {"calls": got, "kernel_launches": kern, "slots": keys, "epoch_s": lock_s,
            "regimes": regimes, "distance_by_epoch": by_epoch}


def multi_runners(collab, model, device, graphs):
    """Fold 1's multi-tile runner as `MultiDenseEngine` builds it, at the
    slot tuple of its first 3 epochs and test order (from the engine's
    initial floors), `run_fold`'s seeds, with the 3 orders and a
    `state()`."""
    from dgcnn_tpu_torch.train.loop import make_multi_dense_run

    engine = collab.engine
    floor = engine.slot_floor.copy()
    tr, te = collab.fold
    rng = np.random.default_rng(np.random.SeedSequence([324, 1]))
    ids = [tr[rng.permutation(len(tr))] for _ in range(3)]
    slots = engine.slots_for(*ids, te)
    engine.slot_floor = floor
    orders = np.stack([engine.epoch_order(i, slots) for i in ids])
    test = engine.epoch_order(te, slots)
    net, opt, gen = fold_seeds(model, device)
    run = make_multi_dense_run(net, opt, engine.classes, slots, test, orders.shape[1],
                               gen, graphs)
    return {"COLLAB multi": (run, orders, seq_state(net, opt, gen),
                             orders.shape[1] + test.shape[0])}


# -- phase 4g: mixed precision on the main paths -----------------------------


def bf16_batch(b):
    """A dense batch (or a MultiDenseBatch) with its adjacency, and under
    bf16 compute its features, rounded to bf16, as the engines store them."""
    from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch

    if isinstance(b, MultiDenseBatch):
        return dataclasses.replace(b, classes=tuple(
            dataclasses.replace(c, adj=c.adj.bfloat16()) for c in b.classes))
    return dataclasses.replace(b, x=b.x.bfloat16(), adj=b.adj.bfloat16())


def bf16_main_paths(ctx, collab, nci1, dt, fp32):
    """Phase 4g: the slice's main paths at full width through
    `run_cross_validation`, each in chunks of `max_fused_epochs` 2, graphed
    with the counts set to 0 just before and read just after, then eager:
    synthetic NCI1 `--dtype bfloat16` (dense, 10-fold lockstep under
    `auto`) 10 × 4, the trunk's launches exact per replay, all resident,
    every one bf16; synthetic DD `--dtype bfloat16` (block, 10-fold
    lockstep under `auto`, the CSR kernel) 10 × 4, and `--block_impl xla`
    10 × 2 graphed, the block kernels' launches exact per replay, every one
    bf16; synthetic COLLAB `--adj_dtype bfloat16` (multi, the folds one
    after another) 2 × 4, trunk calls by regime at 2 bytes an element.
    Each: rows and `epochs/` bundles bitwise equal graphed and eager,
    finite losses, fold-epoch seconds and peak memory beside the fp32 run
    of the same path (`fp32`: label → (fold-epoch seconds, peak MiB)).
    The COO layout under bf16 compute is phase 4i's."""
    from dgcnn_tpu_torch.kernels import block_csr, block_resident

    counters = {"block_csr": block_csr.launches, "block_resident": block_resident.launches}
    out = {}

    def side_by_side(label, cfg, epoch_s):
        peak = PEAK_MIB[cfg.statistics_dir]
        s32, p32 = fp32[label]
        log(f"  {label}: fold-epoch seconds graphed bf16 {epoch_s} against fp32 {s32}; "
            f"peak memory of the run (engine and data included) bf16 {peak:.1f} MiB "
            f"against fp32 {p32:.1f} MiB")
        return peak

    with tempfile.TemporaryDirectory() as tmp:
        steps, t_steps = lockstep_steps("NCI1", nci1.y, FOLDS, 50,
                                        os.path.join(tmp, "data", "NCI1", "10fold_idx"))
        want = (4 * (steps + t_steps), 4 * steps)
        kw = dict(max_fused_epochs=2, compute_dtype="bfloat16")
        cfg = cv_config(tmp, "nci1_bf16", "NCI1", FOLDS, 4, **kw)
        eager = cv_config(tmp, "nci1_bf16_eager", "NCI1", FOLDS, 4, **kw)
        _, _, calls = counted_run(cfg, True, dt, want)
        bf16 = (dt.launches.bf16_fwd, dt.launches.bf16_bwd)
        if bf16 != want:
            raise AssertionError(f"NCI1 bf16: {bf16} bf16 trunk calls, expected {want}")
        run_cv(eager, False)
        same_bits("NCI1 bf16: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
        same_bits("NCI1 bf16: graphed vs eager epochs/ bundles", bundles(cfg),
                  bundles(eager))
        check_artifacts(os.path.join(tmp, "nci1_bf16"), "NCI1", FOLDS, 4)
        ev = lockstep_events_ok("NCI1 bf16", cfg, FOLDS, 4)
        epoch_s = chunk_seconds(ev, FOLDS)
        peak = side_by_side("NCI1 lockstep", cfg, epoch_s)
        log(f"  NCI1 --dtype bfloat16, {FOLDS} folds in lockstep: trunk calls {calls}, "
            f"every one bf16 (round_h), all resident; rows and epochs/ bundles bitwise "
            f"graphed and eager; losses finite")
        out["nci1"] = {"calls": calls, "epoch_s": epoch_s, "peak_mib": peak}

        dd_dir = os.path.join(tmp, "data", "DD", "10fold_idx")
        steps10 = lockstep_steps("DD", ctx.gs.y, FOLDS, 50, dd_dir)

        def props(epochs):
            return 4 * epochs * sum(steps10), 4 * epochs * steps10[0]

        kw = dict(max_fused_epochs=2, compute_dtype="bfloat16")
        cfg = cv_config(tmp, "dd_bf16", "DD", FOLDS, 4, **kw)
        eager = cv_config(tmp, "dd_bf16_eager", "DD", FOLDS, 4, **kw)
        dd = {}
        for label, c, graphs in (("graphed", cfg, True), ("eager", eager, False)):
            _, n, f1, keys = counted_lockstep_run(
                f"DD --dtype bfloat16 {FOLDS} x 4 (block lockstep, CSR kernel)", c, graphs,
                counters, "block_csr", props(4))
            bf16 = (block_csr.launches.bf16_fwd, block_csr.launches.bf16_bwd)
            if bf16 != n:
                raise AssertionError(f"DD bf16 {label}: {bf16} bf16 launches of {n}")
            dd[label] = (n, f1, keys)
        same_bits("DD bf16: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
        same_bits("DD bf16: graphed vs eager epochs/ bundles", bundles(cfg), bundles(eager))
        start = check_artifacts(os.path.join(tmp, "dd_bf16"), "DD", FOLDS, 4)[0]
        if start["layout"] != "block":
            raise AssertionError(f"run_start says {start}")
        epoch_s = chunk_seconds(lockstep_events_ok("DD bf16", cfg, FOLDS, 4), FOLDS)
        peak = side_by_side("DD block lockstep", cfg, epoch_s)
        other = cv_config(tmp, "dd_bf16_xla", "DD", FOLDS, 2, block_impl="xla", **kw)
        _, n_x, f1_x, _ = counted_lockstep_run(
            f"DD --dtype bfloat16 --block_impl xla {FOLDS} x 2 (item-parallel kernel)",
            other, True, counters, "block_resident", props(2))
        if (block_resident.launches.bf16_fwd, block_resident.launches.bf16_bwd) != n_x:
            raise AssertionError("DD bf16 xla: a launch of the item-parallel kernel "
                                 "was not bf16")
        log(f"  DD --dtype bfloat16: pool stored bf16 (the propagation dtype); every "
            f"block-kernel launch bf16; rows and epochs/ bundles bitwise graphed and "
            f"eager; losses finite")
        out["dd"] = {"launches": dd["graphed"][0], "f1": dd["graphed"][1],
                     "budgets": dd["graphed"][2], "epoch_s": epoch_s, "peak_mib": peak,
                     "xla_launches": n_x, "xla_f1": f1_x}

        kw = dict(max_fused_epochs=2, cv_parallel="sequential", adj_dtype="bfloat16")
        cfg = cv_config(tmp, "collab_bf16", "COLLAB", 2, 4, **kw)
        eager = cv_config(tmp, "collab_bf16_eager", "COLLAB", 2, 4, **kw)
        dt.launches.reset()
        _, wall = run_cv(cfg, True)
        got = (dt.launches.resident_fwd, dt.launches.resident_bwd,
               dt.launches.streamed_fwd, dt.launches.streamed_bwd)
        kern = (dt.launches.kernel_fwd, dt.launches.kernel_bwd)
        bf16 = (dt.launches.bf16_fwd, dt.launches.bf16_bwd)
        tr_n, ev_n = count_steps("COLLAB", collab.gs.y, 2, 4, 50,
                                 os.path.join(tmp, "data", "COLLAB", "10fold_idx"))
        start = check_artifacts(os.path.join(tmp, "collab_bf16"), "COLLAB", 2, 4)[0]
        if start["layout"] != "multi" or tuple(start["tiles"]) != collab.tiles:
            raise AssertionError(f"run_start says {start}")
        want, want_kern, regimes = trunk_calls_want(
            dt, collab.tiles, [start["slot_floors"]], tr_n + ev_n, tr_n, es=2)
        log(f"  COLLAB --adj_dtype bfloat16 2 x 4, graphed: {wall:.1f} s; classes "
            f"{collab.tiles} run {regimes} at 2 bytes an element; trunk calls by regime "
            f"{got} (want {want}), kernel launches {kern} (want {want_kern}), bf16 calls "
            f"{bf16}")
        if got != want or kern != want_kern or bf16 != (want[0] + want[2],
                                                        want[1] + want[3]):
            raise AssertionError(f"COLLAB bf16: trunk calls {got}, kernels {kern}, bf16 "
                                 f"{bf16}, expected {want}, {want_kern}")
        run_cv(eager, False)
        same_bits("COLLAB bf16: graphed vs eager rows", fold_rows(cfg), fold_rows(eager))
        same_bits("COLLAB bf16: graphed vs eager epochs/ bundles", bundles(cfg),
                  bundles(eager))
        ev = epoch_events(cfg)
        epoch_s = [(e["fold"], e["epoch_seconds"]) for e in ev if e["epoch"] > 2]
        peak = side_by_side("COLLAB multi", cfg, epoch_s)
        out["collab"] = {"calls": got, "kernel_launches": kern, "regimes": regimes,
                         "slot_floors": start["slot_floors"], "epoch_s": epoch_s,
                         "peak_mib": peak}
    return out


def bf16_runners(nci1, nci1_model16, t_main, ctx, lctx, dd_model16, dd_dev16, device,
                 graphs):
    """Phase 6's bf16 epoch graphs, built as the drivers build them: NCI1's
    10-fold lockstep runner over the dataset stored in bf16, and DD's
    10-fold block lockstep runner over the bf16 pool (bf16 models)."""
    from dgcnn_tpu_torch.batching.dense import build_dense_dataset

    data = build_dense_dataset(nci1, t_main, device, "float32", "bfloat16")
    return {"lockstep bf16": epoch_runners(nci1, nci1_model16, t_main, device, graphs,
                                           data=data)["lockstep"],
            "DD block lockstep bf16": dd_lockstep_runners(
                ctx, lctx, dd_model16, device, graphs, dev=dd_dev16)["DD block lockstep"]}


# -- phase 4h: resume and inference on the card -------------------------------


class Crash(RuntimeError):
    """Raised by phase 4h's event log to crash a run at an epoch."""


@contextlib.contextmanager
def crash_and_time_saves(epoch, fold, saves):
    """Within: the event log raises `Crash` at the `epoch` event (of
    `fold`; events come before the chunk's in-flight bundle), and every
    bundle the drivers write is timed into `saves` as (name, seconds)."""
    from dgcnn_tpu_torch.train import cv, cv_vmap

    real_write, real_saves = cv.EventLog.write, {m: m.save_checkpoint for m in (cv, cv_vmap)}

    def write(self, **event):
        if event.get("kind") == "epoch" and event["epoch"] == epoch and (
                fold is None or event["fold"] == fold):
            raise Crash(f"epoch {epoch}")
        return real_write(self, **event)

    def timed(real):
        def save(path, bundle):
            t0 = time.perf_counter()
            real(path, bundle)
            saves.append((os.path.basename(path), time.perf_counter() - t0))
        return save

    cv.EventLog.write = write
    for m, real in real_saves.items():
        m.save_checkpoint = timed(real)
    try:
        yield
    finally:
        cv.EventLog.write = real_write
        for m, real in real_saves.items():
            m.save_checkpoint = real


def resumed_run(tmp, label, ref, crash_epoch, crash_fold=None):
    """The run of `KEPT[ref]` again with `checkpoint_every` 2, crashed at
    the `crash_epoch` event (of `crash_fold`), then resumed
    (`checkpoint_resume`), graphed: every fold's CSV byte for byte and its
    `epochs/` bundle bit for bit the uninterrupted graphed run's, the
    in-flight bundle and the floors file gone. Returns the in-flight saves'
    seconds and the crashed run's fold-epoch seconds of fold 1's chunks
    1 and 2 (those it logged before the crash)."""
    want = KEPT[ref]
    cfg = dataclasses.replace(want, statistics_dir=os.path.join(tmp, label, "statistics"),
                              epochs_dir=os.path.join(tmp, label, "epochs"),
                              checkpoint_every=2)
    saves = []
    with crash_and_time_saves(crash_epoch, crash_fold, saves):
        try:
            run_cv(cfg, True)
        except Crash:
            pass
        else:
            raise AssertionError(f"{label}: the run did not crash")
    crashed = epoch_events(cfg)
    inflight = [n for n in os.listdir(cfg.epochs_dir) if "inflight" in n]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, wall = run_cv(dataclasses.replace(cfg, checkpoint_resume=True), True)
    said = [ln for ln in out.getvalue().splitlines() if "resumed" in ln]
    if not said:
        raise AssertionError(f"{label}: the resumed run said nothing of a resume")
    for f in range(1, cfg.num_folds + 1):
        name = f"{cfg.data_type}_results_{f}.csv"
        with open(os.path.join(cfg.statistics_dir, name), "rb") as a, \
                open(os.path.join(want.statistics_dir, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{label}: fold {f}'s CSV differs from the "
                                     f"uninterrupted run's")
    same_bits(f"{label}: resumed vs uninterrupted rows", fold_rows(cfg), fold_rows(want))
    same_bits(f"{label}: resumed vs uninterrupted epochs/ bundles", bundles(cfg),
              bundles(want))
    left = sorted(n for n in os.listdir(cfg.epochs_dir) if "inflight" in n or "floors" in n)
    if left:
        raise AssertionError(f"{label}: {left} left behind")
    fold_epoch_s = {c: [e["epoch_seconds"] / e.get("folds_in_lockstep", 1)
                        for e in crashed if e["fold"] == 1 and (e["epoch"] + 1) // 2 == c]
                    for c in (1, 2)}
    inflight_s = [t for n, t in saves if "inflight" in n]
    log(f"  {label}: crashed at epoch {crash_epoch}"
        f"{'' if crash_fold is None else f' of fold {crash_fold}'} with {inflight} on "
        f"disk; resumed ({'; '.join(said)}) in {wall:.1f} s: every fold's CSV byte for "
        f"byte, rows and epochs/ bundles bitwise the uninterrupted graphed run's ({ref}); "
        f"in-flight saves {[round(t, 4) for t in inflight_s]} s; fold 1's fold-epoch "
        f"seconds with --ckpt_every 2, chunk 1 {fold_epoch_s[1]}, chunk 2 "
        f"{fold_epoch_s[2]}")
    return {"inflight_save_s": inflight_s, "epoch_s": fold_epoch_s}


def sort_tie_flips(name, params, model, gs, graphs):
    """Raise unless the card's and the CPU's log-probs of each graph in
    `graphs` part only where the sort-pool order of near-tied keys does:
    on the graph's batch, every GCN layer's output over its nodes agrees
    within rel 1e-4 of its largest value, and at every rank below k where
    the two devices' stable orders of its keys differ, the CPU's keys of
    the two nodes there are within 4 ulp of each other (which of two
    nearly equal keys sorts first is decided by their last bit's
    rounding, and a swap moves whole rows of the pooled tensor). Returns
    the (graph, rank, the two keys on the CPU, the layers' worst rel) of
    each first difference."""
    from dgcnn_tpu_torch.batching.dense import order_matrix
    from dgcnn_tpu_torch.batching.device_coo import (
        build_device_graphset, device_graphset_to, gather_coo_batch)
    from dgcnn_tpu_torch.batching.packer import compute_bucket
    from dgcnn_tpu_torch.models.dgcnn import _map, apply_coo

    if not len(graphs):
        return []
    bucket = compute_bucket(gs, 50)
    order = order_matrix(np.arange(gs.num_graphs, dtype=np.int32), 50, bucket.num_graphs)
    host = build_device_graphset(gs)
    sets = {dev: device_graphset_to(host, dev) for dev in ("cpu", "cuda")}
    flips = []
    for g in graphs:
        acts = {}
        for dev in ("cpu", "cuda"):
            batch = gather_coo_batch(sets[dev], torch.from_numpy(order[g // 50]).to(dev),
                                     bucket)
            with torch.no_grad():
                _, a = apply_coo(_map(params, lambda t: t.to(dev)), model, batch,
                                 return_activations=True)
            acts[dev] = {k: v.cpu() for k, v in a.items()}
            nodes = (batch.node_graph.cpu() == int(np.flatnonzero(order[g // 50] == g)[0])
                     ).nonzero().flatten()
        worst = 0.0
        for layer in ("gcn1", "gcn2", "gcn3", "gcn4"):
            err, rel, ok = rel_err(acts["cuda"][layer][nodes], acts["cpu"][layer][nodes])
            worst = max(worst, rel)
            if not ok:
                raise AssertionError(f"{name} inference, graph {g}: {layer} card vs CPU "
                                     f"max abs {err:.3e}")
        kc, kg = acts["cpu"]["gcn4"][nodes, -1], acts["cuda"]["gcn4"][nodes, -1]
        oc = torch.sort(kc, descending=True, stable=True).indices[:model.sort_pool_k]
        og = torch.sort(kg, descending=True, stable=True).indices[:model.sort_pool_k]
        where = (oc != og).nonzero().flatten().tolist()
        if not where:
            raise AssertionError(f"{name} inference, graph {g}: log-probs differ with the "
                                 f"same sort-pool order")
        for i in where:
            a, b = kc[oc[i]].item(), kc[og[i]].item()
            if abs(a - b) > 4 * np.spacing(np.float32(abs(a))):
                raise AssertionError(f"{name} inference, graph {g}: rank {i} holds node "
                                     f"{oc[i].item()} (key {a!r}) on the CPU and node "
                                     f"{og[i].item()} (key {b!r}) on the card")
        flips.append((int(g), where[0], kc[oc[where[0]]].item(), kc[og[where[0]]].item(),
                      worst))
    return flips


def card_inference(name, gs, bundle, counters):
    """`predict_dataset` of synthetic `name` from a fold bundle of phase 4's
    runs, on the card: graphed (the row kernel's counts set to 0 just
    before and read just after: 3 launches at F=32 and 1 at F=1 a batch,
    nothing on the other kernels) against eager (bitwise) and the CPU
    (every graph within rel 1e-4 of the largest log-prob, or its
    difference a sort-pool near-tie that `sort_tie_flips` finds); then
    the runner built directly: one replay under
    `set_sync_debug_mode("error")`, and the steady rate of a pass of
    replays. Returns the launches and rates."""
    from dgcnn_tpu_torch.infer import load_fold_params, make_infer_run, predict_dataset
    from dgcnn_tpu_torch.models.dgcnn import DGCNN

    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    params = load_fold_params(bundle, model)
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, labels = predict_dataset(params, model, gs, 50, device="cuda")
    wall = time.perf_counter() - t0
    counts = {k: (c.fwd_launches, c.bwd_launches, c.f1_fwd) for k, c in counters.items()}
    steps = -(-gs.num_graphs // 50)
    want = {k: (4 * steps, 0, steps) if k == "spmm_rows" else (0, 0, 0) for k in counters}
    if counts != want:
        raise AssertionError(f"{name} inference: launches (fwd, bwd, F=1 fwd) {counts}, "
                             f"expected {want}")
    lp_e, _ = predict_dataset(params, model, gs, 50, device="cuda", graphs=False)
    same_bits(f"{name} inference: graphed vs eager log-probs", [lp], [lp_e])
    lp_c, labels_c = predict_dataset(params, model, gs, 50, device="cpu")
    if not np.isfinite(lp).all() or lp.shape != (gs.num_graphs, gs.num_classes):
        raise AssertionError(f"{name} inference: log-probs of shape {lp.shape}, finite "
                             f"{np.isfinite(lp).all()}")
    off = np.abs(lp - lp_c).max(axis=-1) > ATOL + RTOL * np.abs(lp_c).max()
    flips = sort_tie_flips(name, params, model, gs, np.flatnonzero(off))
    err, rel, _ = rel_err(torch.from_numpy(lp[~off]), torch.from_numpy(lp_c[~off]))
    runner, order2d = make_infer_run(params, model, gs, 50, device="cuda")
    runner.run_epochs(order2d[:1])  # the warm-up and the capture
    runner.order.copy_(torch.from_numpy(order2d[0]).cuda())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows = runner.graph.per_replay[[c is counters["spmm_rows"] for c in
                                    runner.graph.counters].index(True)]
    if (rows["fwd_launches"], rows["f1_fwd"], rows["bwd_launches"]) != (4, 1, 0):
        raise AssertionError(f"{name} inference: row-kernel launches per replay {rows}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run_epochs(order2d)  # every batch a replay
    steady = time.perf_counter() - t0
    from dgcnn_tpu_torch.batching.device_coo import (
        build_device_graphset, device_graphset_to, gather_coo_batch)
    from dgcnn_tpu_torch.batching.packer import compute_bucket

    # the median batch by edges, for phase 5's times of the row kernel
    edges = [int(gs.edge_counts()[r[r >= 0]].sum()) for r in order2d]
    median = int(np.argsort(edges, kind="stable")[len(edges) // 2])
    dset = device_graphset_to(build_device_graphset(gs), "cuda")
    case = SpmmCase(gather_coo_batch(dset, torch.from_numpy(order2d[median]).cuda(),
                                     compute_bucket(gs, 50)), seed=median, device="cuda")
    out = {"graphs": gs.num_graphs, "batches": steps, "launches": counts["spmm_rows"],
           "call_s": wall, "graphs_per_s_call": gs.num_graphs / wall,
           "replays_s": steady, "graphs_per_s": gs.num_graphs / steady,
           "card_vs_cpu_rel": rel, "sort_tie_flips": flips,
           "labels_agree": float((labels == labels_c).mean()),
           "median_batch": median, "case": case}
    log(f"  {name} inference ({gs.num_graphs} graphs, {steps} batches of 50, fold 1's "
        f"bundle): row-kernel launches (fwd, bwd, F=1) {counts['spmm_rows']}, 3 at F=32 "
        f"and 1 at F=1 a replay, none on the other kernels; graphed bitwise eager; card "
        f"vs CPU worst rel {rel:.3e} over {gs.num_graphs - len(flips)} graphs; {len(flips)} "
        f"graphs apart by a sort-pool near-tie (graph, rank, the two keys on the CPU, "
        f"its GCN layers' worst rel card vs CPU): "
        f"{flips}; labels agree on {out['labels_agree']:.4f}; one "
        f"replay ran under set_sync_debug_mode('error'); {gs.num_graphs / steady:.0f} "
        f"graphs/s over a pass of replays ({steady:.4f} s), {gs.num_graphs / wall:.0f} "
        f"graphs/s for the whole call ({wall:.3f} s: graphset, warm-up, capture)")
    return out


def resume_and_infer(nci1, dd):
    """Phase 4h: the resumed runs (`resumed_run`) against phases 4a, 4e
    and 4c's graphed runs, then inference from their bundles
    (`card_inference`)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # crashed at epoch 4: the events of epoch 3 (chunk 2) are logged,
        # the bundle on disk is still epoch 2's
        out["NCI1 lockstep"] = resumed_run(tmp, "nci1_lockstep", "NCI1 lockstep", 4)
        out["DD block lockstep"] = resumed_run(tmp, "dd_lockstep", "DD block lockstep", 4)
        out["DD COO mid-fold"] = resumed_run(tmp, "dd_coo_mid", "DD COO", 3, crash_fold=2)
        out["DD COO fresh fold"] = resumed_run(tmp, "dd_coo_fresh", "DD COO", 1,
                                               crash_fold=2)
    counters = spmm_counters()
    out["infer"] = {
        "NCI1": card_inference("NCI1", nci1, os.path.join(
            KEPT["NCI1 lockstep"].epochs_dir, "NCI1_1"), counters),
        "DD": card_inference("DD", dd, os.path.join(
            KEPT["DD block lockstep"].epochs_dir, "DD_1"), counters)}
    return out


# -- phase 4i: bf16 COO, the native packer, the harness and the entry -------


@contextlib.contextmanager
def engines_made():
    """The engines `run_cross_validation` makes while the block runs
    (`train/cv.py make_engine` wrapped)."""
    from dgcnn_tpu_torch.train import cv

    made, make = [], cv.make_engine

    def spy(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    cv.make_engine = spy
    try:
        yield made
    finally:
        cv.make_engine = make


def coo_bf16_main_path(gs, counters, spmm_auto, fp32):
    """Phase 4i (a): synthetic DD `--layout coo --dtype bfloat16`, 2 folds
    x 4 epochs in chunks of `max_fused_epochs` 2, under `--spmm auto`
    (`DeviceCooEngine`, the row kernel) and `--spmm pallas` (`CooEngine`,
    host-packed, the block-COO kernel), each graphed with the counts set to
    0 just before and read just after, then eager
    (`sparse_graphed_vs_eager`: launches exact per replay, rows and
    bundles bitwise). The SpMM kernels run fp32 as under fp32 compute (the
    reference's COO path never hands them bf16), so their launch counts
    are the fp32 run's. Fold-epoch seconds of chunk 2 and the run's peak
    memory beside phase 4c's fp32 run of the same path (`fp32`: name →
    (graphed chunk-2 fold-epoch seconds, peak MiB))."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("auto", "pallas"):
            used = SPMM_KERNEL_OF[spmm_auto if name == "auto" else name]
            label = f"DD COO bf16 {name}"
            with engines_made() as made:
                n, f1, ev, ev_e, _ = sparse_graphed_vs_eager(
                    tmp, label, "DD", gs, 2, 4, counters, used, "coo",
                    layout="coo", spmm_impl=name, compute_dtype="bfloat16")
            kinds = sorted({type(e).__name__ for e in made})
            want = "CooEngine" if name == "pallas" else "DeviceCooEngine"
            if kinds != [want]:
                raise AssertionError(f"{label}: engines {kinds}, expected {want}")
            peak = PEAK_MIB[os.path.join(tmp, label, "statistics")]
            epoch_s = [(e["fold"], e["epoch_seconds"]) for e in ev if e["epoch"] > 2]
            s32, p32 = fp32[name]
            log(f"  {label} ({want}, {used}): fold-epoch seconds of chunk 2 graphed "
                f"bf16 {epoch_s} against fp32 {s32}; peak memory of the run bf16 "
                f"{peak:.1f} MiB against fp32 {p32:.1f} MiB; launches {n}, of width 1 "
                f"{f1}: the fp32 run's counts")
            out[name] = {"launches": n, "f1": f1, "epoch_s": epoch_s, "peak_mib": peak,
                         "eager_epoch_s": [(e["fold"], e["epoch_seconds"]) for e in ev_e
                                           if e["epoch"] > 2]}
    return out


def native_packer(engines, data_type="DD"):
    """Phase 4i (b): the C++ packer on the card's host. It must build; every
    `CooEngine` of phase 4c's runs (`engines`) must have packed every epoch
    with it (`CooEngine.packed`); one `data_type` epoch of the last fold's
    training graphs in a shuffled order, packed both ways, byte-equal;
    the seconds of each pack (best of 3) and of `add_blockcoo` (the block
    structures `--spmm pallas` adds, NumPy in both packages) on it."""
    from dgcnn_tpu_torch import native
    from dgcnn_tpu_torch.batching.packer import ARRAY_FIELDS, add_blockcoo, pack_epoch
    from dgcnn_tpu_torch.train.cv import CooEngine

    if not native.native_available():
        raise AssertionError(f"the native packer did not build: {native.build_error()}")
    host = [e for e in engines if isinstance(e, CooEngine)]
    if not host:
        raise AssertionError("phase 4c made no CooEngine")
    for e in host:
        if e.packed["native"] == 0 or e.packed["numpy"] != 0:
            raise AssertionError(f"{e.cfg.data_type} CooEngine packed {e.packed}")
    log("  every CooEngine of phase 4c packed through the native packer: " + "; ".join(
        f"{e.cfg.data_type} {e.packed['native']} epochs, pack {e.pack_seconds['pack']:.3f}"
        f" s, add_blockcoo {e.pack_seconds['blockcoo']:.3f} s in all" for e in host))
    engine = next(e for e in host if e.cfg.data_type == data_type)
    ds = engine._train_set
    order = np.random.default_rng(0).permutation(ds.num_graphs)
    secs, epochs = {}, {}
    for backend in ("native", "numpy"):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            epochs[backend] = pack_epoch(ds, order, engine.cfg.batch_size, engine.bucket,
                                         backend)
            times.append(time.perf_counter() - t0)
        secs[backend] = min(times)
    for name in ARRAY_FIELDS:
        a, b = (np.asarray(getattr(epochs[k], name)) for k in ("native", "numpy"))
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise AssertionError(f"native vs NumPy packing: {name} differs")
    t0 = time.perf_counter()
    add_blockcoo(epochs["native"])
    secs["add_blockcoo"] = time.perf_counter() - t0
    steps = -(-len(order) // engine.cfg.batch_size)
    log(f"  one {data_type} epoch ({ds.num_graphs} graphs, {steps} batches of bucket "
        f"{engine.bucket}) packed both ways, byte-equal: native "
        f"{secs['native']:.4f} s, NumPy {secs['numpy']:.4f} s (best of 3, host clock), "
        f"add_blockcoo {secs['add_blockcoo']:.4f} s")
    return secs


def harness_cli(*args):
    """`python -m dgcnn_tpu_torch.parity.harness *args` in a fresh process
    (the repository root on its path); its standard output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.parity.harness", *args],
                         env=env, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise AssertionError(f"harness {args[0]} exited {res.returncode}:\n{res.stdout}"
                             f"\n{res.stderr}")
    return res.stdout


def harness_and_entry(device):
    """Phase 4i (c): the parity harness's CLI as a user runs it, each step a
    fresh process: `dump` of the CLI's batch (synthetic MUTAG's first 50
    graphs, one COO batch, weights seeded 0) on the card, `dump --platform
    cpu` of the same graphs with the card dump's weights (`--weights`),
    then `compare` at its defaults (rtol 1e-4, atol 1e-5); this process's
    `dump_activations` on the card against the card dump under
    `compare_dumps`. (The CPU side runs in a process of its own: in one
    chip run, the CPU side of this check, run in a process that had
    already used the card, gave these activations ~5e-5 relative away from
    the bits every other CPU run gives, PERF.md §7 item 12.) The same CPU
    dump made in this process is reported beside it, not checked: its max
    abs by stage against the fresh process's and the card's, and both
    CPU dumps' digests. Then `graft_entry.entry()` on the card,
    eager against `torch.compile` (the default backend): allclose at rtol
    1e-5, and the compiled forward launched the row kernel as many times
    as the eager one."""
    from dgcnn_tpu_torch.batching.packer import compute_bucket, pack_batch
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.graft_entry import entry
    from dgcnn_tpu_torch.kernels import spmm_pallas
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, init_params
    from dgcnn_tpu_torch.parity.harness import _load_acts, compare_dumps, dump_activations
    from dgcnn_tpu_torch.tools.probe_repeat import digest

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        card, cpu = os.path.join(tmp, "card.npz"), os.path.join(tmp, "cpu.npz")
        common = ["--data_type", "MUTAG", "--synthetic", "--num_graphs", "50", "--seed",
                  "0", "--data_root", os.path.join(tmp, "data")]
        t0 = time.perf_counter()
        harness_cli("dump", "--out", card, *common)
        harness_cli("dump", "--out", cpu, "--weights", card, "--platform", "cpu", *common)
        said = harness_cli("compare", card, cpu)
        if "PARITY OK" not in said:
            raise AssertionError(f"harness compare: {said}")
        a, b = _load_acts(card), _load_acts(cpu)
        out["cli"] = {k: float(np.abs(a[k] - b[k]).max()) for k in a}
        log(f"  parity harness CLI (fresh processes, {time.perf_counter() - t0:.1f} s): "
            f"dump MUTAG's first 50 graphs (COO) on the card, dump them on the CPU with "
            f"its weights, compare at rtol 1e-4 / atol 1e-5: PARITY OK; max abs card vs "
            f"CPU by stage {out['cli']}")
        mutag = synthesize_tu_dataset("MUTAG")
        model = DGCNN(num_features=mutag.num_features, num_classes=mutag.num_classes)
        batch = pack_batch(mutag, np.arange(50), compute_bucket(mutag, 50))
        here = dump_activations(init_params(torch.Generator().manual_seed(0), model), model,
                                batch)
        report = compare_dumps(here, a)
        log(f"  dump_activations on the card in this process against the CLI's card "
            f"dump: max abs by stage {report}; fp32 matmul error now {fp32_matmul_error()}")
        # reported, not checked: the CPU side in this process, the evidence
        # PERF.md §7 item 12 asks of every run
        cpu_here = dump_activations(init_params(torch.Generator().manual_seed(0), model),
                                    model, batch, device="cpu")
        stages = sorted(set(cpu_here) & set(b))

        def bits(d):
            return digest([(k, torch.from_numpy(np.ascontiguousarray(d[k]))) for k in stages])

        out["in_process_cpu"] = {
            "vs_fresh_cpu": {k: float(np.abs(cpu_here[k] - b[k]).max()) for k in stages},
            "vs_card": {k: float(np.abs(cpu_here[k] - a[k]).max()) for k in stages},
            "digest": bits(cpu_here), "fresh_digest": bits(b)}
        log(f"  (report only) dump_activations on the CPU in this process: max abs by "
            f"stage against the fresh process's CPU dump "
            f"{out['in_process_cpu']['vs_fresh_cpu']}, against the card dump "
            f"{out['in_process_cpu']['vs_card']}; digests (tools/probe_repeat.py) this "
            f"process {out['in_process_cpu']['digest']}, fresh process "
            f"{out['in_process_cpu']['fresh_digest']}")
    fn, args = entry()
    explained = torch._dynamo.explain(fn)(*args)
    torch._dynamo.reset()
    spmm_pallas.rows_launches.reset()
    want = fn(*args)
    torch.cuda.synchronize()
    eager_n = spmm_pallas.rows_launches.fwd_launches
    compiled = torch.compile(fn)
    t0 = time.perf_counter()
    spmm_pallas.rows_launches.reset()
    got = compiled(*args)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    compiled_n = spmm_pallas.rows_launches.fwd_launches
    if eager_n != 4 or compiled_n != eager_n:
        raise AssertionError(f"entry(): row-kernel launches eager {eager_n}, compiled "
                             f"{compiled_n}, expected 4 each")
    if not torch.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"entry(): torch.compile vs eager max abs "
                             f"{(got - want).abs().max().item():.3e}")
    log(f"  graft_entry.entry() on the card: log-probs {tuple(want.shape)}, "
        f"torch.compile (default backend, {compile_s:.1f} s with the compile) allclose "
        f"eager at rtol 1e-5 (max abs {(got - want).abs().max().item():.3e}); row-kernel "
        f"launches eager {eager_n}, compiled {compiled_n}; torch._dynamo.explain: "
        f"{explained.graph_count} graph(s), {explained.graph_break_count} break(s)")
    out["entry"] = {"compile_s": compile_s, "launches": compiled_n,
                    "graphs": explained.graph_count, "breaks": explained.graph_break_count}
    return out


# -- phase 6: one profiled train step ---------------------------------------


def profile_step(name, step, by_op=False, unit="train step"):
    """`step()` runs one train step (or one `unit`): 3 warm-ups, the host
    clock over 10 steps, then one step under torch.profiler (device-side
    events). `by_op` also lists the ATen ops that launched the most
    device time, with their input shapes."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=by_op) as prof:
        step()
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
    log(f"  {name} {unit}: wall median {np.median(walls):.3f} ms "
        f"(min {min(walls):.3f}, host clock, 10 of them); profiler device time "
        f"{total / 1e3:.3f} ms over {sum(e.count for e in kernels)} kernel launches")
    if total == 0:
        log("  the profiler recorded no device time on this machine")
    for e in kernels[:10]:
        log(f"    {self_dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if by_op:
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if getattr(e, "device_type", None) == DeviceType.CPU
                      and e.key.startswith("aten::")),
                     key=self_dev_us, reverse=True)
        log(f"  {name}: ATen ops by the device time they launched")
        for e in ops[:8]:
            log(f"    {self_dev_us(e) / 1e3:8.3f} ms  x{e.count:<4d} {e.key} "
                f"{e.input_shapes}")
    return float(np.median(walls)), total / 1e3, sum(e.count for e in kernels)


def profile_epoch(name, r, eager_step):
    """Phase 6: one epoch of a graphed fused runner (one replay): its wall
    time by the host clock (`run_epochs` of one epoch: the order's copy
    in, the replay, the rows' copy out), its device time by torch.profiler
    (`profile_step`) and the replay alone between two CUDA events; each
    over the epoch's train + eval steps beside the eager train step
    `eager_step` (wall, device, launches) measured in this run; the
    device's idle share, 1 − device / wall."""
    runner, orders, steps = r["runner"], r["orders"], r["steps"]
    one = orders[2:3]
    wall, dev, launches = profile_step(f"{name} epoch graph ({steps} steps)",
                                       lambda: runner.run_epochs(one),
                                       unit="epoch (one replay)")
    runner.order.copy_(torch.from_numpy(one[0]).to(runner.order.device))
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    runner.graph.replay()
    e1.record()
    torch.cuda.synchronize()
    replay = e0.elapsed_time(e1)
    idle = 1.0 - dev / wall if dev > 0 else 1.0 - replay / wall
    log(f"  {name} epoch graph: wall {wall:.3f} ms, device {dev:.3f} ms (replay "
        f"between events {replay:.3f} ms), {launches} launches; per step: wall "
        f"{wall / steps:.4f} ms, device {dev / steps:.4f} ms; device idle "
        f"{100 * idle:.1f} %; the eager train step in this run: wall "
        f"{eager_step[0]:.3f} ms, device {eager_step[1]:.4f} ms, idle "
        f"{100 * (1 - eager_step[1] / eager_step[0]):.1f} %; capture "
        f"{r['capture_s']:.3f} s; peak memory over 3 epochs eager "
        f"{r['peak_eager_mib']:.1f} MiB, graphed {r['peak_graphed_mib']:.1f} MiB")
    return {"wall_ms": wall, "device_ms": dev, "replay_ms": replay, "launches": launches,
            "steps": steps, "idle": idle, "capture_s": r["capture_s"]}


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
    log(f"host CPU (the CPU side of the card-vs-CPU checks): {host_cpu()}, "
        f"{os.cpu_count()} cores, {torch.get_num_threads()} torch threads")
    log(f"fp32 matmul, 512 x 512 standard normal, max abs from float64: "
        f"{fp32_matmul_error()} (IEEE fp32 ~3e-5, TF32 ~1e-2); environment "
        f"{ {k: v for k, v in os.environ.items() if 'TF32' in k or 'CUBLAS' in k} }")

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
    lock_shapes = check_lockstep_trunk(datasets, device, dt, stats)
    collab = CollabContext(device)
    SYNTH["COLLAB"] = collab.gs
    if collab.layout != "multi" or collab.tiles != (256, 464):
        raise AssertionError(f"choose_layout gave {collab.layout}, tiles {collab.tiles} "
                             f"for COLLAB, not multi at (256, 464)")
    check_collab_trunk(collab, device, dt, stats)
    multi_lock_shapes = check_collab_lockstep_trunk(collab, device, dt, stats)
    t_prot = dense_tile(datasets["PROTEINS"])
    log("  -- the bf16 mode (a bf16 adjacency; round_h: bf16 compute)")
    cap16 = check_trunk_bf16(shapes, lock_shapes, collab, t_main, t_prot, device, dt, stats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("== phase 3b: block kernels vs plain version on the card")
    ctx = DDContext(device)
    SYNTH["DD"] = ctx.gs
    if ctx.layout != "block":
        raise AssertionError(f"choose_layout gave {ctx.layout} for DD, not block")
    check_blocks(ctx, device, stats)
    lctx = DDLockstepContext(ctx)
    check_lockstep_blocks(lctx, device, stats)
    log("  -- the bf16 mode (bf16 pool and hb)")
    pool16 = ctx.pool.to(torch.bfloat16)
    check_blocks_bf16(ctx, lctx, pool16, device, stats)

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
    for key, case in edge_block_cases(device).items():
        compare_spmm(f"{key} ({case.e_real} real edges of {case.src.shape[0]}, N "
                     f"{case.n}; a row's positions span at most {case.spans} blocks "
                     f"fwd, bwd; edge-stream kernels only)", case, device, stats)

    log(f"== phase 4a: main path, synthetic NCI1, layout auto (dense), "
        f"{FOLDS} folds x 4 epochs in lockstep (cv_parallel auto) in chunks of "
        f"max_fused_epochs 2, graphed then eager; the sequential driver, {FOLDS} "
        f"folds x 2 epochs, and PROTEINS lockstep {FOLDS} x 2, each graphed then "
        f"eager; the fused runners' sync and graphed-vs-eager checks")
    log(card)
    from dgcnn_tpu_torch.batching.dense import batch_to_device
    from dgcnn_tpu_torch.config import Config
    from dgcnn_tpu_torch.models.dgcnn import DGCNN

    nci1 = datasets["NCI1"]
    nci1_model = DGCNN(num_features=nci1.num_features, num_classes=nci1.num_classes)
    lock = lockstep_main_path(nci1, t_main, dt)
    trunk_fwd_n, trunk_bwd_n = lock["trunk_launches"]
    new_stream_workspace(device)
    runners = check_runners(lambda graphs: epoch_runners(nci1, nci1_model, t_main,
                                                         device, graphs))

    lock_parts = lockstep_parts(nci1, t_main, "NCI1")
    lock_host = stack_batches(lock_parts)
    check_lockstep_dropout(nci1_model, lock_parts, device)
    card_vs_cpu(f"NCI1 lockstep batch ({FOLDS} folds x {S} slots)",
                lambda dev: (batch_to_device(lock_host, dev), {}), nci1_model, folds=True)
    from dgcnn_tpu_torch.batching.dense import pack_dense_batch

    nci1_host = pack_dense_batch(nci1, np.arange(100, 150), t_main, S)
    card_vs_cpu("NCI1 dense batch",
                lambda dev: (batch_to_device(nci1_host, dev), {}), nci1_model)

    auto_impl = Config().resolved_block_impl()
    other_impl = {"pallas": "xla", "xla": "pallas"}[auto_impl]
    kernel_of = {"pallas": "block_csr", "xla": "block_resident"}
    log(f"== phase 4b: main path, synthetic DD, layout auto (block, block_impl "
        f"auto = {auto_impl}), the folds one after another (cv_parallel sequential), "
        f"2 folds x 4 epochs in chunks of max_fused_epochs 2, graphed then eager; "
        f"block_impl {other_impl}, 1 fold x 3 epochs, the same")
    log(card)
    mods = {k: m for k, (m, _) in block_kernels().items()}
    dd_launches, dd_events, dd_rows = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl, folds_n, epochs in ((auto_impl, 2, 4), (other_impl, 1, 3)):
            used = kernel_of[impl]
            n, f1, ev, ev_e, dd_rows[impl] = sparse_graphed_vs_eager(
                tmp, f"DD block {impl}", "DD", ctx.gs, folds_n, epochs,
                {k: m.launches for k, m in mods.items()}, used, "block",
                cv_parallel="sequential",
                **({} if impl == auto_impl else {"block_impl": impl}))
            dd_launches[used], dd_launches[used + "_f1"] = n, f1
            dd_events[impl] = (ev, ev_e)
    dd_epoch_s = [e["epoch_seconds"] for e in dd_events[auto_impl][0]]
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
        f"(= {spmm_auto}) 2 folds x 4 epochs, --spmm {spmm_other} 1 x 3, --spmm "
        f"pallas 2 x 4; synthetic NCI1 --layout coo --spmm pallas 1 x 2; each in "
        f"chunks of max_fused_epochs 2, graphed then eager")
    log(card)
    counters = spmm_counters()
    coo_launches, coo_epoch_s, coo_fp32 = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp, engines_made() as coo_engines:
        for data_type, impl, name, folds_n, epochs in (
            ("DD", spmm_auto, "auto", 2, 4),
            ("DD", spmm_other, spmm_other, 1, 3),
            ("DD", "pallas", "pallas", 2, 4),
            ("NCI1", "pallas", "pallas", 1, 2),
        ):
            used = SPMM_KERNEL_OF[impl]
            gs = ctx.gs if data_type == "DD" else nci1
            label = f"{data_type} COO {name}"
            n, f1, ev, ev_e, _ = sparse_graphed_vs_eager(
                tmp, label, data_type, gs, folds_n, epochs, counters,
                used, "coo", keep="DD COO" if (data_type, name) == ("DD", "auto") else None,
                layout="coo", spmm_impl=name)
            if data_type == "DD" and used not in coo_launches:
                coo_launches[used], coo_launches[used + "_f1"] = n, f1
            coo_epoch_s[(data_type, name)] = ([e["epoch_seconds"] for e in ev],
                                              [e["epoch_seconds"] for e in ev_e])
            if data_type == "DD":  # phase 4i's fp32 side: chunk 2's seconds, the peak
                coo_fp32[name] = ([(e["fold"], e["epoch_seconds"]) for e in ev
                                   if e["epoch"] > 2],
                                  PEAK_MIB[os.path.join(tmp, label, "statistics")])

    log("== phases 4b-4c: the block and COO fused runners built directly, a "
        "forced budget growth")
    log(card)
    check_sync_only(ctx, dd_coo, nci1, dd_model, nci1_model, device,
                    (other_impl, spmm_other))
    runners.update(check_runners(lambda graphs: sparse_runners(
        ctx, dd_coo, dd_model, device, graphs)))
    forced_growth("DD block", ctx.engine, ctx.gs, {"floor_nb": 8, "floor_w": 64},
                  ctx.engine._block_counts, dd_model, device,
                  {k: m.launches for k, m in mods.items()})
    forced_growth("DD COO", dd_coo.engine, ctx.gs,
                  {"floor_nodes": dd_coo.engine.cfg.node_pad_multiple,
                   "floor_edges": dd_coo.engine.cfg.edge_pad_multiple},
                  dd_coo.engine._edge_counts, dd_model, device, counters)

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

    log(f"== phase 4e: main path, synthetic DD, block fold-lockstep: cv_parallel folds "
        f"2 folds x 4 epochs, then the default (auto) {FOLDS} folds x 4, in chunks of "
        f"max_fused_epochs 2, graphed then eager; the other block_impl {FOLDS} x 2; the "
        f"lockstep runner built directly; a forced budget growth")
    log(card)
    dd_counters = {k: m.launches for k, m in mods.items()}
    dd_lock = block_lockstep_main_path(ctx, dd_counters, dd_rows[auto_impl], auto_impl,
                                       other_impl)
    runners.update(check_runners(lambda graphs: dd_lockstep_runners(
        ctx, lctx, dd_model, device, graphs)))
    lockstep_forced_growth(ctx, lctx, dd_model, device, dd_counters)

    def dd_lock_batch(dev):
        from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch_folds

        gsd = ctx.engine.dev if dev == "cuda" else block_graphset_to_device(
            build_block_graphset(dd), "cpu")
        row = torch.from_numpy(lctx.order[lctx.mean_step]).to(dev)
        return (gather_block_batch_folds(gsd, row, lctx.nb, lctx.w),
                {"pool": gsd.pool, "block_impl": auto_impl})

    card_vs_cpu(f"DD block lockstep batch ({FOLDS} folds, merged mean step)",
                dd_lock_batch, dd_model, folds=True)

    log("== phase 4d: main path, synthetic COLLAB, layout auto (multi, tiles "
        f"{collab.tiles}: the trunk resident at T=256, streamed at T=464), 2 folds x 4 "
        "epochs in chunks of max_fused_epochs 2, graphed then eager; the runner "
        "built directly; a forced slot growth; --layout dense 1 x 4 for the record")
    log(card)
    collab_model = DGCNN(num_features=collab.gs.num_features,
                         num_classes=collab.gs.num_classes)
    multi = multi_main_path(collab, dt, device)
    runners.update(check_runners(lambda graphs: multi_runners(collab, collab_model,
                                                              device, graphs)))
    forced_growth("COLLAB multi", collab.engine, collab.gs,
                  {"slot_floor": collab.engine.slot_floor.copy()}, collab.gs.node_counts(),
                  collab_model, device,
                  {"gcn_trunk": dt.launches}, data_type="COLLAB")
    card_vs_cpu(f"COLLAB multi batch (fold 1's step {collab.step}, slots "
                f"{list(collab.slots)})",
                lambda dev: (collab.batch(dev), {}), collab_model)

    log("== phase 4f: main path, synthetic COLLAB, multi-tile fold-lockstep "
        "(cv_parallel folds), 2 folds x 4 epochs in chunks of max_fused_epochs 2, "
        "graphed then eager")
    log(card)
    multi_lock = multi_lockstep_main_path(collab, dt, multi["rows"])
    check_multi_lockstep_step(collab, collab_model, device)

    log("== phase 4g: mixed precision on the main paths: synthetic NCI1 --dtype "
        f"bfloat16 (dense, {FOLDS}-fold lockstep) {FOLDS} x 4, synthetic DD --dtype "
        f"bfloat16 (block, {FOLDS}-fold lockstep) {FOLDS} x 4 and --block_impl xla "
        f"{FOLDS} x 2, synthetic COLLAB --adj_dtype bfloat16 (multi, sequential) 2 x 4, "
        "in chunks of max_fused_epochs 2, graphed then eager; card vs CPU; the bf16 "
        "lockstep runners built directly")
    log(card)
    mp = bf16_main_paths(ctx, collab, nci1, dt, {
        "NCI1 lockstep": (lock["lockstep_epoch_s"], lock["peak_mib"]),
        "DD block lockstep": (dd_lock["ten_folds"]["epoch_s"],
                              dd_lock["ten_folds"]["peak_mib"]),
        "COLLAB multi": (multi["epoch_s"], multi["peak_mib"])})
    nci1_model16 = DGCNN(num_features=nci1.num_features, num_classes=nci1.num_classes,
                         compute_dtype="bfloat16")
    dd_model16 = DGCNN(num_features=dd.num_features, num_classes=dd.num_classes,
                       compute_dtype="bfloat16")
    card_vs_cpu(f"NCI1 lockstep batch, bf16 compute ({FOLDS} folds x {S} slots)",
                lambda dev: (bf16_batch(batch_to_device(lock_host, dev)), {}),
                nci1_model16, folds=True, rtol=1e-2)
    dd_cpu16 = block_graphset_to_device(build_block_graphset(dd), "cpu", "bfloat16")
    dd_dev16 = dataclasses.replace(ctx.engine.dev, pool=pool16)

    def dd_lock_batch16(dev):
        from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch_folds

        gsd = dd_dev16 if dev == "cuda" else dd_cpu16
        row = torch.from_numpy(lctx.order[lctx.mean_step]).to(dev)
        return (gather_block_batch_folds(gsd, row, lctx.nb, lctx.w),
                {"pool": gsd.pool, "block_impl": auto_impl})

    card_vs_cpu(f"DD block lockstep batch, bf16 compute ({FOLDS} folds, merged mean "
                f"step)", dd_lock_batch16, dd_model16, folds=True, rtol=1e-2)
    del dd_cpu16
    card_vs_cpu(f"COLLAB multi batch, bf16 adjacency (fold 1's step {collab.step})",
                lambda dev: (bf16_batch(collab.batch(dev)), {}), collab_model, rtol=1e-2)
    runners.update(check_runners(lambda graphs: bf16_runners(
        nci1, nci1_model16, t_main, ctx, lctx, dd_model16, dd_dev16, device, graphs)))

    log("== phase 4h: resume and inference on the card: NCI1 dense lockstep and DD "
        f"block lockstep {FOLDS} x 4 (crashed at epoch 4) and DD --layout coo 2 x 4 "
        "(crashed in fold 2 at epoch 3 and at epoch 1, before its first bundle), each "
        "with --ckpt_every 2, crashed and "
        "resumed, graphed, against phases 4a, 4e and 4c's runs; predict_dataset of "
        "synthetic NCI1 and DD from their fold 1 bundles")
    log(card)
    t4h = time.perf_counter()
    h = resume_and_infer(nci1, dd)
    log(f"  phase 4h took {time.perf_counter() - t4h:.1f} s")

    log("== phase 4i: synthetic DD --layout coo --dtype bfloat16 2 x 4 under --spmm "
        f"auto (= {spmm_auto}) and pallas, in chunks of max_fused_epochs 2, graphed "
        "then eager; card vs CPU; the native packer; the parity harness's dumps and "
        "graft_entry.entry() under torch.compile")
    log(card)
    t4i = time.perf_counter()
    coo16 = coo_bf16_main_path(ctx.gs, counters, spmm_auto, coo_fp32)
    card_vs_cpu(f"DD COO batch, bf16 compute (row {dd_coo.mean_row}, spmm_impl "
                f"{spmm_auto})", coo_batch(dd_coo, dd_coo.mean_row, spmm_auto),
                dd_model16, rtol=1e-2)
    card_vs_cpu(f"DD CooEngine batch, bf16 compute (row {dd_host.mean_row}, spmm_impl "
                f"pallas)", host_coo_batch(dd_host, dd_host.mean_row), dd_model16,
                rtol=1e-2)
    native_s = native_packer(coo_engines)
    log(f"  DD --spmm pallas (CooEngine, native packing) fold-epoch seconds of phase 4c: "
        f"graphed {coo_epoch_s[('DD', 'pallas')][0]}, eager "
        f"{coo_epoch_s[('DD', 'pallas')][1]}")
    parity = harness_and_entry(device)
    log(f"  phase 4i took {time.perf_counter() - t4i:.1f} s")

    log("== phase 5: device times (CUDA-graph replay, CUDA events)")
    log(card)
    flush = Flush(device)
    log(f"  L2 flush: {FLUSH_BYTES >> 20} MB write, {flush.ms:.4f} ms")
    trunk_times = {}
    timed = [(t, None) for t in (t_main, 112, t_prot, 624)] + [
        (t, dt.trunk_plan(S, t, DIMS, c=c)) for t in (t_main, t_prot) for c in dt.CLUSTERS]
    for t, plan in timed:
        row = trunk_times[(t, None if plan is None else plan.c)] = time_trunk(
            dt, *shapes[t], plan, flush, device)
        plain = (f" plain {row['fwd_plain']:.4f}" if plan is None else "",
                 f" plain {row['bwd_plain']:.4f}" if plan is None else "")
        log(f"  trunk S={S} T={t} {row['plan']}{' (forced)' if plan else ''}: fwd "
            f"kernel {row['fwd']:.4f} ms (flushed {row['fwd_flushed']:.4f}){plain[0]} "
            f"bound {row['bound_fwd']:.4f} ({row['bound_fwd_by']}) | bwd kernel "
            f"{row['bwd']:.4f} ms (flushed {row['bwd_flushed']:.4f}){plain[1]} bound "
            f"{row['bound_bwd']:.4f} ({row['bound_bwd_by']})")
    for t, (adj, mask) in lock_shapes.items():
        row = trunk_times[("lockstep", t)] = time_trunk(dt, adj, mask, None, flush,
                                                        device, folds=FOLDS)
        log(f"  trunk lockstep S={SL} K={FOLDS} T={t} {row['plan']}: fwd kernel "
            f"{row['fwd']:.4f} ms (flushed {row['fwd_flushed']:.4f}) plain "
            f"{row['fwd_plain']:.4f} bound {row['bound_fwd']:.4f} "
            f"({row['bound_fwd_by']}) | bwd kernel {row['bwd']:.4f} ms (flushed "
            f"{row['bwd_flushed']:.4f}) plain {row['bwd_plain']:.4f} bound "
            f"{row['bound_bwd']:.4f} ({row['bound_bwd_by']}); per fold fwd + bwd "
            f"{(row['fwd'] + row['bwd']) / FOLDS:.4f} ms")
    for name, adj, mask in multi_lock_shapes:
        row = trunk_times[("multi lockstep", adj.shape[1])] = time_trunk(
            dt, adj, mask, None, flush, device, folds=FOLDS)
        log(f"  trunk {name} {row['plan']}: fwd kernel {row['fwd']:.4f} ms (flushed "
            f"{row['fwd_flushed']:.4f}) plain {row['fwd_plain']:.4f} bound "
            f"{row['bound_fwd']:.4f} ({row['bound_fwd_by']}) | bwd kernel "
            f"{row['bwd']:.4f} ms (flushed {row['bwd_flushed']:.4f}) plain "
            f"{row['bwd_plain']:.4f} bound {row['bound_bwd']:.4f} "
            f"({row['bound_bwd_by']})")
    for name, adj, mask in collab.shapes(device):
        row = trunk_times[("multi", adj.shape[1])] = time_trunk(dt, adj, mask, None,
                                                                flush, device)
        log(f"  trunk {name} {row['plan']}: fwd kernel {row['fwd']:.4f} ms (flushed "
            f"{row['fwd_flushed']:.4f}) plain {row['fwd_plain']:.4f} bound "
            f"{row['bound_fwd']:.4f} ({row['bound_fwd_by']}) | bwd kernel "
            f"{row['bwd']:.4f} ms (flushed {row['bwd_flushed']:.4f}) plain "
            f"{row['bwd_plain']:.4f} bound {row['bound_bwd']:.4f} "
            f"({row['bound_bwd_by']})")
    for t in (t_main, 112, t_prot, 624):
        row = trunk_times[(t, None)]
        log(f"  trunk T={t}: below the plain chain forward "
            f"{'yes' if row['fwd'] < row['fwd_plain'] else 'NO'}, backward "
            f"{'yes' if row['bwd'] < row['bwd_plain'] else 'NO'}")
    for t in collab.tiles:
        a, b = trunk_times[("multi", t)], trunk_times[("multi lockstep", t)]
        log(f"  trunk T={t}: the {FOLDS}-fold lockstep class against {FOLDS} x the "
            f"one-fold class: fwd {b['fwd']:.4f} vs {FOLDS * a['fwd']:.4f} ms, bwd "
            f"{b['bwd']:.4f} vs {FOLDS * a['bwd']:.4f} ms")
    bf16_cases = [("bf16 lockstep", t_main, *lock_shapes[t_main], FOLDS, True),
                  ("bf16", t_main, *shapes[t_main], None, True),
                  ("bf16", 624, *shapes[624], None, True)] + [
        ("bf16 multi", adj.shape[1], adj, mask, None, False)
        for _, adj, mask in collab.shapes(device)]
    for key, t, adj, mask, folds, round_h in bf16_cases:
        row = trunk_times[(key, t)] = time_trunk(dt, adj.to(torch.bfloat16), mask, None,
                                                 flush, device, folds=folds,
                                                 round_h=round_h)
        fp = trunk_times[{"bf16 lockstep": ("lockstep", t), "bf16": (t, None),
                          "bf16 multi": ("multi", t)}[key]]
        log(f"  trunk {key} S={adj.shape[0]} T={t}{' round_h' if round_h else ''} "
            f"{row['plan']}: fwd kernel {row['fwd']:.4f} ms (flushed "
            f"{row['fwd_flushed']:.4f}; fp32 {fp['fwd']:.4f}) plain "
            f"{row['fwd_plain']:.4f} bound {row['bound_fwd']:.4f} "
            f"({row['bound_fwd_by']}) | bwd kernel {row['bwd']:.4f} ms (flushed "
            f"{row['bwd_flushed']:.4f}; fp32 {fp['bwd']:.4f}) plain "
            f"{row['bwd_plain']:.4f} bound {row['bound_bwd']:.4f} ({row['bound_bwd_by']})")
    block_times = {}
    for label, r in (("mean", ctx.mean_row), ("max", ctx.max_row),
                     ("largest graph", ctx.big_row)):
        log(f"  DD {label} batch (row {r}):")
        block_times[label] = time_block(ctx.batch(r), ctx.nb, ctx.pool, flush, device)
    lock_label = f"{FOLDS}-fold merged mean step"
    log(f"  DD {lock_label} (step {lctx.mean_step}, nb' {FOLDS * lctx.nb}):")
    block_times[lock_label] = time_block(lctx.batch(), FOLDS * lctx.nb, ctx.pool, flush,
                                         device)
    for label, b, nb in (("bf16 mean", ctx.batch(ctx.mean_row), ctx.nb),
                         (f"bf16 {lock_label}", lctx.batch(), FOLDS * lctx.nb)):
        log(f"  DD {label} (bf16 pool and hb; the wrapper's design):")
        block_times[label] = time_block(b, nb, pool16, flush, device, variants=False)
        fp = block_times["mean" if label == "bf16 mean" else lock_label]
        log(f"    against fp32 at the same batch: " + ", ".join(
            f"{k} {d} F={f} {block_row(block_times[label], k, d, f)['ms']:.4f} vs "
            f"{block_row(fp, k, d, f)['ms']:.4f} ms" for k in BLOCK_KERNELS
            for d in ("fwd", "bwd") for f in (32, 1)))
    for k in BLOCK_KERNELS:
        log(f"  {k} at the {lock_label} against {FOLDS} x the one-fold mean batch: " +
            ", ".join(f"{d} F={f} {block_row(block_times[lock_label], k, d, f)['ms']:.4f}"
                      f" vs {FOLDS * block_row(block_times['mean'], k, d, f)['ms']:.4f} ms"
                      for d in ("fwd", "bwd") for f in (32, 1)))
    for label, rows in block_times.items():
        if label.startswith("bf16"):
            continue  # the wrapper's design only: no step or design comparison
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
        spmm_times[label] = time_spmm(
            spmm_cases[label], flush, device,
            kernels=SPMM_TIMED if label in ("mean", "max") else SPMM_TIMED[:4])
    for label in ("NCI1 dev", "NCI1 host mean", "NCI1 filled", "probe standard",
                  "probe long row"):
        log(f"  {label} batch (block-COO only):")
        spmm_times[label] = time_spmm(spmm_cases[label], flush, device,
                                      kernels=BLOCK_COO_TIMED)
    for label in ("mean", "max", "host mean", "host max"):
        rows = spmm_times[label]
        log(f"  DD COO {label} batch, one train step's SpMMs (3 x F=32 + F=1, fwd + "
            f"bwd): " + ", ".join(f"{k} {spmm_step_ms(rows, k):.4f} ms"
                                  for k in SPMM_TIMED if (k, "fwd", 32) in rows))
        if label not in ("mean", "max"):
            continue
        steps = {k: spmm_step_ms(rows, k) for k in EARLIER_TIMED}
        log(f"    faster on device-assembled batches: {min(steps, key=steps.get)} "
            f"(spmm_impl auto = {spmm_auto})")
        for k in EARLIER_TIMED:
            shapes = [(d, f) for d in ("fwd", "bwd") for f in (32, 1)]
            log(f"    {k}: " + "; ".join(
                f"{d} F={f} {rows[(k, d, f)]['ms']:.4f} ms (earlier design "
                f"{rows[(k + '_earlier', d, f)]['ms']:.4f}), "
                f"{rows[(k, d, f)]['ms'] / rows[(k, d, f)]['bound_ms']:.2f}x its bound"
                for d, f in shapes))
    for label, rows in spmm_times.items():
        beats = all(rows[("spmm_block_coo", d, 32)]["library_ms"] is not None
                    and rows[("spmm_block_coo", d, 32)]["ms"]
                    < rows[("spmm_block_coo", d, 32)]["library_ms"] for d in ("fwd", "bwd"))
        log(f"  {label}: block-COO F=32 fwd and bwd below cuSPARSE: "
            f"{'yes' if beats else 'no'}")
    infer_times = {}
    for ds, inf in h["infer"].items():
        log(f"  {ds} inference batch {inf['median_batch']} (the median batch by edges; "
            f"the row kernel, which inference runs forward only):")
        infer_times[ds] = time_spmm(inf["case"], flush, device, kernels=("spmm_rows",))
    del flush

    log("== phase 6: one profiled train step (torch.profiler), then one epoch "
        "of each epoch graph")
    log(card)
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import FoldAdam, lockstep_train_step, make_optimizer, train_step

    def seq_step(model, batch, **fwd_kw):
        """One sequential train step of fresh weights on `batch`."""
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model, device))
        opt = make_optimizer(net)
        gen = torch.Generator(device="cuda").manual_seed(0)
        return lambda: train_step(net, opt, batch, gen, **fwd_kw)

    nci1_step = profile_step("NCI1 dense", seq_step(nci1_model,
                                                    batch_to_device(nci1_host, device)))
    net_f = folds_net(nci1_model, device, seed=0)
    adam_f = FoldAdam(net_f)
    lock_batch = batch_to_device(lock_host, device)
    real = torch.ones(FOLDS, dtype=torch.bool, device=device)
    gens = [torch.Generator(device="cuda").manual_seed(f) for f in range(FOLDS)]
    lock_step = profile_step(
        f"NCI1 dense lockstep ({FOLDS} folds x {S} slots)",
        lambda: lockstep_train_step(net_f, adam_f, lock_batch, real, gens), by_op=True)
    log(f"  lockstep step per fold: wall {lock_step[0] / FOLDS:.3f} ms, device "
        f"{lock_step[1] / FOLDS:.4f} ms, {lock_step[2] / FOLDS:.1f} launches; the "
        f"sequential step: wall {nci1_step[0]:.3f} ms, device {nci1_step[1]:.4f} ms, "
        f"{nci1_step[2]} launches")
    sparse_steps = {}
    for impl in (auto_impl, other_impl):
        sparse_steps[f"DD block ({impl})"] = profile_step(
            f"DD block ({impl} = {kernel_of[impl]}, mean batch)",
            seq_step(dd_model, ctx.batch(ctx.mean_row), pool=ctx.pool, block_impl=impl))
    sparse_steps[f"DD COO ({spmm_auto})"] = profile_step(
        f"DD COO ({spmm_auto}, mean batch)",
        seq_step(dd_model, dd_coo.batch(dd_coo.mean_row), spmm_impl=spmm_auto))
    coo_step = sparse_steps[f"DD COO ({spmm_auto})"]
    # bf16 compute adds its casts (x at entry, W_i at its product, each
    # layer's output) to the step's launches; the SpMMs are the same
    coo_step16 = profile_step(
        f"DD COO ({spmm_auto}, mean batch), bf16 compute",
        seq_step(dd_model16, dd_coo.batch(dd_coo.mean_row), spmm_impl=spmm_auto))
    profile_step("DD COO (pallas, CooEngine mean batch; the slot order's sorts included)",
                 seq_step(dd_model, dd_host.batch(dd_host.mean_row), spmm_impl="pallas"))
    dd_net_f = folds_net(dd_model, device, seed=0)
    dd_adam_f, dd_step_batch = FoldAdam(dd_net_f), lctx.batch()
    dd_gens = [torch.Generator(device="cuda").manual_seed(f) for f in range(FOLDS)]
    sparse_steps["DD block lockstep"] = profile_step(
        f"DD block lockstep ({FOLDS} folds, {auto_impl}, merged mean step, "
        f"{int(dd_step_batch.num_items)} items)",
        lambda: lockstep_train_step(dd_net_f, dd_adam_f, dd_step_batch, real, dd_gens,
                                    pool=ctx.pool, block_impl=auto_impl), by_op=True)
    lock_batch16 = bf16_batch(lock_batch)
    net_f16 = folds_net(nci1_model16, device, seed=0)
    adam_f16 = FoldAdam(net_f16)
    lock_step16 = profile_step(
        f"NCI1 dense lockstep, bf16 compute ({FOLDS} folds x {S} slots)",
        lambda: lockstep_train_step(net_f16, adam_f16, lock_batch16, real, gens),
        by_op=True)
    dd_net_f16 = folds_net(dd_model16, device, seed=0)
    dd_adam_f16 = FoldAdam(dd_net_f16)
    sparse_steps["DD block lockstep bf16"] = profile_step(
        f"DD block lockstep, bf16 compute ({FOLDS} folds, {auto_impl}, merged mean "
        f"step, bf16 pool)",
        lambda: lockstep_train_step(dd_net_f16, dd_adam_f16, dd_step_batch, real, dd_gens,
                                    pool=pool16, block_impl=auto_impl), by_op=True)
    sparse_steps["COLLAB multi"] = profile_step(
        f"COLLAB multi (fold 1's step {collab.step}, slots {list(collab.slots)})",
        seq_step(collab_model, collab.batch(device)))
    # the epoch graphs last, so that the step tables above are taken as in
    # earlier runs (one run that profiled the DD block step after them
    # recorded 62 of its launches)
    eager_steps = {"lockstep": lock_step, "one fold": nci1_step,
                   "lockstep bf16": lock_step16, **sparse_steps}
    epoch_graphs = {name: profile_epoch(name, r, eager_steps[name])
                    for name, r in runners.items()}
    del runners

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
    trunk_src = "dgcnn_tpu_torch/csrc/dense_trunk.cu"
    tl = trunk_times[("lockstep", t_main)]  # the lockstep main path's shape
    ts = trunk_times[(t_main, None)]  # one fold's batch, as the sequential driver runs
    kernels = [
        {"name": f"gcn_trunk_{d}", "route": "cuda", "source": trunk_src,
         "replaces": f"dgcnn_tpu/kernels/dense_trunk.py:{line}",
         "launches": n, "max_abs_err": stats[f"gcn_trunk_{d}"],
         "ms": tl[d], "ms_l2_flushed": tl[f"{d}_flushed"],
         "plain_ms": tl[f"{d}_plain"], "bound_ms": tl[f"bound_{d}"],
         "bound_by": tl[f"bound_{d}_by"], "library_ms": None, "plan": tl["plan"],
         "main_path": f"NCI1 lockstep, {FOLDS} folds x 4 epochs in chunks of 2: "
                      f"epoch 1 eager (the warm-up), epochs 2-4 CUDA-graph replays, "
                      f"launches counted per replay",
         "shape": f"lockstep step: S={SL} ({FOLDS} folds x {S} slots), K={FOLDS}, "
                  f"T={t_main}",
         "sequential_shape": {"shape": f"S={S}, K=1, T={t_main}", "plan": ts["plan"],
                              "ms": ts[d], "plain_ms": ts[f"{d}_plain"],
                              "bound_ms": ts[f"bound_{d}"]},
         "multi_path": {
             "main_path": "COLLAB multi, 2 folds x 4 epochs in chunks of 2, the folds "
                          "one after another, launches counted per replay",
             "calls_resident": multi["calls"][i], "calls_streamed": multi["calls"][2 + i],
             "kernel_launches": multi["kernel_launches"][i],
             "shapes": [{"shape": f"S={s}, K=1, T={t}", "plan": row["plan"],
                         "ms": row[d], "plain_ms": row[f"{d}_plain"],
                         "bound_ms": row[f"bound_{d}"], "bound_by": row[f"bound_{d}_by"]}
                        for t, s in zip(collab.tiles, collab.slots)
                        for row in [trunk_times[("multi", t)]]]},
         "multi_lockstep_path": {
             "main_path": "COLLAB multi lockstep (cv_parallel folds), 2 folds x 4 "
                          "epochs in chunks of 2, launches counted per replay",
             "calls_resident": multi_lock["calls"][i],
             "calls_streamed": multi_lock["calls"][2 + i],
             "kernel_launches": multi_lock["kernel_launches"][i],
             "shapes": [{"shape": f"S={FOLDS * s}, K={FOLDS}, T={t}", "plan": row["plan"],
                         "ms": row[d], "plain_ms": row[f"{d}_plain"],
                         "bound_ms": row[f"bound_{d}"], "bound_by": row[f"bound_{d}_by"]}
                        for t, s in zip(collab.tiles, collab.slots)
                        for row in [trunk_times[("multi lockstep", t)]]]}}
        for i, (d, line, n) in enumerate((("fwd", 232, trunk_fwd_n), ("bwd", 310, trunk_bwd_n)))
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
                lrow = block_row(block_times[lock_label], kname, d, f)
                ln = dd_lock["ten_folds"]["launches"][i] if kname == kernel_of[auto_impl] \
                    else 0
                lf1 = dd_lock["ten_folds"]["f1"][i] if kname == kernel_of[auto_impl] else 0
                kernels[-1]["lockstep_path"] = {
                    "main_path": f"DD block lockstep, cv_parallel auto, {FOLDS} folds x 4 "
                                 f"epochs in chunks of 2, launches counted per replay",
                    "launches": ln - lf1 if f == 32 else lf1,
                    "shape": (f"{FOLDS}-fold merged mean step: {lrow['n_items']} items, "
                              f"nb' {lrow['nb']}, F {f}; {lrow['design']}"),
                    "ms": lrow["ms"], "ms_l2_flushed": lrow["ms_l2_flushed"],
                    "plain_ms": lrow["plain_ms"], "bound_ms": lrow["bound_ms"],
                    "bound_by": lrow["bound_by"], "library_ms": lrow["library_ms"]}
    # the bf16 modes of the same three kernels, on phase 4g's main paths
    tl16 = trunk_times[("bf16 lockstep", t_main)]
    for i, (d, line) in enumerate((("fwd", 232), ("bwd", 310))):
        ts16 = trunk_times[("bf16", t_main)]
        kernels.append({
            "name": f"gcn_trunk_bf16_{d}", "route": "cuda", "source": trunk_src,
            "replaces": f"dgcnn_tpu/kernels/dense_trunk.py:{line}",
            "launches": mp["nci1"]["calls"][i],
            "max_abs_err": stats[f"gcn_trunk_bf16_{d}"],
            "ms": tl16[d], "ms_l2_flushed": tl16[f"{d}_flushed"],
            "plain_ms": tl16[f"{d}_plain"], "bound_ms": tl16[f"bound_{d}"],
            "bound_by": tl16[f"bound_{d}_by"], "library_ms": None, "plan": tl16["plan"],
            "main_path": f"NCI1 --dtype bfloat16, lockstep, {FOLDS} folds x 4 epochs in "
                         f"chunks of 2, launches counted per replay (bf16 adjacency, "
                         f"round_h)",
            "shape": f"lockstep step: S={SL}, K={FOLDS}, T={t_main}, bf16 adjacency, "
                     f"round_h; bound at 2 bytes an adjacency element",
            "sequential_shape": {"shape": f"S={S}, K=1, T={t_main}, round_h",
                                 "plan": ts16["plan"], "ms": ts16[d],
                                 "plain_ms": ts16[f"{d}_plain"],
                                 "bound_ms": ts16[f"bound_{d}"]},
            "resident_cap_bf16": cap16,
            "multi_path": {
                "main_path": "COLLAB --adj_dtype bfloat16, multi, 2 folds x 4 epochs in "
                             "chunks of 2, launches counted per replay",
                "calls_resident": mp["collab"]["calls"][i],
                "calls_streamed": mp["collab"]["calls"][2 + i],
                "kernel_launches": mp["collab"]["kernel_launches"][i],
                "shapes": [{"shape": f"S={s_}, K=1, T={t}", "plan": row["plan"],
                            "ms": row[d], "plain_ms": row[f"{d}_plain"],
                            "bound_ms": row[f"bound_{d}"], "bound_by": row[f"bound_{d}_by"]}
                           for t, s_ in zip(collab.tiles, collab.slots)
                           for row in [trunk_times[("bf16 multi", t)]]]}})
    bf16_lock = f"bf16 {lock_label}"
    for kname in BLOCK_KERNELS:
        n_all, f1_all = ((mp["dd"]["launches"], mp["dd"]["f1"]) if kname == "block_csr"
                         else (mp["dd"]["xla_launches"], mp["dd"]["xla_f1"]))
        for i, d in enumerate(("fwd", "bwd")):
            for f, suffix, n in ((32, "", n_all[i] - f1_all[i]), (1, "_f1", f1_all[i])):
                row = block_row(block_times[bf16_lock], kname, d, f)
                one = block_row(block_times["bf16 mean"], kname, d, f)
                kernels.append({
                    "name": f"{kname}_bf16_{d}{suffix}", "route": "cuda",
                    "source": f"dgcnn_tpu_torch/csrc/{kname}.cu",
                    "replaces": replaces[kname],
                    "launches": n,
                    "max_abs_err": stats[f"{kname}_bf16_{d}"],
                    "ms": row["ms"], "ms_l2_flushed": row["ms_l2_flushed"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "main_path": (f"DD --dtype bfloat16, block lockstep, {FOLDS} folds x "
                                  f"{4 if kname == 'block_csr' else 2} epochs"
                                  f"{'' if kname == 'block_csr' else ', --block_impl xla'}, "
                                  f"chunks of 2, launches counted per replay"),
                    "shape": (f"{FOLDS}-fold merged mean step: {row['n_items']} items, "
                              f"nb' {row['nb']}, F {f}, bf16 pool and hb; bound at 2 "
                              f"bytes an element"),
                    "one_fold_shape": {
                        "shape": f"DD mean batch: {one['n_items']} items, nb {one['nb']}",
                        "ms": one["ms"], "plain_ms": one["plain_ms"],
                        "bound_ms": one["bound_ms"], "library_ms": one["library_ms"]},
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
            f1_n = coo_launches[kname + "_f1"][i]
            for f, suffix, n in ((32, "", coo_launches[kname][i] - f1_n), (1, "_f1", f1_n)):
                row = spmm_times[where][(kname, d, f)]
                kernels.append({
                    "name": f"{kname}_{d}{suffix}", "route": "cuda",
                    "source": f"dgcnn_tpu_torch/csrc/{kname}.cu",
                    "replaces": spmm_replaces[kname],
                    "launches": n,
                    "max_abs_err": stats[f"{kname}_{d}"],
                    "ms": row["ms"], "ms_l2_flushed": row["ms_l2_flushed"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    "shape": (f"DD COO mean batch ({engine}): {row['edges']} edges, "
                              f"N {row['n']}, F {f}"
                              + (f", {row['items']} items of {row['slots']}"
                                 if kname == "spmm_block_coo" else "")),
                })
                if kname == "spmm_block_coo":
                    kernels[-1]["abuild_ms"] = spmm_times[where][
                        ("spmm_block_coo_abuild", d, f)]["ms"]
                    kernels[-1]["slot_order_ms"] = spmm_times[where]["order_ms"]
                else:
                    kernels[-1]["earlier_design_ms"] = spmm_times[where][
                        (kname + "_earlier", d, f)]["ms"]
                if kname == "spmm_rows":  # inference runs the row kernel's forward
                    kernels[-1]["infer_path"] = {
                        "main_path": "predict_dataset of synthetic NCI1 and DD from a "
                                     "fold bundle, batches of 50, one CUDA-graph replay "
                                     "a batch, launches counted per replay",
                        "launches": {
                            ds: (0 if d == "bwd" else
                                 inf["launches"][0] - inf["launches"][2] if f == 32
                                 else inf["launches"][2])
                            for ds, inf in h["infer"].items()},
                        "graphs_per_s": {ds: inf["graphs_per_s"]
                                         for ds, inf in h["infer"].items()}}
                    if d == "fwd":
                        kernels[-1]["infer_path"]["median_batch"] = {
                            ds: {k: t[("spmm_rows", "fwd", f)][k] for k in (
                                "edges", "n", "ms", "ms_l2_flushed", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")}
                            for ds, t in infer_times.items()}
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
    log(f"DD block fold-epoch seconds (main path, block_impl {auto_impl}): graphed "
        f"{dd_epoch_s}, eager {[e['epoch_seconds'] for e in dd_events[auto_impl][1]]}")
    log(f"DD block lockstep fold-epoch seconds ({FOLDS} folds, cv_parallel auto, "
        f"block_impl {auto_impl}, chunks of 2; epoch seconds / {FOLDS}): graphed "
        f"{dd_lock['ten_folds']['epoch_s']}, eager {dd_lock['ten_folds']['eager_epoch_s']}, "
        f"block_impl {other_impl} graphed {dd_lock['ten_folds']['other_epoch_s']}; "
        f"budgets by chunk {dd_lock['ten_folds']['budgets']}; 2 folds (cv_parallel "
        f"folds): {dd_lock['two_folds']['epoch_s']}")
    log(f"COO fold-epoch seconds (graphed, eager): {coo_epoch_s}")
    log(f"resume (phase 4h; {card}): in-flight save seconds " + "; ".join(
        f"{k} {[round(t, 4) for t in v['inflight_save_s']]}" for k, v in h.items()
        if k != "infer") + "; fold 1's fold-epoch seconds with --ckpt_every 2, chunks 1 "
        "and 2: " + "; ".join(f"{k} {v['epoch_s']}" for k, v in h.items() if k != "infer")
        + f"; without (phases 4a, 4e, 4c): NCI1 lockstep {lock['lockstep_epoch_s']}, DD "
        f"block lockstep {dd_lock['ten_folds']['epoch_s']}, DD COO fold 1 "
        f"{coo_epoch_s[('DD', 'auto')][0][:4]}")
    log(f"inference (phase 4h; {card}): " + "; ".join(
        f"{ds} {inf['graphs_per_s']:.0f} graphs/s over a pass of replays, "
        f"{inf['graphs_per_s_call']:.0f} graphs/s a whole call, card vs CPU rel "
        f"{inf['card_vs_cpu_rel']:.3e}" for ds, inf in h["infer"].items()))
    log(f"NCI1 dense train step: wall {nci1_step[0]:.3f} ms, device {nci1_step[1]:.3f} "
        f"ms over {nci1_step[2]} kernel launches")
    log(f"NCI1 dense lockstep train step ({FOLDS} folds): wall {lock_step[0]:.3f} ms, "
        f"device {lock_step[1]:.3f} ms over {lock_step[2]} kernel launches")
    log(f"NCI1 fold-epoch seconds, lockstep ({FOLDS} folds, chunks of 2): graphed "
        f"{lock['lockstep_epoch_s']}, eager {lock['lockstep_eager_epoch_s']}; "
        f"sequential (epoch 1, epoch 2 of each fold): graphed "
        f"{lock['sequential_epoch_s']}, eager {lock['sequential_eager_epoch_s']}")
    for name, g in epoch_graphs.items():
        log(f"{name if name.startswith(('DD', 'COLLAB')) else 'NCI1 ' + name} epoch "
            f"graph: {json.dumps(g)}")
    log(f"bf16 (phase 4g) fold-epoch seconds and run peak memory: NCI1 lockstep "
        f"{mp['nci1']['epoch_s']}, {mp['nci1']['peak_mib']:.1f} MiB (fp32 "
        f"{lock['lockstep_epoch_s']}, {lock['peak_mib']:.1f} MiB); DD block lockstep "
        f"{mp['dd']['epoch_s']}, {mp['dd']['peak_mib']:.1f} MiB (fp32 "
        f"{dd_lock['ten_folds']['epoch_s']}, {dd_lock['ten_folds']['peak_mib']:.1f} "
        f"MiB); COLLAB multi {mp['collab']['epoch_s']}, {mp['collab']['peak_mib']:.1f} "
        f"MiB (fp32 {multi['epoch_s']}, {multi['peak_mib']:.1f} MiB)")
    log(f"bf16 COO (phase 4i; {card}) fold-epoch seconds of chunk 2 and run peak "
        f"memory: " + "; ".join(
            f"DD --spmm {name} graphed {c['epoch_s']}, eager {c['eager_epoch_s']}, "
            f"{c['peak_mib']:.1f} MiB (fp32 {coo_fp32[name][0]}, "
            f"{coo_fp32[name][1]:.1f} MiB)" for name, c in coo16.items())
        + f"; one DD COO train step fp32 {coo_step[2]} kernel launches, bf16 "
        f"{coo_step16[2]}")
    log(f"native packer (phase 4i; {card}): one DD epoch native {native_s['native']:.4f} "
        f"s, NumPy {native_s['numpy']:.4f} s, add_blockcoo {native_s['add_blockcoo']:.4f} "
        f"s; DD --spmm pallas fold-epoch seconds graphed "
        f"{coo_epoch_s[('DD', 'pallas')][0]}, eager {coo_epoch_s[('DD', 'pallas')][1]}")
    log(f"parity harness and entry (phase 4i; {card}): " + json.dumps(parity))
    log(f"COLLAB fold-epoch seconds, chunk 2 (fold, s): multi graphed "
        f"{multi['epoch_s']}, eager {multi['eager_epoch_s']}; --layout dense graphed "
        f"{multi['dense_epoch_s']}; multi lockstep (2 folds, epoch seconds / 2) "
        f"{multi_lock['epoch_s']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
