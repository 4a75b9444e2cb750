#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dgcnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero, printing no result, when
CUDA is absent or any phase fails. Phases:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build every kernel from dgcnn_tpu_torch/csrc (nvcc, sm_90a, one
     process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card:
     a. the GCN trunk on real dense batches (synthetic MUTAG, NCI1,
        PROTEINS) and one random symmetric T=2048 case, forward and
        backward, K ∈ {1, 10} weight sets; each adjacency symmetric, two
        backward runs bitwise equal;
     b. both block-propagation kernels (CSR and item-parallel) on real
        synthetic-DD batches of 50 graphs (the main path's mean and
        largest batch and the batch holding the largest graph), with
        budget headroom so padded items and unvisited block-rows exist,
        F ∈ {32, 1}, forward and transposed: against the plain version,
        gradients against autograd of the plain forward, two runs
        bitwise equal, unvisited rows exactly 0;
  4. the main paths, each with its launch counts set to 0 just before
     and read just after:
     a. the CLI trains synthetic NCI1 (dense layout, batch 50) for
        2 folds × 2 epochs; one NCI1 batch on the card against the CPU;
     b. the CLI trains synthetic DD with `--layout auto` (→ block, the
        kernel `block_impl` auto names) for 2 folds × 2 epochs, then
        1 fold × 1 epoch with the other `--block_impl` (CSR kernel =
        pallas, item-parallel kernel = xla); one DD batch on the card
        against the CPU through each kernel;
  5. device times: each call captured `REPS` times in one CUDA graph,
     the graph replayed and timed with CUDA events, so the host's launch
     rate is out of the number; warm (operands left in L2 by the
     previous call) and after a 64 MB L2-flushing write (the write's own
     time, measured the same way, subtracted). Kernel, plain version,
     bound and the library yardstick (`torch.sparse_bsr_tensor` @ dense
     for the block kernels);
  6. one `torch.profiler` table of a single train step for NCI1 dense
     and DD block (top 10 CUDA kernels) and each step's wall time;
  7. one JSON line describing every kernel, the card line again, and
     the final `{"ok": true, ...}` line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

S = 56  # graph slots: batch 50 rounded up to graph_pad_multiple 8
DIMS = (32, 32, 32, 1)
# fp32 kernel vs fp32 plain version, same inputs: the two sum the same
# products in different orders, so they differ by rounding only — about
# sqrt(n)·2^-24 relative for sums of n ≤ 56·2048 terms, far under 1e-4
# of the largest value. A wrong index or a missed tile is off by O(1).
RTOL, ATOL = 1e-4, 1e-6
# published H100 SXM peaks: fp32 outside the
# tensor cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BS = 128
REPS = 10  # calls per captured graph
FLUSH_BYTES = 64 << 20  # over the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    scale = want.double().abs().max().item() if want.numel() else 0.0
    return err, err / max(scale, ATOL), err <= ATOL + RTOL * scale


def bound(nbytes: float, flops: float):
    """(least ms, "bytes" or "operations"): max(bytes / HBM rate, fp32
    operations / fp32 peak)."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# -- device time ---------------------------------------------------------


def _graph_ms(body, reps: int, replays: int) -> float:
    """ms per replay of a CUDA graph holding `reps` calls of `body`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up outside capture (first-use set-up, allocator)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            body()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / replays
    del graph
    return ms


class Flush:
    """A 64 MB write that evicts the 50 MB L2, and its own device time."""

    def __init__(self, device):
        self.buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        self.k = 0
        self.ms = _graph_ms(self, REPS, 5) / REPS

    def __call__(self):
        self.k += 1
        self.buf.fill_(float(self.k % 7))


def device_ms(fn, flush: Flush = None, replays: int = 5) -> float:
    """Device time of one call of `fn` (see phase 5 in the docstring):
    warm when `flush` is None, else after an L2 flush, net of it."""
    if flush is None:
        return _graph_ms(fn, REPS, replays) / REPS

    def body():
        flush()
        fn()

    return _graph_ms(body, REPS, replays) / REPS - flush.ms


def events_ms(fn, reps: int = 20) -> float:
    """Back-to-back calls timed with CUDA events (an upper bound on the
    device time where the host issues slower than the card runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# -- phase 3a: the dense trunk --------------------------------------------


def glorot(gen, shape, device):
    a = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return ((torch.rand(shape, generator=gen) * 2 - 1) * a).to(device)


def trunk_inputs(adj, mask, k, seed, device):
    """hw1, wsel, W2..WL, b1..bL for a case (random, from a seed)."""
    gen = torch.Generator().manual_seed(seed)
    s, t = adj.shape[0], adj.shape[1]
    hw1 = (torch.randn((s, t, DIMS[0]), generator=gen) * 0.5).to(device)
    wsel = torch.randint(0, k, (s,), generator=gen, dtype=torch.int32).to(device)
    ws = [glorot(gen, (k, a, b), device) for a, b in zip(DIMS[:-1], DIMS[1:])]
    bs = [(torch.randn((k, d), generator=gen) * 0.1).to(device) for d in DIMS]
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


def compare_trunk(name, adj, mask, device, dt, stats):
    sym = (adj - adj.mT).abs().max().item()
    if sym > 1e-7:
        raise AssertionError(f"{name}: adjacency not symmetric ({sym:.3g})")
    for k in (1, 10):
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, k, seed=17 + k, device=device)
        with torch.no_grad():
            cat_k = dt.gcn_trunk(DIMS, adj, hw1, mask, wsel, ws, bs)
            cat_p = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
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
            n = len(DIMS)
            cat = fn(DIMS, adj, xs[0], mask, wsel, xs[1:n], xs[n:])
            return torch.autograd.grad(cat, xs, g)

        want = grads(dt.gcn_trunk_plain)  # autograd of the plain chain
        got = grads(dt.gcn_trunk)
        again = grads(dt.gcn_trunk)
        names = ["d_hw1"] + [f"dW{i + 2}" for i in range(len(DIMS) - 1)] + [
            f"db{i + 1}" for i in range(len(DIMS))]
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
            f"rel {worst[1]:.3e} (ok; two runs bitwise equal)")


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


def block_kernels():
    """name → (module: launch counts and `_cuda_prop`, autograd entry)."""
    from dgcnn_tpu_torch.kernels import block_csr, block_resident

    return {"block_csr": (block_csr, block_csr.block_propagate_csr),
            "block_resident": (block_resident,
                               block_resident.block_propagate_resident)}


def compare_block(name, ctx, r, device, stats):
    """Both kernels vs the plain version on batch row r, headroom budgets."""
    from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain, row_ptr

    nb, w = ctx.nb + 8, ctx.w + 64  # padded items and unvisited rows exist
    b = ctx.batch(r, nb, w)
    n_items = int(b.num_items)
    rp = row_ptr(b.item_row, nb)
    dead = (rp[1:] == rp[:-1])
    rpT = row_ptr(b.item_colT, nb)
    deadT = (rpT[1:] == rpT[:-1])
    if not bool(dead.any()) or n_items >= w:
        raise AssertionError(f"{name}: the case must leave unvisited rows and padded items")
    gen = torch.Generator(device=device).manual_seed(r)
    for f in (32, 1):
        hb = torch.randn((nb, BS, f), generator=gen, device=device)
        g = torch.randn((nb, BS, f), generator=gen, device=device)
        items = (b.item_pool, b.item_row, b.item_col, b.item_permT, b.item_colT)
        with torch.no_grad():
            want = block_propagate_plain(hb, ctx.pool, b.item_pool, b.item_row, b.item_col)
        hr = hb.clone().requires_grad_()
        want_g, = torch.autograd.grad(
            block_propagate_plain(hr, ctx.pool, b.item_pool, b.item_row, b.item_col),
            hr, g)
        for kname, (_, fn) in block_kernels().items():
            outs, grads = [], []
            for _ in range(2):
                x = hb.clone().requires_grad_()
                out = fn(x, ctx.pool, *items, b.num_items)
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
    return n_items


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
    """Per kernel and F: warm and flushed device ms of the kernel, warm ms
    of the plain version and of the library call, and the bound."""
    from dgcnn_tpu_torch.kernels.block_prop import (
        block_propagate_plain, transposed_items)

    b = ctx.batch(r)
    nb = ctx.nb
    n_items = int(b.num_items)
    gen = torch.Generator(device=device).manual_seed(7)
    rows = {}
    for f in (32, 1):
        hb = torch.randn((nb, BS, f), generator=gen, device=device)
        bnd = block_bounds(n_items, nb, f)
        calls = {}
        for kname, (mod, _) in block_kernels().items():
            fwd = (lambda mod=mod: mod._cuda_prop(
                hb, ctx.pool, b.item_pool, b.item_row, b.item_col, b.num_items, False))

            def bwd(mod=mod):
                ipT, rT = transposed_items(b.item_pool, b.item_row, b.item_permT, nb)
                return mod._cuda_prop(hb, ctx.pool, ipT, b.item_colT, rT, b.num_items, True)

            calls[kname] = (fwd, bwd)

        def plain_fwd():
            return block_propagate_plain(hb, ctx.pool, b.item_pool, b.item_row, b.item_col)

        def plain_bwd():
            ipT, rT = transposed_items(b.item_pool, b.item_row, b.item_permT, nb)
            return block_propagate_plain(hb, ctx.pool, ipT, b.item_colT, rT, transpose=True)

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
        for kname, (fwd, bwd) in calls.items():
            for d, fn in (("fwd", fwd), ("bwd", bwd)):
                row = {
                    "ms": device_ms(fn), "ms_l2_flushed": device_ms(fn, flush),
                    "plain_ms": plain[d], "library_ms": lib[d],
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "n_items": n_items, "nb": nb, "f": f,
                }
                rows[(kname, d, f)] = row
                log(f"  {kname} {d} F={f} items {n_items} nb {nb}: kernel warm "
                    f"{row['ms']:.4f} ms, L2-flushed {row['ms_l2_flushed']:.4f} ms; "
                    f"plain {row['plain_ms']:.4f} ms; library "
                    f"{'null' if lib[d] is None else f'{lib[d]:.4f} ms'}; bound "
                    f"{bnd[0]:.4f} ms ({bnd[1]})")
    return rows


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
    return float(np.median(walls)), total / 1e3


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

    stats = {k: 0.0 for k in ("gcn_trunk_fwd", "gcn_trunk_bwd", "block_csr_fwd",
                              "block_csr_bwd", "block_resident_fwd",
                              "block_resident_bwd")}

    log("== phase 3a: trunk kernel vs plain version on the card")
    datasets = {n: synthesize_tu_dataset(n) for n in ("MUTAG", "NCI1", "PROTEINS")}
    from dgcnn_tpu_torch.batching.dense import dense_tile

    t_main = dense_tile(datasets["NCI1"])
    cases = [
        ("MUTAG T=32", datasets["MUTAG"], 32),
        (f"NCI1 T={t_main} (main path)", datasets["NCI1"], t_main),
        ("NCI1 T=112", datasets["NCI1"], 112),
        ("PROTEINS T=624", datasets["PROTEINS"], 624),
    ]
    shapes = {}
    for name, gs, n_tile in cases:
        adj, mask = dense_case(gs, n_tile, device)
        shapes[n_tile] = (adj, mask)
        compare_trunk(name, adj, mask, device, dt, stats)
    adj, mask = random_symmetric_case(2048, seed=5, device=device)
    compare_trunk("random T=2048", adj, mask, device, dt, stats)
    del adj, mask
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("== phase 3b: block kernels vs plain version on the card")
    ctx = DDContext(device)
    if ctx.layout != "block":
        raise AssertionError(f"choose_layout gave {ctx.layout} for DD, not block")
    checked = {"mean": ctx.mean_row, "max": ctx.max_row, "largest graph": ctx.big_row}
    for label, r in checked.items():
        compare_block(f"DD {label} batch (row {r}, {ctx.row_items[r]} items)",
                      ctx, r, device, stats)

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
            log(f"DD {' '.join(extra)}: {wall:.1f} s; train steps {tr_n}, eval "
                f"steps {ev_n}; launches (fwd, bwd) {counts}")
            if counts[used] != (4 * (tr_n + ev_n), 4 * tr_n) or counts[idle] != (0, 0):
                raise AssertionError(
                    f"block launch counts do not match the steps run on {used}")
            dd_launches[used] = counts[used]
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

    log("== phase 5: device times (CUDA-graph replay, CUDA events)")
    log(card)
    flush = Flush(device)
    log(f"  L2 flush: {FLUSH_BYTES >> 20} MB write, {flush.ms:.4f} ms")
    trunk_times = {}
    for t in (t_main, 112, 624):
        adj, mask = shapes[t]
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, 1, seed=1, device=device)
        with torch.no_grad():
            cat = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
        g = torch.randn_like(cat)
        fwd = lambda: dt._cuda_fwd(DIMS, adj, hw1, mask, wsel, ws, bs, 1)  # noqa: E731
        bwd = lambda: dt._cuda_bwd(DIMS, adj, mask, wsel, ws, cat, g, 1)  # noqa: E731
        row = {
            "fwd": device_ms(fwd), "fwd_flushed": device_ms(fwd, flush),
            "fwd_plain": device_ms(
                lambda: dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)),
            "bwd": device_ms(bwd), "bwd_flushed": device_ms(bwd, flush),
            "bwd_plain": device_ms(
                lambda: dt.gcn_trunk_plain_bwd(DIMS, adj, mask, wsel, ws, cat, g)),
        }
        (fb, _), (bb, _) = trunk_bounds(S, t, 1)
        trunk_times[t] = row
        log(f"  trunk S={S} T={t}: fwd kernel {row['fwd']:.4f} ms (flushed "
            f"{row['fwd_flushed']:.4f}) plain {row['fwd_plain']:.4f} bound {fb:.4f} | "
            f"bwd kernel {row['bwd']:.4f} ms (flushed {row['bwd_flushed']:.4f}) "
            f"plain {row['bwd_plain']:.4f} bound {bb:.4f}")
    block_times = {}
    for label, r in (("mean", ctx.mean_row), ("max", ctx.max_row)):
        log(f"  DD {label} batch (row {r}):")
        block_times[label] = time_block(ctx, r, flush, device)
    del flush

    log("== phase 6: one profiled train step (torch.profiler)")
    from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import make_optimizer

    net = DGCNNNet(nci1_model, init_params(torch.Generator().manual_seed(0), nci1_model, device))
    profile_step("NCI1 dense", net, make_optimizer(net),
                 batch_to_device(nci1_host, device), {})
    impl = ctx.engine.block_impl
    net = DGCNNNet(dd_model, init_params(torch.Generator().manual_seed(0), dd_model, device))
    profile_step(f"DD block ({impl}, mean batch)", net, make_optimizer(net),
                 ctx.batch(ctx.mean_row), {"pool": ctx.pool, "block_impl": impl})

    log(f"== phase 7: summary ({time.perf_counter() - t_start:.0f} s)")
    (fb, fby), (bb, bby) = trunk_bounds(S, t_main, 1)
    trunk_src = "dgcnn_tpu_torch/csrc/dense_trunk.cu"
    tm = trunk_times[t_main]
    kernels = [
        {"name": "gcn_trunk_fwd", "route": "cuda", "source": trunk_src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:232",
         "launches": trunk_fwd_n, "max_abs_err": stats["gcn_trunk_fwd"],
         "ms": tm["fwd"], "ms_l2_flushed": tm["fwd_flushed"],
         "plain_ms": tm["fwd_plain"], "bound_ms": fb, "bound_by": fby,
         "library_ms": None},
        {"name": "gcn_trunk_bwd", "route": "cuda", "source": trunk_src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:310",
         "launches": trunk_bwd_n, "max_abs_err": stats["gcn_trunk_bwd"],
         "ms": tm["bwd"], "ms_l2_flushed": tm["bwd_flushed"],
         "plain_ms": tm["bwd_plain"], "bound_ms": bb, "bound_by": bby,
         "library_ms": None},
    ]
    replaces = {"block_csr": "dgcnn_tpu/kernels/block_pallas.py:152",
                "block_resident": "dgcnn_tpu/kernels/block_resident.py:130"}
    for kname in BLOCK_KERNELS:
        for i, d in enumerate(("fwd", "bwd")):
            row = block_times["mean"][(kname, d, 32)]
            kernels.append({
                "name": f"{kname}_{d}", "route": "cuda",
                "source": f"dgcnn_tpu_torch/csrc/{kname}.cu",
                "replaces": replaces[kname],
                "launches": dd_launches[kname][i],
                "max_abs_err": stats[f"{kname}_{d}"],
                "ms": row["ms"], "ms_l2_flushed": row["ms_l2_flushed"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": f"DD mean batch: {row['n_items']} items, nb {row['nb']}, F 32",
            })
    log(f"DD epoch seconds (main path, block_impl {auto_impl}): {dd_epoch_s}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
