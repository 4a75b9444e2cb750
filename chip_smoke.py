#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (dgcnn_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero, printing no result, when
CUDA is absent or any phase fails. Phases:

  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build every kernel from dgcnn_tpu_torch/csrc (nvcc, sm_90a);
  3. hold each kernel against its plain PyTorch version on the card, on
     real dense batches (synthetic MUTAG, NCI1, PROTEINS) and one random
     symmetric T=2048 case, forward and backward, K ∈ {1, 10} weight
     sets; check each adjacency is symmetric and that two backward runs
     give the same bits;
  4. the main path: the CLI trains synthetic NCI1 (all 4,110 graphs,
     batch 50, full-width model, dense layout) for 2 folds × 2 epochs,
     with the launch counts reset just before and read just after; then
     one batch's log-probabilities and gradients on the card against the
     same model on the CPU;
  5. kernel and plain-version times (CUDA events) at the main path's
     shapes and at the real NCI1 and PROTEINS tiles;
  6. one JSON line describing every kernel, the card line again, and
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def rel_err(got: torch.Tensor, want: torch.Tensor):
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return err, err / max(scale, ATOL), err <= ATOL + RTOL * scale


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


def compare_case(name, adj, mask, device, dt, stats):
    sym = (adj - adj.mT).abs().max().item()
    if sym > 1e-7:
        raise AssertionError(f"{name}: adjacency not symmetric ({sym:.3g})")
    for k in (1, 10):
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, k, seed=17 + k, device=device)
        with torch.no_grad():
            cat_k = dt.gcn_trunk(DIMS, adj, hw1, mask, wsel, ws, bs)
            cat_p = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
        err, rel, ok = rel_err(cat_k, cat_p)
        stats["fwd"] = max(stats["fwd"], err)
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
            stats["bwd"] = max(stats["bwd"], err)
            if rel >= worst[1]:
                worst = (err, rel, nm)
        log(f"  {name} K={k} backward: worst {worst[2]} max abs {worst[0]:.3e} "
            f"rel {worst[1]:.3e} (ok; two runs bitwise equal)")


def dense_case(gs, n_tile, device):
    from dgcnn_tpu_torch.batching.dense import pack_dense_batch

    b = pack_dense_batch(gs, np.arange(50), n_tile, S)
    return torch.from_numpy(b.adj).to(device), torch.from_numpy(b.node_mask).to(device)


def time_ms(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
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


def trunk_bounds(s, t, k):
    """(fwd, bwd) least times in ms: max(bytes / HBM rate, flops / fp32
    peak). Each input read once, each output written once."""
    sd = sum(DIMS)
    pairs = sum(a * b for a, b in zip(DIMS[:-1], DIMS[1:]))
    wbytes = 4 * k * (pairs + sd) + 4 * s
    p = pairs + sd  # per-slot gradient values the backward writes
    fwd_bytes = 4 * (s * t * t + s * t * DIMS[0] + s * t + s * t * sd) + wbytes
    fwd_flops = 2 * s * t * t * sd + 2 * s * t * pairs
    bwd_bytes = 4 * (s * t * t + s * t + 2 * s * t * sd + s * t * DIMS[0]
                     + s * p) + wbytes
    bwd_flops = 2 * s * t * t * sd + 4 * s * t * pairs

    def bound(b, f):
        by_bytes, by_ops = b / PEAK_BYTES * 1e3, f / PEAK_FP32_FLOPS * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    return bound(fwd_bytes, fwd_flops), bound(bwd_bytes, bwd_flops)


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
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    log("== phase 3: kernels vs plain versions on the card")
    datasets = {n: synthesize_tu_dataset(n) for n in ("MUTAG", "NCI1", "PROTEINS")}
    from dgcnn_tpu_torch.batching.dense import dense_tile

    t_main = dense_tile(datasets["NCI1"])
    cases = [
        ("MUTAG T=32", datasets["MUTAG"], 32),
        (f"NCI1 T={t_main} (main path)", datasets["NCI1"], t_main),
        ("NCI1 T=112", datasets["NCI1"], 112),
        ("PROTEINS T=624", datasets["PROTEINS"], 624),
    ]
    stats = {"fwd": 0.0, "bwd": 0.0}
    shapes = {}
    for name, gs, n_tile in cases:
        adj, mask = dense_case(gs, n_tile, device)
        shapes[n_tile] = (adj, mask)
        compare_case(name, adj, mask, device, dt, stats)
    adj, mask = random_symmetric_case(2048, seed=5, device=device)
    compare_case("random T=2048", adj, mask, device, dt, stats)
    del adj, mask
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    log("== phase 4: main path (CLI, synthetic NCI1, dense, 2 folds x 2 epochs)")
    from dgcnn_tpu_torch import cli
    from dgcnn_tpu_torch.data.folds import get_folds

    epochs, folds_n, batch = 2, 2, 50
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--data_type", "NCI1", "--synthetic", "--layout", "dense",
                "--num_folds", str(folds_n), "--num_epochs", str(epochs),
                "--batch_size", str(batch), "--data_root", os.path.join(tmp, "data"),
                "--out_root", tmp]
        dt.launches.reset()
        t0 = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd_n, bwd_n = dt.launches.fwd_launches, dt.launches.bwd_launches
        gs = datasets["NCI1"]
        folds = get_folds(gs.y, os.path.join(tmp, "data", "NCI1", "10fold_idx"),
                          folds_n, 324, data_type="NCI1")
        train_steps = sum(epochs * -(-len(tr) // batch) for tr, _ in folds)
        eval_steps = sum(epochs * -(-len(te) // batch) for _, te in folds)
        log(f"main path: {wall:.1f} s; train steps {train_steps}, eval steps "
            f"{eval_steps}; trunk launches fwd {fwd_n} bwd {bwd_n}")
        if fwd_n != train_steps + eval_steps or bwd_n != train_steps:
            raise AssertionError("launch counts do not match the steps run")
        for f in range(1, folds_n + 1):
            path = os.path.join(tmp, "statistics", f"NCI1_results_{f}.csv")
            rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
            if rows.shape != (epochs, 5) or not np.isfinite(rows).all():
                raise AssertionError(f"{path}: bad metrics {rows}")
            log(f"  fold {f}: " + "; ".join(
                f"epoch {int(r[0])} train loss {r[1]:.4f} acc {r[3]:.2f}% "
                f"test loss {r[2]:.4f} acc {r[4]:.2f}%" for r in rows))
            if not os.path.exists(os.path.join(tmp, "epochs", f"NCI1_{f}.npz")):
                raise AssertionError(f"fold {f}: no epochs/ bundle")
        log(f"accuracies: train {result['train_accuracies']} "
            f"test {result['test_accuracies']}")
        with open(os.path.join(tmp, "statistics", "NCI1_events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        log("epoch seconds (train + eval, host clock): " + ", ".join(
            f"fold {e['fold']} epoch {e['epoch']} {e['epoch_seconds']:.4f}"
            for e in events if e["kind"] == "epoch"))

    log("== phase 4b: one batch on the card vs the CPU")
    from dgcnn_tpu_torch.batching.dense import batch_to_device, pack_dense_batch
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

    gs = datasets["NCI1"]
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    host = pack_dense_batch(gs, np.arange(100, 150), t_main, S)
    outs = {}
    for dev in ("cpu", "cuda"):
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model, dev))
        b = batch_to_device(host, dev)
        lp = net(b)
        loss, _ = nll_loss_and_correct(lp, b.y, b.graph_mask)
        loss.backward()
        outs[dev] = [lp.detach()] + [p.grad for p in net.parameters()]
    worst = 0.0
    for a, c in zip(outs["cuda"], outs["cpu"]):
        err, rel, ok = rel_err(a.cpu(), c)
        worst = max(worst, rel)
        if not ok or not torch.isfinite(a).all():
            raise AssertionError(f"card vs CPU disagree (max abs {err:.3e})")
    log(f"log_probs and {len(outs['cpu']) - 1} parameter gradients agree, "
        f"worst rel {worst:.3e}")

    log("== phase 5: times (CUDA events)")
    log(card)
    times = {}
    for t in (t_main, 112, 624):
        adj, mask = shapes[t]
        hw1, wsel, ws, bs = trunk_inputs(adj, mask, 1, seed=1, device=device)
        with torch.no_grad():
            cat = dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)
        g = torch.randn_like(cat)
        row = {
            "fwd": time_ms(lambda: dt._cuda_fwd(DIMS, adj, hw1, mask, wsel, ws, bs, 1)),
            "fwd_plain": time_ms(lambda: dt.gcn_trunk_plain(DIMS, adj, hw1, mask, wsel, ws, bs)),
            "bwd": time_ms(lambda: dt._cuda_bwd(DIMS, adj, mask, wsel, ws, cat, g, 1)),
            "bwd_plain": time_ms(lambda: dt.gcn_trunk_plain_bwd(DIMS, adj, mask, wsel, ws, cat, g)),
        }
        (fb, _), (bb, _) = trunk_bounds(S, t, 1)
        times[t] = row
        log(f"  S={S} T={t}: fwd kernel {row['fwd']:.4f} ms plain "
            f"{row['fwd_plain']:.4f} ms bound {fb:.4f} ms | bwd kernel "
            f"{row['bwd']:.4f} ms plain {row['bwd_plain']:.4f} ms bound {bb:.4f} ms")

    (fb, fby), (bb, bby) = trunk_bounds(S, t_main, 1)
    src = "dgcnn_tpu_torch/csrc/dense_trunk.cu"
    kernels = [
        {"name": "gcn_trunk_fwd", "route": "cuda", "source": src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:232",
         "launches": fwd_n, "max_abs_err": stats["fwd"],
         "ms": times[t_main]["fwd"], "plain_ms": times[t_main]["fwd_plain"],
         "bound_ms": fb, "bound_by": fby, "library_ms": None},
        {"name": "gcn_trunk_bwd", "route": "cuda", "source": src,
         "replaces": "dgcnn_tpu/kernels/dense_trunk.py:310",
         "launches": bwd_n, "max_abs_err": stats["bwd"],
         "ms": times[t_main]["bwd"], "plain_ms": times[t_main]["bwd_plain"],
         "bound_ms": bb, "bound_by": bby, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
