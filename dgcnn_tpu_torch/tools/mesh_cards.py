"""The mesh on several cards: one `nccl` rank a card, the mesh engines'
epochs graphed and eager, and the halo layout's point-to-point exchange.

    python -m dgcnn_tpu_torch.tools.mesh_cards [--cards 4]

Spawns one process a card (`--rank`, joined through a `FileStore` in a
temporary directory, as `graft_entry.dryrun_multichip` joins its ranks),
each `nccl` on its own card. With fewer cards than asked it exits
non-zero with one line; it never carries on with fewer ranks or with
`gloo`. The full-width model (the Config defaults: dims 32,32,32,1, k=30,
conv 16,32, dense 128, batch 50, seed 324) on synthetic data at its
published size, FOLDS folds x EPOCHS epochs in chunks of CHUNK, each run
graphed (each fold's first epoch the warm-up, then CUDA-graph replays),
then eager (`graphs=False`), through `run_cross_validation`:

  * NCI1 dense on a (N/2, 2) grid (the folds one after another);
  * DD block at (N/2, 2), the CSR kernel; DD device COO at (1, N); DD
    host COO at (N/2, 2); DD `--layout halo` at (1, N) under `auto` and
    `--spmm onehot`;
  * NCI1 and DD fold-sharded lockstep under `auto` at (N, 1), 10 folds x
    2 epochs in chunks of one;
  * then `dryrun_multichip(N)`.

Checks (each failure raises, and the run exits non-zero): graphed rows
and fold bundles (parameters and Adam state, rank 0's files) bitwise the
eager run's; every fold's parameters bitwise equal across the ranks
(each mesh fold checks it at its end, `ProcessGrid.check_replicas`) and
every rank's test accuracies equal; a dropout-0 run (FOLDS folds x 1
epoch) within rtol 3e-4 / atol 2e-6 of one device's on rank 0's card
(the fold-sharded runs: every fold's rows within rtol/atol 5e-4 of one
device's lockstep, accuracies equal); each rank's launches of the path's
kernel exactly one device's for the run's steps, replays counted, 0 on
the others; on the halo runs, the exchange at the run's halo and shard
and at the layer widths, forward and backward, bitwise equal point to
point and through the all-reduce, in the same run.

Prints, each on its own line: every run's steady fold-epoch seconds
(rank 0's events of the chunks that built no runner) graphed and eager,
the capture seconds (the events' `capture_seconds`), the host engines'
packing seconds of one epoch (the engine's packing call timed here),
each exchange's elements and milliseconds a call (CUDA events around
eager calls: the host's dispatch included, so not the device time of a
replay), and the card's name and power limit (`nvidia-smi`); the last
line is one JSON summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import gc
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FOLDS, EPOCHS, CHUNK = 2, 4, 2
FOLD_DEPTH = (10, 2)  # the fold-sharded runs: folds, epochs, in chunks of one
RANK_TIMEOUT = 1800.0  # seconds for all ranks together
EXCHANGE_WIDTHS = (32, 97)  # a GCN layer's width, the concatenated layers'


def shapes(n: int):
    """The grids of `n` ranks: (n/2, 2) (else (n, 1)), (1, n) and (n, 1)."""
    return ((n // 2, 2) if n % 2 == 0 else (n, 1)), (1, n), (n, 1)


def runs(n: int):
    """(name, dataset, grid, config, the kernel its path runs, a name of
    `train/loop.py KERNEL_COUNTERS`) of every mesh engine run."""
    square, row, _ = shapes(n)
    return (  # the halo runs first: their exchange is the one thing no card has run
        ("DD halo", "DD", row, dict(layout="halo"), "spmm_rows"),
        ("DD halo onehot", "DD", row, dict(layout="halo", spmm_impl="onehot"),
         "spmm_edge_block"),
        ("NCI1 dense", "NCI1", square, dict(layout="dense", cv_parallel="sequential"),
         "dense_trunk"),
        ("DD block", "DD", square, dict(layout="block", block_impl="pallas"), "block_csr"),
        ("DD device COO", "DD", row, dict(layout="coo"), "spmm_rows"),
        ("DD host COO", "DD", square, dict(layout="coo", coo_assembly="host"),
         "spmm_rows"),
    )


def fold_runs(n: int):
    _, _, col = shapes(n)
    return (("NCI1 fold-sharded", "NCI1", col, {}, "dense_trunk"),
            ("DD fold-sharded", "DD", col, {}, "block_csr"))


# -- one rank -------------------------------------------------------------------


def counters():
    """name → the launch counter of every kernel a mesh path could run."""
    from dgcnn_tpu_torch.train.loop import KERNEL_COUNTERS

    return KERNEL_COUNTERS


def counts() -> dict:
    """name → [fwd, bwd, fwd at F=1, bwd at F=1] launches so far (the
    trunk's kernel launches, no width split)."""
    out = {}
    for name, c in counters().items():
        out[name] = ([c.kernel_fwd, c.kernel_bwd, 0, 0] if name == "dense_trunk" else
                     [c.fwd_launches, c.bwd_launches, c.f1_fwd, c.f1_bwd])
    return out


def config(tmp, name, data_type, folds, epochs, **kw):
    from dgcnn_tpu_torch.config import Config

    sub = name.replace(" ", "_")
    return Config(**{**dict(data_type=data_type, num_folds=folds, num_epochs=epochs,
                            max_fused_epochs=CHUNK, data_root=os.path.join(tmp, "data"),
                            statistics_dir=os.path.join(tmp, sub, "statistics"),
                            epochs_dir=os.path.join(tmp, sub, "epochs")), **kw})


def rows_of(cfg) -> list:
    """Every fold's CSV rows as the run wrote them (rank 0)."""
    return [np.loadtxt(os.path.join(cfg.statistics_dir,
                                    f"{cfg.data_type}_results_{f}.csv"),
                       delimiter=",", skiprows=1, ndmin=2).tolist()
            for f in range(1, cfg.num_folds + 1)]


def events_of(cfg, kind="epoch") -> list:
    with open(os.path.join(cfg.statistics_dir, f"{cfg.data_type}_events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


def bundles_digest(cfg) -> list:
    """A digest of every fold's final `epochs/` bundle (parameters and
    Adam state) as rank 0 wrote it."""
    from dgcnn_tpu_torch.train.cv import fold_bundle

    out = []
    for f in range(1, cfg.num_folds + 1):
        h = hashlib.sha256()
        with np.load(fold_bundle(cfg, f) + ".npz") as z:
            for k in sorted(z.files):
                h.update(k.encode())
                h.update(z[k].tobytes())
        out.append(h.hexdigest()[:16])
    return out


def counted_cv(cfg, gs, grid, graphs: bool) -> dict:
    """`run_cross_validation` on the grid (every fold checks at its end
    that the ranks' parameters are bitwise equal), the launch counts set
    to 0 just before and read just after; the test accuracies, and (rank
    0) the rows, the bundles' digests and, from the event log, each
    epoch's seconds, the runners' capture seconds and `run_start`'s
    `graphs`."""
    from dgcnn_tpu_torch.train.cv import run_cross_validation

    seen = {}
    for c in counters().values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_cross_validation(cfg, dataset=gs, device=grid.device, grid=grid,
                               graphs=graphs)
    torch.cuda.synchronize()
    seen["wall_s"] = time.perf_counter() - t0
    seen["launches"] = counts()
    seen["test"] = res["test_accuracies"]
    if grid.writer:
        epochs = events_of(cfg)
        seen["rows"] = rows_of(cfg)
        seen["bundles"] = bundles_digest(cfg)
        seen["epoch_s"] = [[e["fold"], e["epoch"], e["epoch_seconds"], e["runner_built"]]
                           for e in epochs]
        # a chunk's events (in lockstep every fold's) repeat its runner's capture
        seen["capture_s"] = list(dict.fromkeys(
            e["capture_seconds"] for e in epochs if e["capture_seconds"] is not None))
        seen["graphs_flag"] = events_of(cfg, "run_start")[0].get("graphs")
    return seen


def pack_seconds(cfg, gs, grid, reps: int = 3) -> float:
    """Median host seconds of one call that packs this rank's epoch of
    fold 1's training graphs, as the host engine does each epoch
    (`MeshCooEngine.pack`: `pack_epoch_dp`; `MeshHaloEngine.pack_host`:
    `pack_epoch_halo`)."""
    from dgcnn_tpu_torch.train import cv

    engine = cv.make_engine(cfg, gs, grid.device, cfg.layout, grid=grid)
    fold_dir = os.path.join(cfg.data_root, cfg.data_type, "10fold_idx")
    train, _ = cv.get_folds(gs.y, fold_dir, cfg.num_folds, cfg.seed,
                            data_type=cfg.data_type)[0]
    ds = gs.subset(train)
    perm = np.random.default_rng(0).permutation(len(train))
    pack = engine.pack_host if isinstance(engine, cv.MeshHaloEngine) else engine.pack
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pack(ds, perm)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def launches_want(cfg, gs, kernel, grid_shape) -> list:
    """One device's launches of `kernel` (fwd, bwd, F=1 fwd, F=1 bwd) for a
    run of `cfg` at a data rank's slots: a forward of every layer a step
    and a backward a train step (the trunk: `launches_per_call` of its
    plan a call; the others once a layer, a quarter at width 1)."""
    from dgcnn_tpu_torch.batching.dense import dense_tile
    from dgcnn_tpu_torch.kernels import dense_trunk as dt
    from dgcnn_tpu_torch.train import cv

    fold_dir = os.path.join(cfg.data_root, cfg.data_type, "10fold_idx")
    folds = cv.get_folds(gs.y, fold_dir, cfg.num_folds, cfg.seed,
                         data_type=cfg.data_type)
    tr = sum(-(-len(t) // cfg.batch_size) for t, _ in folds) * cfg.num_epochs
    ev = sum(-(-len(e) // cfg.batch_size) for _, e in folds) * cfg.num_epochs
    dims = tuple(cfg.hidden_dims)
    if kernel == "dense_trunk":
        slots = max(1, -(-cfg.batch_size // grid_shape[0]))
        fwd, bwd = dt.launches_per_call(dt.trunk_plan(slots, dense_tile(gs), dims), dims)
        return [fwd * (tr + ev), bwd * tr, 0, 0]
    return [len(dims) * (tr + ev), len(dims) * tr, tr + ev, tr]


def exchange_check(gs, cfg, grid, dev) -> dict:
    """The halo exchange at the run's halo H and shard S and at the layer
    widths, forward and backward, point to point and through the
    all-reduce, bitwise equal; the transport the halo layout picks here
    (`exchange_for`), each exchange's elements out of this rank and ms a
    call (`exchange_ms`)."""
    from dgcnn_tpu_torch.batching.shard_pack import halo_bucket
    from dgcnn_tpu_torch.parallel import halo

    b = halo_bucket(gs, cfg.batch_size, *grid.shape, cfg.node_pad_multiple,
                    cfg.edge_pad_multiple, cfg.graph_pad_multiple)
    n, g, h = grid.n_graph, grid.g, b.halo
    chosen = halo.exchange_for(grid.graph_group, torch.empty(0, device=dev)).__name__
    out = {"transport": chosen, "H": h, "S": b.shard_nodes, "widths": {}}
    for f in EXCHANGE_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(11 + grid.rank)
        arr = torch.randn((b.shard_nodes, f), generator=gen, device=dev)
        cot = torch.randn((b.shard_nodes + 2 * h, f), generator=gen, device=dev)
        res, ms = {}, {}
        for name, swap in (("p2p", halo._swap_point_to_point),
                           ("all_reduce", halo._swap_by_all_reduce)):
            x = arr.clone().requires_grad_(True)
            y = halo.HaloExchange.apply(x, h, grid.graph_group, g, n, swap)
            y.backward(cot)
            res[name] = (y.detach(), x.grad)
            ms[name] = exchange_ms(swap, arr, h, grid)
        if not all(torch.equal(a, c) for a, c in zip(res["p2p"], res["all_reduce"])):
            raise AssertionError(f"the exchange at F={f} differs point to point vs "
                                 f"all-reduce")
        neighbours = (g > 0) + (g < n - 1)
        out["widths"][str(f)] = {"p2p_elements_out": neighbours * h * f,
                                 "all_reduce_buffer_elements": n * 2 * h * f,
                                 "p2p_ms": ms["p2p"], "all_reduce_ms": ms["all_reduce"]}
    return out


def exchange_ms(swap, arr, h: int, grid, reps: int = 20) -> float:
    """Ms a call of one exchange of `arr`'s first and last `h` rows by
    `swap`: CUDA events around `reps` eager calls, every rank at once (the
    host's dispatch of each call included)."""
    torch.cuda.synchronize()
    torch.distributed.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        swap(arr[:h], arr[-h:], grid.graph_group, grid.g, grid.n_graph)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def engine_run(tmp, name, data_type, gs, grid_shape, over, kernel, dev) -> dict:
    """One mesh engine run on this rank: graphed, eager, dropout 0 (and
    rank 0's one device), the halo exchange check."""
    from dgcnn_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(grid_shape, dev)
    cfg = config(tmp, name, data_type, FOLDS, EPOCHS, mesh_shape=grid_shape, **over)
    out = {"want": launches_want(cfg, gs, kernel, grid_shape)}
    out["graphed"] = counted_cv(cfg, gs, grid, True)
    out["eager"] = counted_cv(dataclasses.replace(
        cfg, statistics_dir=cfg.statistics_dir + "_eager",
        epochs_dir=cfg.epochs_dir + "_eager"), gs, grid, False)
    zero = config(tmp, name + " dropout0", data_type, FOLDS, 1, mesh_shape=grid_shape,
                  dropout_rate=0.0, **over)
    out["dropout0"] = counted_cv(zero, gs, grid, True)
    if grid.writer:
        from dgcnn_tpu_torch.train.cv import run_cross_validation

        one = dataclasses.replace(
            zero, mesh_shape=(1, 1), cv_parallel="sequential",
            layout="coo" if over["layout"] == "halo" else over["layout"],
            statistics_dir=zero.statistics_dir + "_one", epochs_dir=zero.epochs_dir + "_one")
        run_cross_validation(one, dataset=gs, device=dev)
        out["one_rows"] = rows_of(one)
    if over["layout"] == "halo":
        out["exchange"] = exchange_check(gs, cfg, grid, dev)
    if over["layout"] == "halo" or over.get("coo_assembly") == "host":
        out["pack_s"] = pack_seconds(cfg, gs, grid)
    torch.distributed.barrier()  # the others wait while rank 0 runs one device
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fold_run(tmp, name, data_type, gs, grid_shape, over, dev) -> dict:
    """One fold-sharded lockstep run on this rank: graphed, eager, and
    rank 0's one-device lockstep."""
    from dgcnn_tpu_torch.parallel.mesh import make_mesh
    from dgcnn_tpu_torch.train import cv

    grid = make_mesh(grid_shape, dev)
    cfg = config(tmp, name, data_type, *FOLD_DEPTH, mesh_shape=grid_shape,
                 max_fused_epochs=1, **over)
    layout = cv.choose_layout(cfg, gs)
    out = {"lockstep": cv.lockstep_engages(cfg, gs, layout), "layout": layout}
    out["graphed"] = counted_cv(cfg, gs, grid, True)
    out["eager"] = counted_cv(dataclasses.replace(
        cfg, statistics_dir=cfg.statistics_dir + "_eager",
        epochs_dir=cfg.epochs_dir + "_eager"), gs, grid, False)
    if grid.writer:
        one = dataclasses.replace(cfg, mesh_shape=(1, 1),
                                  statistics_dir=cfg.statistics_dir + "_one",
                                  epochs_dir=cfg.epochs_dir + "_one")
        for c in counters().values():
            c.reset()
        cv.run_cross_validation(one, dataset=gs, device=dev)
        out["one_launches"] = counts()
        out["one_rows"] = rows_of(one)
        out["fold_shards"] = events_of(cfg, "run_start")[0].get("fold_shards")
    torch.distributed.barrier()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def join(rank: int, world: int, store: str):
    """Join the `nccl` group of `world` ranks on card `rank`; the device."""
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    return dev


def rank_main(rank: int, world: int, store: str, out_path: str) -> int:
    """One rank: every run of `runs(world)` and `fold_runs(world)`, its
    results as JSON to `out_path`."""
    import torch.distributed as dist

    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.train.cv import fp32_only

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    fp32_only()
    dev = join(rank, world, store)
    try:
        data = {n: synthesize_tu_dataset(n) for n in ("NCI1", "DD")}
        result = {"rank": rank, "runs": {}, "folds": {}}
        with tempfile.TemporaryDirectory() as tmp:
            for name, ds, shape, over, kernel in runs(world):
                result["runs"][name] = engine_run(tmp, name, ds, data[ds], shape, over,
                                                  kernel, dev)
            for name, ds, shape, over, _ in fold_runs(world):
                result["folds"][name] = fold_run(tmp, name, ds, data[ds], shape, over, dev)
        with open(out_path, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


# -- the launcher ---------------------------------------------------------------


def steady(epoch_s, fold=None) -> list:
    """The epoch seconds of the chunks that built no runner."""
    return [s for f, _, s, built in epoch_s if not built and fold in (None, f)]


def check_run(name, grid_shape, kernel, ranks) -> dict:
    r0 = ranks[0]["runs"][name]
    for mode in ("graphed", "eager", "dropout0"):
        for r in ranks[1:]:
            if r["runs"][name][mode]["test"] != r0[mode]["test"]:
                raise AssertionError(f"{name} {mode}: rank {r['rank']}'s test accuracies "
                                     f"differ from rank 0's")
    g, e = r0["graphed"], r0["eager"]
    if g["bundles"] != e["bundles"] or g["rows"] != e["rows"]:
        raise AssertionError(f"{name}: graphed rows or bundles differ from eager")
    if not g["graphs_flag"] or e["graphs_flag"]:
        raise AssertionError(f"{name}: run_start graphs {g['graphs_flag']} / "
                             f"{e['graphs_flag']}")
    want = {k: r0["want"] if k == kernel else [0, 0, 0, 0] for k in g["launches"]}
    for r in ranks:
        for mode in ("graphed", "eager"):
            got = r["runs"][name][mode]["launches"]
            if got != want:
                raise AssertionError(f"{name} {mode}: rank {r['rank']}'s launches {got}, "
                                     f"want {want}")
    got, one = np.asarray(r0["dropout0"]["rows"]), np.asarray(r0["one_rows"])
    if got.shape != one.shape or not np.allclose(got, one, rtol=3e-4, atol=2e-6):
        raise AssertionError(f"{name}: dropout-0 rows {got.tolist()} vs one device's "
                             f"{one.tolist()}")
    worst = float(np.max(np.abs(got - one) / np.maximum(np.abs(one), 2e-6 / 3e-4)))
    out = {"run": name, "grid": list(grid_shape), "kernel": kernel,
           "launches_per_rank": want[kernel], "graphed_steady_s": steady(g["epoch_s"]),
           "eager_steady_s": steady(e["epoch_s"]), "capture_s": g["capture_s"],
           "dropout0_worst_rel": worst}
    if "pack_s" in r0:
        out["pack_s_median"] = r0["pack_s"]
    if "exchange" in r0:
        for r in ranks:
            ex = r["runs"][name]["exchange"]
            if ex["transport"] != "_swap_point_to_point":
                raise AssertionError(f"{name}: rank {r['rank']} exchanged by "
                                     f"{ex['transport']}")
        out["exchange"] = {f"rank {r['rank']}": r["runs"][name]["exchange"] for r in ranks}
    return out


def check_fold(name, grid_shape, kernel, ranks) -> dict:
    r0 = ranks[0]["folds"][name]
    if not r0["lockstep"] or r0["fold_shards"] != grid_shape[0]:
        raise AssertionError(f"{name}: auto did not shard the folds' lockstep")
    g, e = r0["graphed"], r0["eager"]
    if g["rows"] != e["rows"]:
        raise AssertionError(f"{name}: graphed rows differ from eager")
    for r in ranks[1:]:
        if r["folds"][name]["graphed"]["test"] != g["test"]:
            raise AssertionError(f"{name}: rank {r['rank']}'s gathered accuracies differ")
    got, one = np.asarray(g["rows"]), np.asarray(r0["one_rows"])
    if got.shape != one.shape or not np.allclose(got, one, rtol=5e-4, atol=5e-4):
        raise AssertionError(f"{name}: rows vs one device's lockstep")
    want = {k: r0["one_launches"][k] if k == kernel else [0, 0, 0, 0]
            for k in r0["one_launches"]}
    if not any(want[kernel]):
        raise AssertionError(f"{name}: one device launched no {kernel}")
    for r in ranks:
        for mode in ("graphed", "eager"):
            if r["folds"][name][mode]["launches"] != want:
                raise AssertionError(f"{name} {mode}: rank {r['rank']}'s launches "
                                     f"{r['folds'][name][mode]['launches']}, want {want}")
    return {"run": name, "grid": list(grid_shape), "kernel": kernel,
            "launches_per_rank": want[kernel], "graphed_steady_s": steady(g["epoch_s"]),
            "eager_steady_s": steady(e["epoch_s"]), "capture_s": g["capture_s"],
            "bitwise_one_device": bool(np.array_equal(got, one))}


def spawn(cards: int, tmp: str) -> list:
    """Every rank's results. When a rank fails, or the ranks outlast
    RANK_TIMEOUT, every rank still running is killed at once (the others
    would wait in a collective) and this raises with the ranks' output."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(cards)]
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(cards)]
    procs = []
    for r in range(cards):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dgcnn_tpu_torch.tools.mesh_cards", "--rank", str(r),
                 "--cards", str(cards), "--store", os.path.join(tmp, "store"), "--out",
                 outs[r]], stdout=log, stderr=subprocess.STDOUT, cwd=root))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        texts = []
        for r, (p, path) in enumerate(zip(procs, logs)):
            with open(path) as f:
                texts.append(f"--- rank {r} (exit {p.returncode})\n{f.read()[-6000:]}")
        raise AssertionError("a rank failed or the ranks outlasted "
                             f"{RANK_TIMEOUT} s:\n" + "\n".join(texts))
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the mesh engines on one nccl rank a card")
    p.add_argument("--cards", type=int, default=4, help="ranks, one a card (default 4)")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    p.add_argument("--out", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:  # one rank, started by the launcher
        return rank_main(args.rank, args.cards, args.store, args.out)
    if not torch.cuda.is_available():
        print("mesh_cards: CUDA is not available: it needs one card a rank",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < args.cards:
        print(f"mesh_cards: {args.cards} cards asked, {torch.cuda.device_count()} found: "
              f"it runs one nccl rank a card and never fewer", file=sys.stderr)
        return 1
    from dgcnn_tpu_torch import graft_entry
    from dgcnn_tpu_torch.kernels import _build
    from dgcnn_tpu_torch.utils.profiling import card_line

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    _build.build_all()  # once, before the ranks load the libraries
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn(args.cards, tmp)
    checked = [check_run(name, shape, kernel, ranks)
               for name, _, shape, _, kernel in runs(args.cards)]
    checked += [check_fold(name, shape, kernel, ranks)
                for name, _, shape, _, kernel in fold_runs(args.cards)]
    for c in checked:
        print(f"{c['run']} {c['grid']} ({c['kernel']}, {c['launches_per_rank']} launches "
              f"a rank as one device's): steady fold-epoch s graphed "
              f"{c['graphed_steady_s']}, eager {c['eager_steady_s']}; capture s "
              f"{c['capture_s']}" + (f"; host pack s a call (median) {c['pack_s_median']}"
                                     if "pack_s_median" in c else ""), flush=True)
        if "exchange" in c:
            print(f"{c['run']} exchange, point to point vs all-reduce, bitwise: "
                  + json.dumps(c["exchange"]), flush=True)
    t1 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(args.cards)
    dry_s = time.perf_counter() - t1
    print(f"dryrun_multichip({args.cards}) in {dry_s:.1f} s: {json.dumps(dry)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "cards": args.cards, "card": card, "runs": checked,
                      "dryrun": dry, "dryrun_s": dry_s,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
