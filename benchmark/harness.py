"""One run of one cell on one rank: inputs from the seed, the program's
set-up, the measured window, the traced stretch (`--trace 1`), then the
reference and the comparison. Everything about a cell is found by name:
the workload in BENCHMARK.json, `configs/<config>.json` and its model
family's reference and work modules (benchmark/family.py),
`traffic/<traffic>.json`, `limits/<cell>.json` and, for `--trace 1`,
`metrics/<metric>.py` for each per-layer metric the cell reports. The
reference's dropout rows come from the map of the layout and fold
schedule (sequential or lockstep) the program chose (`ROW_MAPS`: one for
every engine `make_engine` builds on one card).

A sequential cell checks `CHECK_FOLDS` further folds after the window
(`drive.check_folds`) besides fold 1's set-up epochs."""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed

from benchmark import check, family, trace
from benchmark.inputs import HERE, load_config, load_json, make_inputs
from benchmark.reference.layout import DenseRows, MultiRows

ROOT = os.path.dirname(HERE)
CHECK_FOLDS = 3


def benchmark_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(name: str) -> dict:
    for w in benchmark_json()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(cell: str) -> tuple:
    """(configuration, traffic) of a cell, by the names in its workload."""
    w = workload(cell)
    return load_config(w["config"]), load_json("traffic", w["traffic"] + ".json")


def end_to_end_metrics(cell: str) -> list:
    """The end-to-end metrics this cell reports, in BENCHMARK.json's order."""
    return [m for m in benchmark_json()["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer_metrics(cell: str) -> list:
    """The per-layer metrics this cell reports, in BENCHMARK.json's order."""
    return [m for m in benchmark_json()["per_layer"]
            if cell in m.get("workloads", [cell])]


def read_metric(name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _join(world: int, rank: int, store_path: str, device: torch.device):
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                            rank=rank, world_size=world)
    return store


def _stop_on_rank0(device):
    import torch.distributed as dist

    def stop(done: bool) -> bool:
        flag = torch.tensor([1 if done else 0], dtype=torch.int32, device=device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    return stop


def _slot_rows(pcfg, inp, su: dict, fold: int):
    return DenseRows(pcfg.batch_size, pcfg.graph_pad_multiple)


def _multi_rows(pcfg, inp, su: dict, fold: int):
    """Folds one after another: the slot floors only grow over a run, so
    the chunks `su["before"]` (`drive.Sequential.log`) ahead of the
    fold's set-up epochs grow them first."""
    rows = MultiRows(np.diff(inp.graphs["node_ptr"]), pcfg.batch_size,
                     pcfg.multi_dense_min_tile, pcfg.seed)
    rng = None
    for f, k in su["before"]:
        train, test = inp.folds[f]
        if k == 0:
            rng = inp.shuffle(f)
            continue
        rows.grow(*(train[rng.permutation(len(train))] for _ in range(k)), test)
    for ids in inp.epoch_ids(fold, 3):
        rows.start_chunk(ids, inp.folds[fold][1])
    return rows


def _multi_lockstep_rows(pcfg, inp, su: dict, fold: int):
    """In lockstep each set-up chunk grows the floors over every fold's."""
    rows = MultiRows(np.diff(inp.graphs["node_ptr"]), pcfg.batch_size,
                     pcfg.multi_dense_min_tile, pcfg.seed)
    epochs = [inp.epoch_ids(f, 3) for f in su["folds"]]
    tests = [inp.folds[f][1] for f in su["folds"]]
    for e in range(3):
        rows.start_chunk(*(ids[e] for ids in epochs), *tests)
    return rows


# (layout, lockstep) → the dropout-row map of every engine make_engine
# builds on one card (reference/layout.py); COO never runs in lockstep
ROW_MAPS = {("dense", False): _slot_rows, ("dense", True): _slot_rows,
            ("block", False): _slot_rows, ("block", True): _slot_rows,
            ("coo", False): _slot_rows,
            ("multi", False): _multi_rows, ("multi", True): _multi_lockstep_rows}


def _rows_for(prog, inp, su: dict, fold: int):
    """The reference's dropout-row map of fold `fold`'s set-up epochs in
    `su` (`drive.set_up`'s or `drive.check_folds`')."""
    return ROW_MAPS[prog.layout, prog.lockstep](prog.pcfg, inp, su, fold)


def checked(sus: list):
    """(i, fold) of every fold this rank checks: `sus[i]` from
    `drive.set_up` (i = 0) or `drive.check_folds` (i ≥ 1)."""
    return [(i, f) for i, su in enumerate(sus) for f in su["folds"]]


def rows_maps(prog, inp, sus: list) -> dict:
    """The dropout-row map of every checked fold, by (i, fold)."""
    return {(i, f): _rows_for(prog, inp, sus[i], f) for i, f in checked(sus)}


def reference_readings(inp, sus: list, rows_for: dict, device, **kw) -> dict:
    """The reference over this rank's checked folds (`kw` plants TF32 or a
    fault), by "i:fold": its epoch-1 losses trained from the seed's
    weights, its evaluations of the program's weights after each set-up
    epoch, and the program's state against it (`check.state_gaps`)."""
    ref = family.of(inp.cfg).reference
    g = ref.Graphs(inp.graphs, device)
    model, train = inp.cfg["model"], inp.cfg["train"]
    out = {}
    for i, f in checked(sus):
        su, test = sus[i], inp.folds[f][1]
        traj = ref.follow(g, model, train, inp.params[f], inp.epoch_ids(f, 1), test,
                          inp.dropout_seeds[f], rows_for[i, f], **kw)
        out[f"{i}:{f}"] = {
            "train_loss": traj["train_loss"][0], "test_loss": traj["test_loss"][0],
            "evals": [ref.evaluate(g, model, p[f], test, train["batch_size"], **kw)
                      for p in su["p"]],
            **check.state_gaps(su["p0"][f], su["m1"][f], su["v1"][f], su["p"][0][f], traj)}
    return out


def program_rows(sus: list) -> dict:
    """Rank 0's rows [3, 4] by "i:fold" (in lockstep on a grid every fold's,
    after the exchange)."""
    return {f"{i}:{f}": np.stack([e[j] for e in su["rows"]])
            for i, su in enumerate(sus) for j, f in enumerate(su["row_folds"])}


def compared(sus: list, refs: list) -> dict:
    """The numbers of `check` from rank 0's rows and every rank's
    `reference_readings`."""
    rows = program_rows(sus)
    return check.numbers([{**r, **check.fold_numbers(rows[key], r)}
                          for ref in refs for key, r in ref.items()])


def run_rank(cell: str, seed: int, seconds: float, traced: bool, device, t_start: float,
             rank: int = 0, world: int = 1, store_path: str = "",
             num_graphs: int = 0) -> dict:
    """This rank's part of the run. Rank 0 returns the result line; every
    other rank posts its numbers to the store and returns them."""
    from benchmark import drive

    device = torch.device(device)
    cfg, traffic = cell_files(cell)
    limits = load_json("limits", cell + ".json")
    store = grid = None
    if world > 1:
        from dgcnn_tpu_torch.parallel.mesh import make_mesh

        store = _join(world, rank, store_path, device)
        grid = make_mesh(tuple(traffic["mesh"]), device)
    phases = {"start_s": time.time() - t_start}
    inp = make_inputs(cfg, seed, device, num_graphs)
    phases["inputs_s"] = time.time() - t_start
    prog = drive.Program(inp, traffic, device, grid)
    phases["engine_s"] = time.time() - t_start
    su = drive.set_up(prog)
    if grid is not None:
        grid.barrier()
    setup_s = time.time() - t_start
    win = drive.window(prog, seconds, _stop_on_rank0(device) if grid is not None else None)
    phases.update(setup_s=setup_s, window_s=win["seconds"])
    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    mine = {"rank": rank, "graphs": win["graphs"], "fold_epochs": win["fold_epochs"],
            "unfinite": win["unfinite"], "peak": peak}
    if traced:
        stretch, events, wall = trace.profiled(lambda: drive.stretch(prog), device)
        done = {}
        for f, k in stretch:
            fe = family.of(cfg).work.fold_epoch(inp.graphs, cfg["model"], *inp.folds[f])
            for key, v in fe.items():
                done[key] = done.get(key, 0.0) + k * v
        mine["trace"] = {**trace.summarize(events, wall), "work": done,
                         "epochs": stretch[0][1] if stretch else 0}
        del events
        phases["trace_s"] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
    sus = [su] + drive.check_folds(prog, CHECK_FOLDS)
    phases["check_folds_s"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    layout, lockstep = prog.layout, prog.lockstep
    rows_for = rows_maps(prog, inp, sus)
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    mine["ref"] = reference_readings(inp, sus, rows_for, device)
    phases["reference_s"] = time.perf_counter() - t_phase
    left_out = sum(r["left_out"] for r in mine["ref"].values())
    print(f"rank {rank} ({layout}, {'lockstep' if lockstep else 'sequential'}"
          f"): " + " ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f"; runners built in the window {sum(s['built'] for s in win['spans'])}"
          + f"; leaves left out {left_out}", file=sys.stderr, flush=True)
    if rank != 0:
        store.set(f"rank{rank}", json.dumps(mine))
        torch.distributed.destroy_process_group()
        return mine

    ranks = [mine] + [json.loads(store.get(f"rank{r}")) for r in range(1, world)]
    if world > 1:
        torch.distributed.destroy_process_group()
    numbers = compared(sus, [r["ref"] for r in ranks])
    result = {"correct": check.verdict(numbers, limits),
              "attempted": sum(r["fold_epochs"] for r in ranks),
              "failed": sum(r["unfinite"] for r in ranks)}
    ctx = {"spans": win["spans"], "switches": win["switches"],
           "ranks": [r.get("trace") for r in ranks]}
    if traced:
        metrics = {}
        for m in per_layer_metrics(cell):
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"graphs_per_s": sum(r["graphs"] for r in ranks) / win["seconds"],
                  "peak_mem_mib": max(r["peak"] for r in ranks) / 2**20,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_metrics(cell)}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                        "count": world, "memory_peak_bytes": max(r["peak"] for r in ranks)}
    if traced:
        tr = [r["trace"] for r in ranks]
        result["device"]["busy_s"] = float(np.mean([t["busy_s"] for t in tr]))
        result["device"]["window_s"] = float(np.mean([t["window_s"] for t in tr]))
        result["breakdown"] = {key: _merged([t[key] for t in tr]) for key in
                               ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return result


def _merged(lists, top: int = 10) -> list:
    total = {}
    for pairs in lists:
        for name, s in pairs:
            total[name] = total.get(name, 0.0) + s
    return [[n[:160], s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]
