"""One rank of a CPU process grid, for the port's mesh tests (a helper,
not a test file; it imports only torch, numpy and the port).

    python tests/torch_mesh_worker.py RANK WORLD STORE JOBS OUT

joins a `gloo` group of WORLD ranks through the FileStore STORE, runs
torch on one thread, runs each job of the JSON list JOBS in order and
saves what they return to the .npz OUT, keys `<job name>/<key>`. A job
that raises on one rank would leave the others waiting in a collective:
the group's timeout (60 s) ends them, and the caller's subprocess timeout
ends the rest.

Jobs (`kind`):
  coo_loss     the deterministic sharded loss (`make_sharded_loss`) of one
               global batch packed by `shard_batch_for_dp`; with `grads`,
               the gradients after `reduce_gradients`
  engine_loss  an engine's DP loss (`make_dense_dp_loss`,
               `make_device_coo_dp_loss`, `make_block_dp_loss`) of one
               [n_data, slots] order row
  epoch        one DP training epoch (`make_dp_train_epoch`, dropout 0)
               over a `pack_epoch_dp` epoch; the parameters after it
  cv           `run_cross_validation` on the mesh: the result, every
               fold's parameters after its last chunk, and how many files
               this rank wrote; `crash_at` raises from the engine's chunk
               of that index (every rank), after which `resume` runs the
               same config with `checkpoint_resume`
  mismatch     `make_mesh` of a grid whose size is not the world's
  halo_loss    the halo layout's deterministic loss (`make_halo_loss`) of
               one global batch packed by `pack_step_halo` (this rank's
               shard), the log-probs of the rank's slots, and the gradients
               summed over all D·G ranks (`grad_groups`) and, for contrast,
               over the data group alone
  cli          `dgcnn_tpu_torch.cli.main(argv)` on this grid's process group
  halo_swap    `HaloExchange` of a seeded [S, F] array and the backward of a
               seeded cotangent, by each transport (point to point, the
               all-reduce), and the transport `exchange_for` picks here
  graphed_cv   a `cv` job run eagerly, then on a stand-in card
               (`stand_in_card`): the mesh runners built as on the card
               under nccl, every epoch after a runner's first a "replay"
               that runs the captured body; both runs' rows and
               parameters, the replays, and the run_start's `graphs`
  replicas     `ProcessGrid.check_replicas` of tensors equal on every rank,
               of tensors one bit apart on rank 1, and of two elements
               swapped on rank 1: whether each raised

A `cv` job runs every layout through `run_cross_validation`, fold-sharded
lockstep too: there `crash_at` counts the lockstep chunks
(`cv_vmap.lockstep_chunk`), which every rank that trains folds calls at
once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dgcnn_tpu_torch.config import Config  # noqa: E402
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset  # noqa: E402
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet  # noqa: E402
from dgcnn_tpu_torch.parallel import mesh, shard, train_dp  # noqa: E402
from dgcnn_tpu_torch.parity.convert import state_to_params  # noqa: E402
from dgcnn_tpu_torch.train import cv, metrics  # noqa: E402
from dgcnn_tpu_torch.train.loop import make_optimizer  # noqa: E402


def dataset(job):
    return synthesize_tu_dataset(job["data"], num_graphs=job["graphs"], seed=job["seed"])


def net_from(job, gs, dropout=0.5):
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                  dropout_rate=dropout, compute_dtype=job.get("dtype", "float32"))
    with np.load(job["params"]) as z:
        state = {k: torch.from_numpy(z[k].copy()) for k in z.files}
    return DGCNNNet(model, state_to_params(state))


def grads_of(net):
    return {f"grad/{n}": p.grad.numpy().copy() for n, p in net.named_parameters()}


def params_of(net):
    return {f"param/{n}": p.detach().numpy().copy() for n, p in net.named_parameters()}


def coo_loss(job, rank):
    gs = dataset(job)
    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    d, g = grid.shape
    bucket = shard.shard_bucket(gs, len(job["idx"]), d, n_graph=g)
    step = shard.shard_batch_for_dp(gs, np.asarray(job["idx"]), bucket, d, g)
    net = net_from(job, gs)
    loss, correct = train_dp.make_sharded_loss(grid, job.get("spmm", "xla"),
                                               deterministic=True)(net, step)
    out = {"loss": loss.detach().numpy(), "correct": correct.numpy()}
    if job.get("grads"):
        loss.backward()
        train_dp.reduce_gradients(net.parameters(), grid.data_group)
        out.update(grads_of(net))
    return out


def engine_loss(job, rank):
    from dgcnn_tpu_torch.batching.block_sparse import (
        block_graphset_to_device, build_block_graphset)
    from dgcnn_tpu_torch.batching.dense import build_dense_dataset, dense_tile
    from dgcnn_tpu_torch.batching.device_coo import (
        build_device_graphset, device_graphset_to)
    from dgcnn_tpu_torch.batching.packer import BucketSpec

    gs = dataset(job)
    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    rows = torch.tensor(job["rows"], dtype=torch.int32)
    if job["layout"] == "dense":
        data = build_dense_dataset(gs, dense_tile(gs), "cpu")
        fn = train_dp.make_dense_dp_loss(data, grid, True)
    elif job["layout"] == "coo":
        dev = device_graphset_to(build_device_graphset(gs), "cpu")
        fn = train_dp.make_device_coo_dp_loss(dev, grid, BucketSpec(*job["bucket"]),
                                              "xla", True)
    else:
        dev = block_graphset_to_device(build_block_graphset(gs), "cpu")
        fn = train_dp.make_block_dp_loss(dev, grid, *job["budget"], True)
    loss, correct = fn(net_from(job, gs), rows)
    return {"loss": loss.detach().numpy(), "correct": correct.numpy()}


def epoch(job, rank):
    gs = dataset(job)
    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    d, g = grid.shape
    bs = job["batch"]
    bucket = shard.shard_bucket(gs, bs, d, n_graph=g)
    batches = shard.pack_epoch_dp(gs, np.asarray(job["order"]), bs, bucket, d, g)
    net = net_from(job, gs, dropout=0.0)
    opt = make_optimizer(net)
    gen = torch.Generator().manual_seed(0)  # dropout 0: draws, but masks nothing
    loss, correct = train_dp.make_dp_train_epoch(net, opt, grid)(batches, gen)
    return {"loss": loss.numpy(), "correct": correct.numpy(), **params_of(net)}


class Crash(RuntimeError):
    pass


def _run_cv(cfg, gs, crash_at=None, init=None):
    """`run_cross_validation` with each mesh engine's chunks wrapped: the
    parameters after every chunk of every fold are kept (the last one per
    fold is the fold's result), and the chunk `crash_at` raises (a
    lockstep chunk in lockstep). `init` (an .npz of fold-stacked states,
    fold f's at row f − 1) replaces the lockstep folds' initial weights."""
    from dgcnn_tpu_torch.train import cv_vmap

    seen, calls = {}, [0]
    wrapped = {cls: cls.run_epochs for cls in cv.MESH_ENGINES}  # before any wrap
    saved_chunk, saved_init = cv_vmap.lockstep_chunk, cv_vmap.init_params

    def lockstep_chunk(*a, **k):
        calls[0] += 1
        if crash_at is not None and calls[0] == crash_at:
            raise Crash(f"chunk {crash_at}")
        return saved_chunk(*a, **k)

    cv_vmap.lockstep_chunk = lockstep_chunk
    if init is not None:
        with np.load(init) as z:
            stacked = {k: torch.from_numpy(z[k].copy()) for k in z.files}
        by_seed = {cv._stream_seed(cfg.seed, f + 1, 1): f
                   for f in range(next(iter(stacked.values())).shape[0])}

        def init_params(gen, model, device="cpu"):
            f = by_seed.get(gen.initial_seed())
            if f is None:  # not a fold's initial weights
                return saved_init(gen, model, device)
            return state_to_params({k: v[f].to(device) for k, v in stacked.items()})

        cv_vmap.init_params = init_params
    for cls, orig in wrapped.items():

        def run_epochs(self, net, optimizer, dropout_gen, perms, _orig=orig):
            calls[0] += 1
            if crash_at is not None and calls[0] == crash_at:
                raise Crash(f"chunk {crash_at}")
            rows = _orig(self, net, optimizer, dropout_gen, perms)
            seen[self._fold] = (type(self).__name__, params_of(net), rows)
            return rows

        cls.run_epochs = run_epochs
    writes = [0]
    saved = (cv.save_checkpoint, metrics.FoldMetrics.to_csv, cv.write_overall_csv)

    def counting(fn):
        def f(*a, **k):
            writes[0] += 1
            return fn(*a, **k)
        return f

    cv.save_checkpoint = counting(saved[0])
    metrics.FoldMetrics.to_csv = counting(saved[1])
    cv.write_overall_csv = counting(saved[2])
    cv_vmap.save_checkpoint = cv.save_checkpoint
    try:
        res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    finally:
        for cls, orig in wrapped.items():
            cls.run_epochs = orig
        cv.save_checkpoint, metrics.FoldMetrics.to_csv, cv.write_overall_csv = saved
        cv_vmap.lockstep_chunk, cv_vmap.init_params = saved_chunk, saved_init
        cv_vmap.save_checkpoint = saved[0]
    return res, seen, writes[0]


def cv_job(job, rank):
    gs = dataset(job)
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in job["cfg"].items()})
    out = {}
    init = job.get("init")
    if job.get("crash_at"):
        try:
            _run_cv(cfg, gs, job["crash_at"], init)
            raise AssertionError("the run did not crash")
        except Crash:
            out["crashed"] = np.asarray(1)
        cfg = dataclasses.replace(cfg, checkpoint_resume=True)
    res, seen, writes = _run_cv(cfg, gs, init=init)
    out["test_accuracies"] = np.asarray(res["test_accuracies"], dtype=np.float64)
    out["train_accuracies"] = np.asarray(res["train_accuracies"], dtype=np.float64)
    out["writes"] = np.asarray(writes)
    for fold, (engine, params, rows) in seen.items():
        out[f"fold{fold}/engine"] = np.asarray(engine)
        out[f"fold{fold}/rows"] = rows
        out.update({f"fold{fold}/{k}": v for k, v in params.items()})
    return out


def mismatch(job, rank):
    try:
        mesh.make_mesh(tuple(job["mesh"]), "cpu")
    except ValueError as e:
        return {"error": np.asarray(str(e))}
    return {"error": np.asarray("")}


def halo_loss(job, rank):
    from dgcnn_tpu_torch.batching.shard_pack import pack_step_halo
    from dgcnn_tpu_torch.parallel.halo import apply_halo, grad_groups, make_halo_loss

    gs = dataset(job)
    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    local = pack_step_halo(gs, np.asarray(job["idx"]), *grid.shape, *job["bucket"],
                           rank=(grid.d, grid.g)).map(torch.from_numpy)
    net = net_from(job, gs)
    with torch.no_grad():
        lp = apply_halo(net.params(), net.model, local, group=grid.graph_group, g=grid.g,
                        n_graph=grid.n_graph)
    loss, correct = make_halo_loss(grid, deterministic=True)(net, local)
    loss.backward()
    own = {n: p.grad.clone() for n, p in net.named_parameters()}
    data_only = {f"data_only/{n}": mesh.sum_over(g.clone(), grid.data_group).numpy()
                 for n, g in own.items()}
    for group in grad_groups(grid):
        train_dp.reduce_gradients(net.parameters(), group)
    return {"lp": lp.numpy(), "graph_mask": local.graph_mask.numpy(),
            "loss": loss.detach().numpy(), "correct": correct.numpy(),
            **grads_of(net), **data_only}


def cli_job(job, rank):
    from dgcnn_tpu_torch import cli

    res = cli.main(job["argv"])  # the process group is this grid's
    return {"test_accuracies": np.asarray(res["test_accuracies"], dtype=np.float64)}


def halo_swap(job, rank):
    from dgcnn_tpu_torch.parallel.halo import (
        HaloExchange, _swap_by_all_reduce, _swap_point_to_point, exchange_for)

    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    h, s, f = job["h"], job["s"], job["f"]
    gen = torch.Generator().manual_seed(100 + rank)
    arr = torch.randn((s, f), generator=gen)
    cot = torch.randn((s + 2 * h, f), generator=gen)
    out = {"arr": arr.numpy(), "cot": cot.numpy(),
           "transport": np.asarray(exchange_for(grid.graph_group, arr).__name__)}
    for name, swap in (("p2p", _swap_point_to_point), ("all_reduce", _swap_by_all_reduce)):
        x = arr.clone().requires_grad_(True)
        y = HaloExchange.apply(x, h, grid.graph_group, grid.g, grid.n_graph, swap)
        y.backward(cot)
        out[f"{name}/fwd"] = y.detach().numpy()
        out[f"{name}/bwd"] = x.grad.numpy()
    return out


class ReplayGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the body that
    was captured, which is what the card executes on a replay."""

    def __init__(self, body):
        self.body = body
        self.replays = 0
        self.generators = []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        self.body()


@contextlib.contextmanager
def stand_in_card():
    """Every grid `graphed` (as under nccl on the card), every `FusedRun`
    graphed: its first epoch the warm-up, then a `ReplayGraph` of its body
    with its dropout generators registered (a capture executes nothing,
    so none runs the body here). Yields the graphs made."""
    from dgcnn_tpu_torch.train import loop

    made = []
    saved = (mesh.ProcessGrid.graphed, loop.FusedRun.__init__,
             loop.FusedRun._warm_up_and_capture)

    def init(self, *a, **k):
        saved[1](self, *a, **k)
        self.graphs = True

    def warm_up_and_capture(self):
        self.body()
        graph = ReplayGraph(self.body)
        for gen in self.generators:
            graph.register_generator_state(gen)
        self.graph = loop.CountedGraph(graph)
        self.graph.per_replay = [{} for _ in self.graph.counters]
        self.capture_seconds = 0.0
        made.append(graph)

    mesh.ProcessGrid.graphed = property(lambda self: True)
    loop.FusedRun.__init__ = init
    loop.FusedRun._warm_up_and_capture = warm_up_and_capture
    try:
        yield made
    finally:
        (mesh.ProcessGrid.graphed, loop.FusedRun.__init__,
         loop.FusedRun._warm_up_and_capture) = saved


def graphed_cv(job, rank):
    out = {}
    for mode in ("eager", "graphed"):
        cfg = dict(job["cfg"], statistics_dir=f"{job['cfg']['statistics_dir']}_{mode}",
                   epochs_dir=f"{job['cfg']['epochs_dir']}_{mode}")
        with (stand_in_card() if mode == "graphed" else contextlib.nullcontext([])) as made:
            res = cv_job(dict(job, cfg=cfg), rank)
        out.update({f"{mode}/{k}": v for k, v in res.items()})
        out[f"{mode}/replays"] = np.asarray([g.replays for g in made])
        out[f"{mode}/dropout_gens"] = np.asarray([len(g.generators) for g in made])
        if rank == 0:
            with open(os.path.join(cfg["statistics_dir"],
                                   f"{cfg['data_type']}_events.jsonl")) as f:
                start = next(e for e in map(json.loads, f) if e["kind"] == "run_start")
            out[f"{mode}/graphs"] = np.asarray(start["graphs"])
            out[f"{mode}/engine"] = np.asarray(start["engine"])
    return out


def replicas(job, rank):
    grid = mesh.make_mesh(tuple(job["mesh"]), "cpu")
    x = torch.arange(1.0, 6.0)
    one_bit = x.clone()
    swapped = x.clone()
    if rank == 1:
        one_bit[3] = torch.nextafter(one_bit[3], torch.tensor(9.0))
        swapped[[1, 2]] = swapped[[2, 1]]
    out = {}
    for name, ts in (("same", [x, torch.ones(2, 3)]), ("one_bit", [one_bit]),
                     ("swapped", [swapped])):
        try:
            grid.check_replicas(ts, name)
            out[name] = 0
        except RuntimeError:
            out[name] = 1
    return out


JOBS = {"halo_loss": halo_loss, "halo_swap": halo_swap, "graphed_cv": graphed_cv,
        "replicas": replicas, "cli": cli_job, "coo_loss": coo_loss,
        "engine_loss": engine_loss, "epoch": epoch, "cv": cv_job,
        "mismatch": mismatch}


def spawn(tmp, world: int, jobs: list, timeout: float = 120.0) -> list:
    """Run `jobs` on a grid of `world` ranks, each this script in its own
    process, in the directory `tmp` (the store, the job list, the outputs);
    returns each rank's results, a dict of arrays. Raises with the ranks'
    output when one fails, and kills every rank still running at the
    `timeout` (seconds, for all of them together)."""
    import pathlib
    import subprocess
    import time

    tmp = pathlib.Path(tmp)
    jobs_path = tmp / "jobs.json"
    jobs_path.write_text(json.dumps(jobs))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(tmp / "store"), str(jobs_path), str(tmp / f"out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank of {world} did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited {p.returncode}:\n"
                                 + "\n".join(f"--- rank {i}\n{t[-4000:]}"
                                             for i, t in enumerate(logs)))
    out = []
    for r in range(world):
        with np.load(tmp / f"out{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, jobs_path, out_path = argv[3], argv[4], argv[5]
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(jobs_path) as f:
            jobs = json.load(f)
        out = {}
        for job in jobs:
            print(f"[rank {rank}] job {job['name']}", flush=True)
            res = JOBS[job["kind"]](job, rank)
            out.update({f"{job['name']}/{k}": np.asarray(v) for k, v in res.items()})
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
