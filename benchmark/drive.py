"""The program side of a run: the calls `run_cross_validation` makes,
driven chunk by chunk from the benchmark's own inputs, with host-clock
spans around them. The family's program side
(benchmark/program/<family>.py, through `family.of`) gives the Config's
model fields, the model and the nets.

Lockstep (`Lockstep`): `train/cv_vmap.py lockstep_chunk` on the layout's
engine, then the runner's epochs; on a (D, 1) grid each rank runs its
`fold_block` and the rows of every fold reach every rank by
`gather_folds` after each chunk, as `run_cv_folds_lockstep` does.
Sequential (`Sequential`): the engine's `begin_fold` → `run_epochs` (chunks
of `chunk_epochs`) → `end_fold`, 100 epochs a fold, the next fold after.

Set-up drives epochs 1-3 of fold 1 (lockstep: of every fold) as three
chunks of one epoch each through the same runner the window then uses:
epoch 1 warms up and captures, epochs 2 and 3 are replays. Their rows and
the state around them are kept for the comparison with the reference. A
sequential cell, once the window has closed, switches into further folds
on the same engine and keeps their epochs 1-3 in the same way
(`check_folds`), so that what a fold switch resets is compared too.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.cv_vmap import fold_block, gather_folds, lockstep_chunk
from dgcnn_tpu_torch.train.loop import FoldAdam, make_optimizer

from benchmark import family
from benchmark.inputs import Inputs

MOMENTS = {"m": "exp_avg", "v": "exp_avg_sq"}  # Adam's names of its moments


def program_config(cfg: dict, traffic: dict, seed: int) -> Config:
    """The program's Config: the model group through its family
    (`config_fields`), the train and data groups, and the traffic's fold
    schedule, layout and mesh."""
    t = cfg["train"]
    return Config(
        **family.of(cfg).program.config_fields(cfg["model"]),
        data_type=cfg["data"]["profile"], batch_size=t["batch_size"],
        num_epochs=t["num_epochs"], seed=int(seed), num_folds=t["num_folds"],
        learning_rate=t["learning_rate"], adam_b1=t["adam_b1"], adam_b2=t["adam_b2"],
        adam_eps=t["adam_eps"], compute_dtype=t["dtype"],
        max_fused_epochs=t["max_fused_epochs"], cv_parallel=traffic["cv_parallel"],
        layout=traffic["layout"], mesh_shape=tuple(traffic["mesh"]))


def graph_set(inp: Inputs) -> GraphSet:
    g = inp.graphs
    return GraphSet(x=g["x"], node_ptr=g["node_ptr"], edge_src=g["edge_src"],
                    edge_dst=g["edge_dst"], edge_ptr=g["edge_ptr"], y=g["y"],
                    num_classes=g["num_classes"])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The program built for one cell: its config, the layout and driver
    it chooses, and the engine. `layout` and `lockstep` are the program's
    own `choose_layout` / `lockstep_engages` answers."""

    def __init__(self, inp: Inputs, traffic: dict, device, grid=None):
        self.inp, self.device, self.grid = inp, torch.device(device), grid
        self.pcfg = program_config(inp.cfg, traffic, inp.seed)
        self.family = family.of(inp.cfg).program
        cv.fp32_only()
        self.ds = graph_set(inp)
        self.model = self.family.model(self.pcfg, self.ds.num_features,
                                       self.ds.num_classes)
        self.layout = cv.choose_layout(self.pcfg, self.ds)
        self.lockstep = cv.lockstep_engages(self.pcfg, self.ds, self.layout)
        self.engine = cv.make_engine(self.pcfg, self.ds, self.device, self.layout, True,
                                     grid, lockstep=self.lockstep)
        self.driver = (Lockstep if self.lockstep else Sequential)(self)

    def close(self) -> None:
        """Drop the runner, its graph and every tensor of the program."""
        self.engine.end_fold()
        self.driver = self.engine = None


class _Driver:
    """Chunks and their host-clock spans: `spans` holds one record a
    chunk (`folds`, `epochs`, `graphs`, `seconds`, `built`: whether it
    built a runner), `switches` one a fold switch (`seconds` from before
    `end_fold` to the end of the next fold's first chunk, `epochs` that
    chunk's)."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.inp = prog.inp
        self.engine = prog.engine
        self.pcfg = prog.pcfg
        self.spans, self.switches = [], []
        self.recording = False

    def fold_graphs(self, f: int) -> int:
        tr, te = self.inp.folds[f]
        return len(tr) + len(te)

    def _timed(self, k: int, run) -> np.ndarray:
        t0 = time.perf_counter()
        builds = self.engine.runners.builds
        folds, rows = run()
        dt = time.perf_counter() - t0
        if self.recording:
            self.spans.append({"folds": folds, "epochs": k, "seconds": dt,
                               "graphs": k * sum(self.fold_graphs(f) for f in folds),
                               "built": self.engine.runners.builds != builds,
                               "finite": bool(np.isfinite(rows).all())})
        return rows


class Lockstep(_Driver):
    def __init__(self, prog: Program):
        super().__init__(prog)
        inp, pcfg, dev = self.inp, self.pcfg, prog.device
        self.num_folds = pcfg.num_folds
        self.own = fold_block(self.num_folds, prog.grid)
        self.net_f = prog.family.folds_net(
            prog.model, [inp.params[f] for f in self.own]) if self.own else None
        self.adam_f = FoldAdam(self.net_f, pcfg.learning_rate, pcfg.adam_b1,
                               pcfg.adam_b2, pcfg.adam_eps) if self.own else None
        self.gens = [torch.Generator(device=dev).manual_seed(inp.dropout_seeds[f])
                     for f in self.own]
        self.shuffles = {f: inp.shuffle(f) for f in self.own}
        self.epoch = 1

    def chunk(self, k: int) -> np.ndarray:
        """k lockstep epochs; every fold's rows [k, K, 4] (on a grid after
        the gather)."""
        inp, grid = self.inp, self.prog.grid

        def run():
            ids_k = [[inp.folds[f][0][self.shuffles[f].permutation(len(inp.folds[f][0]))]
                      for f in self.own] for _ in range(k)]
            rows = None
            if self.own:
                runner, orders = lockstep_chunk(self.engine, self.net_f, self.adam_f,
                                                self.gens, ids_k,
                                                [inp.folds[f][1] for f in self.own])
                rows = runner.run_epochs(orders)
            if grid is not None:
                local = None if rows is None else torch.from_numpy(
                    np.ascontiguousarray(rows.transpose(1, 0, 2))).to(self.prog.device)
                rows = gather_folds(local, torch.zeros((1, k, 4), dtype=torch.float64),
                                    self.num_folds, grid).cpu().numpy().transpose(1, 0, 2)
            return self.own, rows

        rows = self._timed(k, run)
        self.epoch += k
        return rows

    def at_boundary(self) -> bool:
        return True

    def next_chunk(self) -> np.ndarray:
        """The window's next chunk: `chunk_epochs` of a 100-epoch run; past
        epoch 100 the folds keep training in chunks of `max_fused_epochs`
        on the same runner."""
        e = (self.epoch - 1) % self.pcfg.num_epochs + 1
        return self.chunk(cv.chunk_epochs(self.pcfg, e))

    def leaves(self, which: str) -> dict:
        """Per own fold {leaf: tensor}: the weights ("params") or Adam's
        first or second moment ("m", "v")."""
        named = list(self.net_f.named_parameters())
        runs = ([p for _, p in named] if which == "params"
                else self.adam_f.run_tensors()[MOMENTS[which]])
        return {f: {n: r[i].detach().clone() for (n, _), r in zip(named, runs)}
                for i, f in enumerate(self.own)}


class Sequential(_Driver):
    """`log` holds (fold, epochs) of every chunk in the order run and (fold,
    0) at each `begin`, where the fold's epoch shuffles start anew: it says
    which training orders every chunk had."""

    def __init__(self, prog: Program):
        super().__init__(prog)
        self.fold = -1
        self.log = []
        self.begin(0)

    def begin(self, f: int) -> None:
        inp, pcfg, dev = self.inp, self.pcfg, self.prog.device
        self.fold = f
        self.log.append((f, 0))
        self.engine.begin_fold(*inp.folds[f])
        self.net = self.prog.family.net(self.prog.model,
                                        {n: t.clone() for n, t in inp.params[f].items()})
        self.opt = make_optimizer(self.net, pcfg.learning_rate, pcfg.adam_b1,
                                  pcfg.adam_b2, pcfg.adam_eps)
        self.gen = torch.Generator(device=dev).manual_seed(inp.dropout_seeds[f])
        self.shuffle = inp.shuffle(f)
        self.epoch = 1

    def chunk(self, k: int) -> np.ndarray:
        n = len(self.inp.folds[self.fold][0])
        self.log.append((self.fold, k))

        def run():
            perms = np.stack([self.shuffle.permutation(n) for _ in range(k)])
            return [self.fold], self.engine.run_epochs(self.net, self.opt, self.gen, perms)

        rows = self._timed(k, run)
        self.epoch += k
        return rows[:, None, :]

    def switch(self) -> None:
        self.engine.end_fold()
        self.begin((self.fold + 1) % self.pcfg.num_folds)

    def at_boundary(self) -> bool:
        """Whether the fold has run its epochs: a window ends only here."""
        return self.epoch > self.pcfg.num_epochs

    def next_chunk(self) -> np.ndarray:
        """The window's next chunk; after a fold's last epoch the switch to
        the next fold and that fold's first chunk, timed together."""
        if self.epoch <= self.pcfg.num_epochs:
            return self.chunk(cv.chunk_epochs(self.pcfg, self.epoch))
        t0 = time.perf_counter()
        self.switch()
        rows = self.chunk(cv.chunk_epochs(self.pcfg, self.epoch))
        if self.recording:
            self.switches.append({"seconds": time.perf_counter() - t0,
                                  "epochs": self.spans[-1]["epochs"]})
        return rows

    def leaves(self, which: str) -> dict:
        named = list(self.net.named_parameters())
        if which == "params":
            return {self.fold: {n: p.detach().clone() for n, p in named}}
        # an optimizer that never stepped holds no moment: zeros
        return {self.fold: {n: self.opt.state[p].get(MOMENTS[which], torch.zeros_like(p))
                            .detach().clone() for n, p in named}}

    @property
    def own(self) -> list:
        return [self.fold]


def set_up(prog: Program) -> dict:
    """Epochs 1-3 as three one-epoch chunks. Returns their rows (`rows[e]`
    [folds, 4], fold `row_folds[i]` in row i: on a grid every fold, after
    the gather), and per own fold the weights before (`p0`) and after each
    epoch (`p[e]`), Adam's first and second moments after epoch 1 (`m1`,
    `v1`) and, in a sequential cell, the chunks run before it (`before`,
    `Sequential.log`)."""
    d = prog.driver
    out = {"p0": {f: {n: t.detach().clone() for n, t in prog.inp.params[f].items()}
                  for f in d.own}, "rows": [], "p": []}
    out["before"] = list(d.log) if isinstance(d, Sequential) else []
    for e in range(3):
        out["rows"].append(d.chunk(1)[0])
        out["p"].append(d.leaves("params"))
        if e == 0:
            out["m1"], out["v1"] = d.leaves("m"), d.leaves("v")
    out["folds"] = list(d.own)
    out["row_folds"] = (list(range(d.num_folds)) if prog.grid is not None
                        and isinstance(d, Lockstep) else list(d.own))
    _sync(prog.device)
    return out


def window(prog: Program, seconds: float, stop=None) -> dict:
    """Chunks until the first boundary at or after `seconds`: a chunk's in
    lockstep, a fold's in a sequential cell, so that every window holds the
    same mix of replays and fold switches (a chunk boundary inside a fold
    would let the share of switch time swing with where `seconds` falls).
    `stop` (on a grid: rank 0's decision, broadcast) says when. Host-clock
    totals and the spans."""
    d = prog.driver
    d.recording = True
    t0 = time.perf_counter()
    while True:
        d.next_chunk()
        done = time.perf_counter() - t0 >= seconds and d.at_boundary()
        if (stop(done) if stop else done):
            break
    _sync(prog.device)
    total = time.perf_counter() - t0
    d.recording = False
    fold_epochs = [s["epochs"] * len(s["folds"]) for s in d.spans]
    return {"seconds": total, "fold_epochs": sum(fold_epochs),
            "graphs": sum(s["graphs"] for s in d.spans),
            "unfinite": sum(n for n, s in zip(fold_epochs, d.spans) if not s["finite"]),
            "spans": d.spans, "switches": d.switches}


def stretch(prog: Program):
    """The traced stretch, after the window: one chunk of the window's
    size; a sequential cell's is a fold switch and the next fold's first
    chunk. Returns the (fold, epochs) it ran."""
    d = prog.driver
    if isinstance(d, Sequential):
        d.switch()
    k = cv.chunk_epochs(d.pcfg, (d.epoch - 1) % d.pcfg.num_epochs + 1)
    d.chunk(k)
    _sync(prog.device)
    return [(f, k) for f in d.own]


def check_folds(prog: Program, n: int) -> list:
    """After the window: in a sequential cell, `n` switches into the next
    folds on the same engine, each fold's epochs 1-3 kept as `set_up`
    keeps fold 1's. Lockstep has no switch: none."""
    d = prog.driver
    if not isinstance(d, Sequential):
        return []
    out = []
    for _ in range(n):
        d.switch()
        out.append(set_up(prog))
    return out
