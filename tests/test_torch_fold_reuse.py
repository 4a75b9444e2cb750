"""One fused runner across folds (dgcnn_tpu_torch/train/cv.py `RunnerSlot.run`,
train/loop.py `FusedRun.adopt`, `copy_fold_state`): on each of the five
single-device sequential engines, on the CPU and on a stand-in card, three
folds through one kept runner give the rows, parameters, Adam state and
dropout generator state of a fresh engine per fold, bit for bit; the runner
is built once while its key holds and once more when a budget (or a step
count) grows; after every chunk the fold's own net, optimizer and generator
hold the runner's values; a new fold on the objects the runner already
trains still takes its test data; a fold resumed from an in-flight bundle
into a kept runner goes on as the uninterrupted fold; the CV driver opens one
`runner.adopt` span a fold switch, and lockstep none."""

import contextlib
import functools

import numpy as np
import pytest
import torch
from test_torch_fused import SMALL
from test_torch_fused_sparse import _stand_in_card

from dgcnn_tpu_torch.batching.dense import order_matrix
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.train import cv, loop
from dgcnn_tpu_torch.train.loop import make_optimizer
from dgcnn_tpu_torch.train.metrics import SPANS
from dgcnn_tpu_torch.utils.checkpoint import adam_state, load_into
import torch_threads  # noqa: F401  (torch on one CPU thread)

BATCH = 8
CHUNKS = (2, 1)  # a fold's chunks of epochs

# engine name → (engine class, config fields, synthetic profile, graphs)
ENGINES = {
    "dense": (cv.DenseEngine, {}, "MUTAG", 36),
    "multi": (cv.MultiDenseEngine, dict(multi_dense_min_tile=32), "COLLAB", 36),
    "block": (cv.BlockSparseEngine, dict(block_impl="pallas"), "DD", 24),
    "device-coo": (cv.DeviceCooEngine, dict(spmm_impl="xla"), "MUTAG", 36),
    "host-coo": (cv.CooEngine, dict(spmm_impl="xla", coo_assembly="host"), "MUTAG", 36),
}


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    SPANS.stop()


@functools.lru_cache(maxsize=None)
def _dataset(name, n):
    return synthesize_tu_dataset(name, num_graphs=n, seed=4)


def _engine(which):
    """A fresh engine whose budgets already cover every batch of the
    dataset, so that its key holds across folds of equal sizes."""
    cls, fields, name, n = ENGINES[which]
    gs = _dataset(name, n)
    cfg = Config(data_type=name, batch_size=BATCH, graph_pad_multiple=4,
                 node_pad_multiple=128, edge_pad_multiple=128, seed=11, **fields)
    engine = cls(cfg, gs, "cpu")
    slots = getattr(engine, "slots", BATCH)

    def largest(sizes):
        return order_matrix(np.argsort(-sizes, kind="stable").astype(np.int32), BATCH,
                            slots)

    if isinstance(engine, cv.BlockSparseEngine):
        engine.budget_for(largest(engine._nb), largest(engine._block_counts))
    elif isinstance(engine, cv.DeviceCooEngine):
        engine.bucket_for(largest(gs.node_counts()), largest(gs.edge_counts()))
    elif isinstance(engine, cv.MultiDenseEngine):
        engine.slot_floor[:] = BATCH  # a class never holds more than a batch
    return gs, engine


def _grow(engine) -> bool:
    """Grow the engine's budget by one step of its grid; False for an
    engine whose key holds no budget (dense, host COO without block-COO
    structures)."""
    if isinstance(engine, cv.BlockSparseEngine):
        engine.floor_nb += 8
    elif isinstance(engine, cv.DeviceCooEngine):
        engine.floor_nodes += engine.cfg.node_pad_multiple
    elif isinstance(engine, cv.MultiDenseEngine):
        engine.slot_floor[0] += 4
    else:
        return False
    return True


def _split(n, f, parts=3):
    """Fold f of `parts`: every `parts`-th graph from f is a test graph."""
    ids = np.arange(n, dtype=np.int32)
    test = ids[f::parts]
    return np.setdiff1d(ids, test), test


def _state(gs, fold):
    """A fold's fresh net, optimizer and dropout generator (dropout on)."""
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                  dropout_rate=0.5, **SMALL)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(fold), model))
    return net, make_optimizer(net), torch.Generator().manual_seed(100 + fold)


def _snapshot(net, opt, gen) -> list:
    """Every tensor of a fold's training state, copied: parameters, Adam's
    step counts and moments, the generator's state."""
    return ([p.detach().clone() for p in net.parameters()]
            + [t.clone() for ts in adam_state(opt).values() for t in ts]
            + [gen.get_state()])


def _assert_same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _run_fold(engine, gs, fold, split=None, chunks=CHUNKS, state=None, after=None,
              start=0):
    """Begin `fold` (ids `split`, by default fold `fold` of three), run its
    chunks from chunk `start` on `state` (by default the fold's fresh one),
    calling `after(state)` after each, then end it. Returns the rows and
    the final state."""
    train, test = split or _split(gs.num_graphs, fold)
    engine.begin_fold(train, test)
    state = state or _state(gs, fold)
    rng = np.random.default_rng(fold)
    rows = []
    for i, k in enumerate(chunks):
        perms = np.stack([rng.permutation(len(train)) for _ in range(k)])
        if i < start:
            continue
        rows.append(engine.run_epochs(*state, perms))
        if after is not None:
            after(state)
    engine.end_fold()
    return np.concatenate(rows), _snapshot(*state)


def _card(monkeypatch) -> list:
    """`_stand_in_card` with the dense factory graphed too, and a graph that
    acts as on the card: the capture runs nothing, each replay runs the
    captured body. Returns the graphs made."""
    made = _stand_in_card(monkeypatch)
    build = cv.make_dense_gather_run

    def dense_on_card(*a, **k):
        runner = build(*a, **k)
        runner.graphs, runner.stream = True, torch.cuda.current_stream()
        return runner

    capturing = [False]

    @contextlib.contextmanager
    def capture(graph, stream=None, capture_error_mode=None):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    warm_up_and_capture = loop.FusedRun._warm_up_and_capture

    def on_card(self):
        body = self.body
        self.body = lambda: None if capturing[0] else body()
        try:
            warm_up_and_capture(self)
        finally:
            self.body = body
        self.graph.graph.on_replay = body

    monkeypatch.setattr(cv, "make_dense_gather_run", dense_on_card)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(loop.FusedRun, "_warm_up_and_capture", on_card)
    return made


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "stand-in-card"])
@pytest.mark.parametrize("which", list(ENGINES))
def test_three_folds_on_one_runner_are_a_runner_a_fold(which, on_card, monkeypatch):
    """Three folds of equal sizes through one engine: one runner, built at
    the first fold and kept for the other two (on the stand-in card
    captured once and replayed from the kept folds' first epochs), and
    every fold's rows and final state bitwise a fresh engine's."""
    made = _card(monkeypatch) if on_card else []
    gs, kept = _engine(which)
    got = [_run_fold(kept, gs, f) for f in range(3)]
    assert (kept.runners.builds, kept.runners.reuses) == (1, 2)
    if on_card:
        assert len(made) == 1 and made[0].replays == 3 * sum(CHUNKS) - 1
    for f in range(3):
        rows, state = _run_fold(_engine(which)[1], gs, f)
        np.testing.assert_array_equal(got[f][0], rows)
        _assert_same(got[f][1], state)
    if on_card:
        assert len(made) == 4


@pytest.mark.parametrize("which", list(ENGINES))
def test_a_grown_budget_builds_once_more(which):
    """A fold at a grown budget (or, on an engine whose key holds none, at
    another train step count) builds one new runner, its `runner.adopt`
    span `kept` false; the next fold at that key keeps it. The rows stay
    bitwise a fresh engine's at the same budgets."""
    gs, kept = _engine(which)
    n = gs.num_graphs
    grows = _grow(_engine(which)[1])  # whether the engine has a budget
    splits = [_split(n, 0)] + ([_split(n, f) for f in (1, 2)] if grows
                               else [_split(n, f, parts=4) for f in (1, 2)])
    SPANS.start()
    got = []
    for f, split in enumerate(splits):
        if f == 1:
            _grow(kept)
        got.append(_run_fold(kept, gs, f, split))
    adopts = [r["attrs"]["kept"] for r in SPANS.stop() if r["name"] == "runner.adopt"]
    assert adopts == [False, True]
    assert (kept.runners.builds, kept.runners.reuses) == (2, 1)
    for f, split in enumerate(splits):
        fresh = _engine(which)[1]
        if f:
            _grow(fresh)
        rows, state = _run_fold(fresh, gs, f, split)
        np.testing.assert_array_equal(got[f][0], rows)
        _assert_same(got[f][1], state)


@pytest.mark.parametrize("which", list(ENGINES))
def test_the_fold_holds_the_runners_state_after_every_chunk(which):
    """After every chunk of a fold on a kept runner, the fold's own net,
    optimizer and generator hold the values of those the runner trains."""
    gs, engine = _engine(which)
    seen = []

    def check(state):
        runner = engine.runners.runner
        seen.append(runner.state[0] is state[0])
        _assert_same(_snapshot(*state), _snapshot(*runner.state))

    for f in range(3):
        _run_fold(engine, gs, f, after=check)
    assert seen == [True] * len(CHUNKS) + [False] * 2 * len(CHUNKS)


@pytest.mark.parametrize("which", list(ENGINES))
def test_a_new_fold_on_the_objects_the_runner_trains_takes_its_test_data(which):
    """A fold begun on the very net, optimizer and generator the kept
    runner trains (a caller that goes on training one model) still loads
    the new fold's test data: its rows are those of a runner built for
    the new fold on the same state."""
    got = []
    for keep in (True, False):
        gs, engine = _engine(which)
        state = _state(gs, 0)
        _run_fold(engine, gs, 0, state=state)
        if not keep:
            engine.runners.drop()
        got.append(_run_fold(engine, gs, 1, state=state)[0])
    np.testing.assert_array_equal(*got)


@pytest.mark.parametrize("which", list(ENGINES))
def test_a_resumed_fold_on_a_kept_runner_stays_bitwise(which):
    """Fold 1's in-flight state after its first chunk, loaded into fresh
    objects as `run_fold` loads a bundle (`load_into`), then its last chunk
    on an engine that kept fold 0's runner: the uninterrupted fold's rows
    and final state."""
    gs, engine = _engine(which)
    _run_fold(engine, gs, 0)
    bundle = {}

    def save(state):
        if not bundle:
            net, opt, gen = state
            bundle.update(params={k: v.clone() for k, v in net.state_dict().items()},
                          opt={k: [t.clone() for t in ts]
                               for k, ts in adam_state(opt).items()},
                          rng=gen.get_state().numpy())

    rows, want = _run_fold(engine, gs, 1, after=save)
    gs, resumed = _engine(which)
    _run_fold(resumed, gs, 0)
    net, opt, gen = _state(gs, 1)
    load_into(net, bundle["params"])
    load_into(opt, bundle["opt"])
    load_into(gen, bundle["rng"])
    tail, got = _run_fold(resumed, gs, 1, state=(net, opt, gen), start=1)
    assert resumed.runners.reuses == 1
    np.testing.assert_array_equal(tail, rows[CHUNKS[0]:])
    _assert_same(got, want)


@pytest.mark.parametrize("cv_parallel", ["sequential", "folds"])
def test_the_driver_adopts_once_a_switch_and_lockstep_never(cv_parallel, tmp_path):
    """`run_cross_validation` with the recorder on: sequentially one
    `runner.build` a run and one kept `runner.adopt` a fold switch; in
    lockstep one build and no `runner.adopt`."""
    gs = _dataset("MUTAG", 30)
    cfg = Config(data_type="MUTAG", batch_size=BATCH, num_epochs=3, max_fused_epochs=2,
                 seed=11, num_folds=3, layout="dense", graph_pad_multiple=4,
                 cv_parallel=cv_parallel, statistics_dir=str(tmp_path / "s"),
                 epochs_dir=str(tmp_path / "e"), **SMALL)
    SPANS.start()
    cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    names = [(r["name"], r["attrs"].get("kept")) for r in SPANS.stop()
             if r["name"] in ("runner.build", "runner.adopt")]
    if cv_parallel == "folds":
        assert names == [("runner.build", None)]
    else:
        assert names == [("runner.build", None)] + [("runner.adopt", True)] * 2
