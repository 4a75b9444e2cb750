"""The multi-tile dense engine (dgcnn_tpu_torch/train/cv.py
`MultiDenseEngine`) and its fused runner (train/loop.py
`make_multi_dense_run`) against the reference's (dgcnn_tpu/train/cv.py:583,
train/loop.py:201): the slot floors, the rows against JAX's fused runner,
chunked epochs bitwise equal to single eager epochs, one runner per slot
tuple on a stand-in card, no host sync in the body, `layout="auto"`
resolving synthetic COLLAB to the engine, through the CLI too, and
`cv_parallel="folds"` training its folds in lockstep."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_fused import SMALL, _NoHostSync
from test_torch_fused_sparse import _stand_in_card

from dgcnn_tpu.batching import multi_dense as jmd
from dgcnn_tpu.config import Config as JConfig
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train import loop as jloop
from dgcnn_tpu.train.cv import MultiDenseEngine as JMultiDenseEngine
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.batching.dense import gather_dense_batch
from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import epoch_rows, make_optimizer
import torch_threads  # noqa: F401  (torch on one CPU thread)

BATCH = 8
# synthetic COLLAB of 40 graphs at min tile 32: classes (32, 64, 128, 208)
# of 3, 13, 20 and 4 graphs, the smallest empty in most batches
FIELDS = dict(data_type="COLLAB", batch_size=BATCH, multi_dense_min_tile=32, seed=11)


@functools.lru_cache(maxsize=None)
def _collab(n=40, seed=3):
    return synthesize_tu_dataset("COLLAB", num_graphs=n, seed=seed)


@functools.lru_cache(maxsize=None)
def _engine_data():
    """The engine's device build, made once a module: each test's engine
    shares its classes and routing (read only)."""
    e = cv.MultiDenseEngine(Config(**FIELDS), _collab(), "cpu")
    return e.classes, e.routing


def _engine():
    """A fresh engine (its own floors, fold count and runner) over the
    shared device build."""
    build = cv.build_multi_dense_on_device
    classes, routing = _engine_data()
    cv.build_multi_dense_on_device = lambda *a: (classes, routing)
    try:
        return cv.MultiDenseEngine(Config(**FIELDS), _collab(), "cpu")
    finally:
        cv.build_multi_dense_on_device = build


def _fold(n=40, seed=0):
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    return np.sort(perm[:30]), np.sort(perm[30:])


def _state(gs, dropout=0.5):
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                  dropout_rate=dropout, **SMALL)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model))
    return net, make_optimizer(net), torch.Generator().manual_seed(41)


def _opt_state(net, opt):
    return [*net.parameters(), *(opt.state[p][k] for p in net.parameters()
                                 for k in ("step", "exp_avg", "exp_avg_sq"))]


def _record_keys(engine):
    """The runner key (fold, slots) of each epoch, in order."""
    seen = []
    get = engine.runners.get

    class Proxy:
        def __init__(self, runner, key):
            self.runner, self.key = runner, key

        def run_epochs(self, orders):
            seen.extend([self.key] * len(orders))
            return self.runner.run_epochs(orders)

    engine.runners.get = lambda key, make: Proxy(get(key, make), key)
    return seen


def test_slot_floors_are_the_references_after_init_and_two_chunks():
    """The floors after init (4 a class, pre-grown over 40 shuffles from
    `SeedSequence([seed, 0])`, capped at the batch size rounded up to 4)
    and after each of two chunks (grown only, over the chunk's epochs and
    the fold's test ids, rounded up to 4) equal the reference engine's
    `_slot_floor` fed the same ids."""
    gs = _collab()
    jcfg = JConfig(**FIELDS)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    jeng = JMultiDenseEngine(jcfg, jax_synth("COLLAB", num_graphs=40, seed=3), jm,
                             optax.adam(1e-3))
    engine = _engine()
    assert engine.tiles == jeng._routing.tiles == (32, 64, 128, 208)
    np.testing.assert_array_equal(engine.slot_floor, jeng._slot_floor)
    train, test = _fold()
    engine.begin_fold(train, test)
    rng = np.random.default_rng(5)
    by_class = np.argsort(-engine.routing.class_of[train], kind="stable")
    for chunk in ([rng.permutation(30) for _ in range(2)], [by_class]):
        ids = [train[p] for p in chunk]
        got = engine.slots_for(*ids, test)
        want = jeng._slots_for(*ids, test.astype(np.int64))
        assert got == want
        np.testing.assert_array_equal(engine.slot_floor, jeng._slot_floor)
    assert all(s % 4 == 0 and 4 <= s <= 8 for s in got)


def test_engine_rows_match_jax_make_multi_dense_run():
    """`run_epochs` over 2 permutations against the reference's fused
    runner given the same per-class orders and test orders, the same
    weights, dropout 0: rows within rtol 1e-5."""
    gs = _collab()
    engine = _engine()
    train, test = _fold()
    engine.begin_fold(train, test)
    perms = np.stack([np.random.default_rng(e).permutation(30) for e in range(2)])
    slots = engine.slots_for(*(train[p] for p in perms), test)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0, **SMALL)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0, **SMALL)
    jp = jax_init(jax.random.PRNGKey(7), jm)
    net = DGCNNNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))))
    rows = engine.run_epochs(net, make_optimizer(net), torch.Generator().manual_seed(0),
                             perms)
    engine.end_fold()
    bounds = np.cumsum((0,) + slots)

    def per_class(order):
        return tuple(jnp.asarray(order[..., a:b]) for a, b in zip(bounds[:-1], bounds[1:]))

    orders = np.stack([engine.epoch_order(train[p], slots) for p in perms])
    jdata = tuple(jax.tree_util.tree_map(jnp.asarray, c)
                  for c in jmd.build_multi_dense(jax_synth("COLLAB", num_graphs=40, seed=3),
                                                 engine.tiles)[0])
    opt = optax.adam(1e-3)
    jrows = jloop.make_multi_dense_run(jm, opt)(
        jp, opt.init(jp), jax.random.PRNGKey(0), jdata, per_class(orders),
        per_class(engine.epoch_order(test, slots)))[3]
    assert rows.shape == (2, 4)
    np.testing.assert_allclose(rows, np.asarray(jrows, np.float64), rtol=1e-5)


def _one_eager_epoch(engine, net, opt, gen, perm, slots):
    """One `epoch_rows` of `perm` at the slot tuple `slots`, each batch
    split by class as the engine's runner splits it."""
    bounds = np.cumsum((0,) + slots)

    def batch_fn(row):
        return MultiDenseBatch(tuple(gather_dense_batch(d, row[a:b]) for d, a, b in
                                     zip(engine.classes, bounds[:-1], bounds[1:])))

    order = torch.from_numpy(engine.epoch_order(engine._train_idx[perm], slots))
    test = torch.from_numpy(engine.epoch_order(engine._test_idx, slots))
    return epoch_rows(net, opt, batch_fn, order, test, gen)


def test_chunked_epochs_are_single_eager_epochs_bits():
    """3 epochs in chunks of `max_fused_epochs` 2 (a chunk of 2, then 1)
    through the engine against a loop of single eager epochs
    (`epoch_rows`) at the slot tuples the engine's runners took, from the
    same state, dropout on: rows, parameters and the optimizer's moments
    and step counts bitwise equal."""
    gs = _collab()
    engine = _engine()
    train, test = _fold()
    engine.begin_fold(train, test)
    keys = _record_keys(engine)
    rng = np.random.default_rng(2)
    perms = [rng.permutation(30) for _ in range(3)]
    (net_a, opt_a, gen_a), (net_b, opt_b, gen_b) = _state(gs), _state(gs)
    got = np.concatenate([engine.run_epochs(net_b, opt_b, gen_b, np.stack(perms[:2])),
                          engine.run_epochs(net_b, opt_b, gen_b, np.stack(perms[2:]))])
    assert len(keys) == 3
    want = np.stack([_one_eager_epoch(engine, net_a, opt_a, gen_a, p, key[1])
                     .double().numpy() for p, key in zip(perms, keys)])
    engine.end_fold()
    assert got.shape == (3, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for a, b in zip(_opt_state(net_a, opt_a), _opt_state(net_b, opt_b)):
        assert torch.equal(a, b)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


def test_a_grown_slot_tuple_gets_a_new_runner(monkeypatch):
    """On a stand-in card, from floors of 4: two chunks whose batches hold
    at most 4 graphs of a class c share a runner (one capture, then
    replays); a chunk whose first batch holds 8 of class c grows its slots
    to 8, drops the old runner and captures once more; `end_fold` keeps
    the grown runner, and the next fold at its key replays it from its
    first epoch, with no capture."""
    from dgcnn_tpu_torch.batching.multi_dense import class_batch_counts

    made = _stand_in_card(monkeypatch)
    gs = _collab()
    engine = _engine()
    engine.slot_floor[:] = 4
    train, test = _fold()
    engine.begin_fold(train, test)
    net, opt, gen = _state(gs)
    cls = engine.routing.class_of[train]
    test_max = class_batch_counts(engine.routing, test, BATCH).max(axis=0)
    c = next(c for c in range(len(engine.tiles))
             if (cls == c).sum() >= BATCH and test_max[c] <= 4)
    members, others = list(np.flatnonzero(cls == c)), list(np.flatnonzero(cls != c))
    batches = [[] for _ in range(-(-len(train) // BATCH))]
    for i, g in enumerate(members):  # round robin: at most 4 of class c a batch
        batches[i % len(batches)].append(g)
    for b in batches:
        while len(b) < BATCH and others:
            b.append(others.pop())
    spread = np.concatenate(batches)
    engine.run_epochs(net, opt, gen, np.stack([spread, spread]))
    first, key = engine.runners.runner, engine.runners.key
    assert key[1][c] == 4
    assert len(made) == 1 and made[0].replays == 1
    engine.run_epochs(net, opt, gen, np.stack([spread]))
    assert engine.runners.runner is first and len(made) == 1 and made[0].replays == 2
    crowded = np.argsort(cls != c, kind="stable")  # 8 of class c in batch 1
    engine.run_epochs(net, opt, gen, np.stack([crowded]))
    assert engine.runners.key != key and engine.runners.runner is not first
    assert engine.runners.key[1][c] == 8
    assert len(made) == 2 and made[1].replays == 0
    grown, key = engine.runners.runner, engine.runners.key
    assert grown.capture_seconds is not None
    engine.end_fold()
    assert engine.runners.runner is grown and engine.runners.key == key
    engine.begin_fold(train, test)
    engine.run_epochs(*_state(gs), np.stack([crowded]))
    assert engine.runners.runner is grown and len(made) == 2 and made[1].replays == 1
    assert (engine.runners.builds, engine.runners.reuses) == (2, 1)


def test_multi_epoch_body_makes_no_host_sync():
    """Two epochs of the multi-tile body under the dispatch mode that
    raises on any host read-back (the CPU Adam's step count excused, as
    for the other bodies: on the card it stays on the device)."""
    gs = _collab()
    engine = _engine()
    train, test = _fold()
    engine.begin_fold(train, test)
    net, opt, gen = _state(gs)
    perms = np.stack([np.random.default_rng(e).permutation(30) for e in range(2)])
    engine.run_epochs(net, opt, gen, perms[:1])  # builds the runner, Adam's state
    runner, slots = engine.runners.runner, engine.runners.key[1]

    def adam_step(t):
        return any(t.data_ptr() == st["step"].data_ptr() for st in opt.state.values())

    guard = _NoHostSync(allow=adam_step)
    for perm in perms:
        runner.order.copy_(torch.from_numpy(engine.epoch_order(train[perm], slots)))
        with guard:
            runner.body()
    assert torch.isfinite(runner.rows).all() and guard.excused > 0


def _cv_cfg(tmp_path, **kw):
    base = dict(FIELDS, num_folds=2, num_epochs=2, max_fused_epochs=2,
                lockstep_max_step_bytes=1 << 20, data_root=str(tmp_path / "data"),
                statistics_dir=str(tmp_path / "statistics"),
                epochs_dir=str(tmp_path / "epochs"), **SMALL)
    return Config(**{**base, **kw})


def test_auto_resolves_collab_to_multi_and_trains(tmp_path):
    """`layout="auto"` on synthetic COLLAB whose lockstep step is over its
    byte budget: `choose_layout` says multi, the folds run one after
    another through `MultiDenseEngine` on the CPU, and the run writes the
    reference's artifacts; `run_start` names the layout, the tiles and the
    slot floors."""
    import json

    gs = _collab()
    cfg = _cv_cfg(tmp_path)
    assert cv.choose_layout(cfg, gs) == "multi"
    res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    assert len(res["test_accuracies"]) == 2
    events = [json.loads(ln) for ln in (tmp_path / "statistics" /
                                        "COLLAB_events.jsonl").read_text().splitlines()]
    start = events[0]
    assert start["kind"] == "run_start" and start["layout"] == "multi"
    assert start["tiles"] == [32, 64, 128, 208]
    assert start["slot_floors"] == _engine().slot_floor.tolist()
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [(e["fold"], e["epoch"], e["chunk_epochs"]) for e in epochs] == [
        (1, 1, 2), (1, 2, 2), (2, 1, 2), (2, 2, 2)]
    assert all(np.isfinite(e["train_loss"]) for e in epochs)
    for fold in (1, 2):
        assert (tmp_path / "epochs" / f"COLLAB_{fold}.npz").exists()


def test_cli_collab_reaches_the_multi_engine(tmp_path, monkeypatch):
    """`python -m dgcnn_tpu_torch.cli --data_type COLLAB --synthetic` (on the
    CPU here) resolves the full synthetic COLLAB to multi, with the tile
    ladder (256, 464), and builds `MultiDenseEngine` (stubbed: the dense
    build is 1.34 GB)."""
    reached = {}

    class Stop(Exception):
        pass

    def stub(cfg, dataset, device, graphs=True):
        reached["tiles"] = cv.plan_tiles(dataset.node_counts(), cfg.multi_dense_min_tile)
        reached["bytes"] = cv.multi_dense_bytes(dataset, reached["tiles"])
        raise Stop

    monkeypatch.setattr(cv, "MultiDenseEngine", stub)
    with pytest.raises(Stop):
        cli.main(["--data_type", "COLLAB", "--synthetic", "--platform", "cpu",
                  "--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path)])
    assert reached == {"tiles": (256, 464), "bytes": 1_338_380_416}


def test_multi_folds_trains_in_lockstep(tmp_path):
    """`cv_parallel="folds"` on the multi-tile layout trains both folds in
    lockstep through the engine's classes: `run_start` names the layout,
    tiles and slot floors, and every epoch event carries
    `folds_in_lockstep`."""
    import json

    res = cv.run_cross_validation(_cv_cfg(tmp_path, layout="multi", cv_parallel="folds"),
                                  dataset=_collab(), device="cpu")
    assert len(res["test_accuracies"]) == 2
    events = [json.loads(ln) for ln in (tmp_path / "statistics" /
                                        "COLLAB_events.jsonl").read_text().splitlines()]
    assert events[0]["layout"] == "multi" and events[0]["tiles"] == [32, 64, 128, 208]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [(e["epoch"], e["fold"]) for e in epochs] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    assert all(e["folds_in_lockstep"] == 2 and e["chunk_epochs"] == 2 for e in epochs)
