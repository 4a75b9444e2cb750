"""The fused epoch runner on the block-sparse and COO layouts
(dgcnn_tpu_torch/train/loop.py `make_block_run`, `make_device_coo_run`,
`make_coo_run`) and the engines that drive it (train/cv.py
`BlockSparseEngine`, `DeviceCooEngine`, `CooEngine`): chunked epochs
bitwise equal to a loop of single eager epochs at the same budgets, each
engine against JAX's fused runner, the budgets against the reference's
rule, one runner per budget on a stand-in card, and no host sync inside
an epoch body or in the per-batch plans and slot orders it builds."""

import contextlib
import dataclasses
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_fused import SMALL, _FakeGraph, _NoHostSync

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.batching import device_coo as jdc
from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.batching.dense import order_matrix as jax_order_matrix
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train import loop as jloop
from dgcnn_tpu.train.cv import DeviceCooEngine as JDeviceCooEngine
from dgcnn_tpu_torch.batching.block_sparse import gather_block_batch
from dgcnn_tpu_torch.batching.dense import order_matrix
from dgcnn_tpu_torch.batching.device_coo import gather_coo_batch
from dgcnn_tpu_torch.batching.packer import batch_step, batch_to_device, pad_blockcoo
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import block_csr, block_resident
from dgcnn_tpu_torch.kernels.spmm_block_coo import block_coo_order
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.ops.spmm import edge_order
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import epoch_rows, make_optimizer
import torch_threads  # noqa: F401  (torch on one CPU thread)

BATCH = 8
EPOCHS = 5

# engine name → (engine class, config fields, synthetic profile, graphs)
ENGINES = {
    "block-pallas": (cv.BlockSparseEngine, dict(block_impl="pallas"), "DD", 24),
    "block-xla": (cv.BlockSparseEngine, dict(block_impl="xla"), "DD", 24),
    "device-coo": (cv.DeviceCooEngine, dict(spmm_impl="xla"), "MUTAG", 40),
    "host-coo-xla": (cv.CooEngine, dict(spmm_impl="xla", coo_assembly="host"),
                     "MUTAG", 40),
    "host-coo-pallas": (cv.CooEngine, dict(spmm_impl="pallas"), "DD", 24),
}


def _config(name, **kw):
    return Config(data_type=name, batch_size=BATCH, graph_pad_multiple=4,
                  node_pad_multiple=128, edge_pad_multiple=128, **kw)


@functools.lru_cache(maxsize=None)
def _dataset(name, n):
    return synthesize_tu_dataset(name, num_graphs=n, seed=4)


def _engine(which, **kw):
    cls, fields, name, n = ENGINES[which]
    gs = _dataset(name, n)
    return gs, cls(_config(name, **fields, **kw), gs, "cpu")


def _fold(n, seed=0):
    """A train/test split of n graphs: three quarters train."""
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    cut = 3 * n // 4
    return np.sort(perm[:cut]), np.sort(perm[cut:])


def _state(gs, dropout=0.5):
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                  dropout_rate=dropout, **SMALL)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model))
    return net, make_optimizer(net), torch.Generator().manual_seed(41)


def _record_budgets(engine):
    """The key (fold, budget) of the runner each epoch ran through, in
    order: a proxy between the engine and its runners."""
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


def _one_eager_epoch(engine, net, opt, gen, perm, key):
    """One `epoch_rows` of `perm` at the budget `key` (the runner's key),
    each batch assembled as the engine's runner assembles it."""
    if isinstance(engine, cv.CooEngine):
        epoch = engine.pack_host(engine._train_set, perm)
        if engine.spmm_impl == "pallas":
            epoch = pad_blockcoo(epoch, key[1])
        train = batch_to_device(epoch, "cpu")
        steps = [(train, s) for s in range(train.y.shape[0])]
        test = [(engine._test, s) for s in range(engine._test.y.shape[0])]
        return epoch_rows(net, opt, lambda st: batch_step(*st), steps, test, gen,
                          spmm_impl=engine.spmm_impl)
    order = torch.from_numpy(order_matrix(engine._train_idx[perm], BATCH, engine.slots))
    test = torch.from_numpy(engine._test_np)
    if isinstance(engine, cv.BlockSparseEngine):
        _, nb, w = key
        return epoch_rows(net, opt, lambda r: gather_block_batch(engine.dev, r, nb, w),
                          order, test, gen, pool=engine.dev.pool,
                          block_impl=engine.block_impl)
    bucket = key[1]
    return epoch_rows(net, opt, lambda r: gather_coo_batch(engine.dev, r, bucket),
                      order, test, gen, spmm_impl=engine.spmm_impl)


def _opt_state(net, opt):
    return [*net.parameters(), *(opt.state[p][k] for p in net.parameters()
                                 for k in ("step", "exp_avg", "exp_avg_sq"))]


# -- chunked epochs against the per-epoch loop -------------------------------


@pytest.fixture(scope="module")
def eager_epochs():
    """The single eager epochs' rows and final state, by engine and the
    budgets its runners took: the `max_fused` cases of an engine whose
    runners took the same budgets share one eager loop."""
    return {}


@pytest.mark.parametrize("max_fused", [1, 2, 5])
@pytest.mark.parametrize("which", list(ENGINES))
def test_chunked_epochs_are_single_eager_epochs_bits(which, max_fused, eager_epochs):
    """5 epochs in chunks of `max_fused` through the engine against a loop
    of single eager epochs (`epoch_rows`) at the budgets the engine's
    runners took, from the same state, dropout on: rows, parameters and
    the optimizer's moments and step counts bitwise equal. The host-packed
    engine runs sub-chunks of 2 epochs (`coo_fuse_bytes` of two epochs)."""
    gs, engine = _engine(which)
    train, test = _fold(gs.num_graphs)
    if isinstance(engine, cv.CooEngine):
        engine = type(engine)(dataclasses.replace(
            engine.cfg, coo_fuse_bytes=2 * engine.epoch_bytes(len(train))), gs, "cpu")
    engine.begin_fold(train, test)
    budgets = _record_budgets(engine)
    rng = np.random.default_rng(2)
    perms = [rng.permutation(len(train)) for _ in range(EPOCHS)]
    net_b, opt_b, gen_b = _state(gs)
    got, e = [], 0
    while e < EPOCHS:
        k = min(max_fused, EPOCHS - e)
        got.append(engine.run_epochs(net_b, opt_b, gen_b, np.stack(perms[e:e + k])))
        e += k
    got = np.concatenate(got)
    assert len(budgets) == EPOCHS
    key = (which, repr(budgets))
    if key not in eager_epochs:
        net_a, opt_a, gen_a = _state(gs)
        want = np.stack([_one_eager_epoch(engine, net_a, opt_a, gen_a, p, k)
                         .double().numpy() for p, k in zip(perms, budgets)])
        eager_epochs[key] = (want, [t.clone() for t in _opt_state(net_a, opt_a)],
                             gen_a.get_state())
    want, state_a, gen_state_a = eager_epochs[key]
    engine.end_fold()
    assert got.shape == (EPOCHS, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for a, b in zip(state_a, _opt_state(net_b, opt_b)):
        assert torch.equal(a, b)
    assert torch.equal(gen_state_a, gen_b.get_state())


# -- against JAX's fused runners ---------------------------------------------


def _jax_pair(gs_name, n, which):
    """The same synthetic set in both packages, models at SMALL widths with
    dropout 0 and the same weights; the port's engine on the CPU."""
    jgs = jax_synth(gs_name, num_graphs=n, seed=4)
    gs, engine = _engine(which)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0, **SMALL)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0, **SMALL)
    jp = jax_init(jax.random.PRNGKey(7), jm)
    net = DGCNNNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))))
    return jgs, gs, engine, jm, jp, net


@pytest.mark.parametrize("which", ["block-xla", "device-coo", "host-coo-xla"])
def test_engine_run_epochs_matches_jax_fused_runner(which):
    """`run_epochs` over 3 permutations against the reference's fused runner
    for the layout (`make_block_run` with block_impl xla,
    `make_device_coo_run`, `make_coo_run`), given the same orders or
    packed epochs, the same weights, dropout 0: rows within rtol 1e-5."""
    _, _, name, n = ENGINES[which]
    jgs, gs, engine, jm, jp, net = _jax_pair(name, n, which)
    train, test = _fold(n)
    engine.begin_fold(train, test)
    budgets = _record_budgets(engine)
    perms = np.stack([np.random.default_rng(e).permutation(len(train)) for e in range(3)])
    rows = engine.run_epochs(net, make_optimizer(net), torch.Generator().manual_seed(0),
                             perms)
    engine.end_fold()
    opt = optax.adam(1e-3)
    args = (jp, opt.init(jp), jax.random.PRNGKey(0))
    slots = engine.slots if not isinstance(engine, cv.CooEngine) else None
    if isinstance(engine, cv.CooEngine):
        bucket = jpk.BucketSpec(**dataclasses.asdict(engine.bucket))
        tr_set, te_set = jgs.subset(train), jgs.subset(test)
        epochs = [jpk.pack_epoch(tr_set, p, BATCH, bucket, backend="numpy") for p in perms]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *epochs)
        test_b = jax.tree_util.tree_map(jnp.asarray, jpk.pack_epoch(
            te_set, np.arange(len(test)), BATCH, bucket, backend="numpy"))
        jrows = jloop.make_coo_run(jm, opt, "xla")(*args, stacked, test_b)[3]
    else:
        order3d = np.stack([jax_order_matrix(train[p], BATCH, slots) for p in perms])
        test2d = jnp.asarray(jax_order_matrix(test, BATCH, slots))
        if isinstance(engine, cv.BlockSparseEngine):
            _, nb, w = budgets[0]
            jdev = jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(jgs))
            run = jloop.make_block_run(jm, opt, nb, w, block_impl="xla")
        else:
            b = budgets[0][1]
            jdev = jax.tree_util.tree_map(jnp.asarray, jdc.build_device_graphset(jgs))
            run = jloop.make_device_coo_run(
                jm, opt, jpk.BucketSpec(b.num_nodes, b.num_edges, b.num_graphs), "xla")
        jrows = run(*args, jdev, jnp.asarray(order3d), test2d)[3]
    assert rows.shape == (3, 4)
    np.testing.assert_allclose(rows, np.asarray(jrows, np.float64), rtol=1e-5)


# -- budgets ------------------------------------------------------------------


def _by_size(engine, train, largest_first=True):
    """A permutation of the fold's training graphs by size: largest first
    puts the biggest batch the fold can make first."""
    sizes = _sizes(engine)[train]
    return np.argsort(-sizes if largest_first else sizes, kind="stable")


def _grid(which, axis):
    """The grid multiple of each budget axis: (8, 64) for the block engine's
    (block-rows, items), the pad multiples for the COO bucket."""
    return (8, 64)[axis] if which.startswith("block") else 128


def _sizes(engine):
    """Each graph's size as the engine's budget sees it: stored blocks
    (block engine) or edges (COO engines)."""
    if isinstance(engine, cv.BlockSparseEngine):
        return engine._block_counts[:-1]
    return engine.dataset.edge_counts() if isinstance(engine, cv.CooEngine) \
        else engine._edge_counts


def _small_test_fold(engine):
    """A fold whose test quarter holds the smallest graphs, so that the
    training batches set the budgets."""
    by_size = np.argsort(_sizes(engine), kind="stable").astype(np.int32)
    cut = len(by_size) // 4
    return np.sort(by_size[cut:]), np.sort(by_size[:cut])


@pytest.mark.parametrize("which", ["block-xla", "device-coo"])
def test_chunk_budget_is_the_reference_rule_grow_only(which):
    """Over 2 folds of 3 chunks, each chunk's budget is the reference's
    rule over the chunk's orders and the fold's test order
    (`block_batch_extents` / `batch_extents`, `_geom_round`, the floors),
    grown only across chunks and folds, and every epoch of a chunk runs at
    its chunk's budget; in fold 1 the third chunk, the only one with the
    largest graphs in one batch, grows a budget."""
    gs, engine = _engine(which)
    budgets = _record_budgets(engine)
    net, opt, gen = _state(gs)
    floor = (8, 64) if which.startswith("block") else (128, 128)
    want, per_chunk = [], []
    for fold in (0, 1):
        train, test = _small_test_fold(engine) if fold == 0 else _fold(gs.num_graphs, 1)
        engine.begin_fold(train, test)
        rng = np.random.default_rng(fold)
        asc, desc = _by_size(engine, train, False), _by_size(engine, train)
        chunks = ([np.stack([asc, asc]), np.stack([asc]), np.stack([desc, asc])]
                  if fold == 0 else
                  [np.stack([rng.permutation(len(train)) for _ in range(k)])
                   for k in (2, 1, 2)])
        test2d = jax_order_matrix(test, BATCH, engine.slots)
        for perms in chunks:
            order3d = np.stack([jax_order_matrix(train[p], BATCH, engine.slots)
                                for p in perms])
            if which.startswith("block"):
                ext = [jbs.block_batch_extents(np.asarray(engine._nb),
                                               np.asarray(engine._block_counts), m)
                       for m in (order3d, test2d)]
            else:
                ext = [jdc.batch_extents(engine._node_counts, engine._edge_counts, m)
                       for m in (order3d, test2d)]
            need = [max(e[i] for e in ext) for i in (0, 1)]
            floor = tuple(max(floor[i], JDeviceCooEngine._geom_round(need[i], _grid(which, i)))
                          for i in (0, 1))
            want.append(floor)
            engine.run_epochs(net, opt, gen, perms)
            per_chunk.append(budgets[-1])
            assert budgets[-len(perms):] == [budgets[-1]] * len(perms)
        engine.end_fold()
    got = [key[1:] if which.startswith("block") else
           (key[1].num_nodes, key[1].num_edges) for key in per_chunk]
    assert got == want
    assert got[2] > got[1] and got[1] == got[0]
    assert all(b >= a for a, b in zip(got, got[1:]))


def test_host_coo_item_budget_is_grow_only_and_padding_changes_nothing():
    """`CooEngine` under pallas: the sub-chunk's item budget W is
    `_geom_round` of its largest batch's items, grown only; an epoch
    padded to a larger W gives the same rows, bitwise, as the epoch padded
    to its own largest batch (`pack_host`)."""
    gs, engine = _engine("host-coo-pallas")
    train, test = _small_test_fold(engine)
    engine.begin_fold(train, test)
    small = engine.pack_host(engine._train_set, _by_size(engine, train, False))
    big = engine.pack_host(engine._train_set, _by_size(engine, train))
    w_small = small.blockcoo[0].ls.shape[1]
    w_big = big.blockcoo[0].ls.shape[1]
    assert w_big > w_small
    assert engine.items_for([small]) == cv._geom_round(w_small, 64)
    assert engine.items_for([small, big]) == cv._geom_round(w_big, 64)
    assert engine.items_for([small]) == cv._geom_round(w_big, 64)  # never shrinks
    perm = _by_size(engine, train, False)
    rows = []
    for w in (0, cv._geom_round(w_big, 64) + 64):
        net, opt, gen = _state(gs)
        epoch = engine.pack_host(engine._train_set, perm)
        if w:
            epoch = pad_blockcoo(epoch, w)
            assert epoch.blockcoo[0].ls.shape[1] == w
        train_b = batch_to_device(epoch, "cpu")
        rows.append(epoch_rows(
            net, opt, lambda st: batch_step(*st),
            [(train_b, s) for s in range(train_b.y.shape[0])],
            [(engine._test, s) for s in range(engine._test.y.shape[0])], gen,
            spmm_impl="pallas"))
    assert torch.equal(rows[0], rows[1])


def test_host_coo_sub_chunks_follow_the_transfer_budget():
    """`fuse_epochs` is the reference's clip(coo_fuse_bytes // epoch bytes,
    1, 64), and a chunk of 5 epochs at 2 a sub-chunk runs 3 sub-chunks,
    each one host round trip."""
    gs, engine = _engine("host-coo-xla")
    train, test = _fold(gs.num_graphs)
    one = engine.epoch_bytes(len(train))
    for fuse, r in ((1, 1), (2 * one + 1, 2), (10 ** 12, 64)):
        eng = cv.CooEngine(dataclasses.replace(engine.cfg, coo_fuse_bytes=fuse), gs, "cpu")
        eng.begin_fold(train, test)
        assert eng.fuse_epochs == r
    eng = cv.CooEngine(dataclasses.replace(engine.cfg, coo_fuse_bytes=2 * one), gs, "cpu")
    eng.begin_fold(train, test)
    calls = []
    get = eng.runners.get
    eng.runners.get = lambda key, make: calls.append(key) or get(key, make)
    net, opt, gen = _state(gs)
    rows = eng.run_epochs(net, opt, gen, np.stack([np.random.default_rng(e).permutation(
        len(train)) for e in range(5)]))
    assert rows.shape == (5, 4) and len(calls) == 3


# -- one runner per budget on a stand-in card -----------------------------------


def _stand_in_card(monkeypatch):
    """torch.cuda's graph, capture and streams replaced by stand-ins, and
    each runner the engines build made to act as on the card; a graph's
    replay runs the runner's body. Returns the list of graphs made."""
    made = []

    class Stream:
        def wait_stream(self, other):
            pass

    def new_graph():
        made.append(_FakeGraph())
        return made[-1]

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    for name in ("make_block_run", "make_device_coo_run", "make_coo_run",
                 "make_multi_dense_run"):
        build = getattr(cv, name)

        def on_card(*a, _build=build, **k):
            runner = _build(*a, **k)
            runner.graphs, runner.stream = True, Stream()
            return runner

        monkeypatch.setattr(cv, name, on_card)
    return made


@pytest.mark.parametrize("which", ["block-pallas", "device-coo", "host-coo-pallas"])
def test_one_runner_per_budget_captured_once(monkeypatch, which):
    """On a stand-in card: a chunk at an unchanged budget replays the
    runner's graph; a chunk that grows the budget drops the old runner and
    its graph, then warms up and captures once; `end_fold` keeps the
    runner for the next fold, and `drop` releases it."""
    made = _stand_in_card(monkeypatch)
    gs, engine = _engine(which)
    train, test = _small_test_fold(engine)
    engine.begin_fold(train, test)
    net, opt, gen = _state(gs)
    small, big = _by_size(engine, train, False), _by_size(engine, train)
    engine.run_epochs(net, opt, gen, np.stack([small, small]))
    first, key = engine.runners.runner, engine.runners.key
    assert len(made) == 1 and made[0].replays == 1
    engine.run_epochs(net, opt, gen, np.stack([small]))
    assert engine.runners.runner is first and len(made) == 1 and made[0].replays == 2
    gone = weakref.ref(made[0])
    engine.run_epochs(net, opt, gen, np.stack([big, small]))
    assert engine.runners.key != key and engine.runners.runner is not first
    assert len(made) == 2 and made[1].replays == 1
    del first
    made.pop(0)
    assert gone() is None  # nothing but this test held the old graph
    grown, key = engine.runners.runner, engine.runners.key
    assert grown.capture_seconds is not None
    engine.end_fold()
    assert engine.runners.runner is grown and engine.runners.key == key
    engine.runners.drop()
    assert engine.runners.runner is None and engine.runners.key is None


# -- no host sync -------------------------------------------------------------


@pytest.mark.parametrize("which", ["block-pallas", "block-xla", "device-coo",
                                   "host-coo-xla", "host-coo-pallas"])
def test_sparse_epoch_bodies_make_no_host_sync(which):
    """Two epochs of each new body under the dispatch mode that raises on
    any host read-back (the CPU Adam's step count excused, as for the
    dense body: on the card it stays on the device)."""
    gs, engine = _engine(which)
    train, test = _fold(gs.num_graphs)
    engine.begin_fold(train, test)
    net, opt, gen = _state(gs)
    perms = np.stack([np.random.default_rng(e).permutation(len(train)) for e in range(2)])
    engine.run_epochs(net, opt, gen, perms[:1])  # builds the runner, Adam's state
    runner = engine.runners.runner

    def adam_step(t):
        return any(t.data_ptr() == st["step"].data_ptr() for st in opt.state.values())

    guard = _NoHostSync(allow=adam_step)
    for j, perm in enumerate(perms):
        runner.order.copy_(torch.from_numpy(order_matrix(perm, BATCH, engine.slots)))
        if runner.stage is not None:
            runner.stage(0)
        with guard:
            runner.body()
    assert torch.isfinite(runner.rows).all() and guard.excused > 0


def test_per_batch_orders_and_plans_make_no_host_sync():
    """What the model builds per batch on the card, run on CPU tensors
    under the guard: `edge_order` (both stable sorts), `block_coo_order`,
    and the block kernels' plans (`plan_pieces`, `plan_groups`)."""
    gs, engine = _engine("host-coo-pallas")
    train, test = _fold(gs.num_graphs)
    engine.begin_fold(train, test)
    b = batch_step(engine._test, 0)
    n = b.x.shape[0]
    with _NoHostSync():
        edge_order(b.edge_src, b.edge_dst, n, edge_mask=b.edge_mask, dst_sorted=True)
        edge_order(b.edge_src.flip(0), b.edge_dst.flip(0), n, edge_mask=b.edge_mask)
        block_coo_order(b.blockcoo[0], n)
    gs, engine = _engine("block-pallas")
    train, test = _fold(gs.num_graphs)
    engine.begin_fold(train, test)
    nb, w = engine.budget_for(engine._test_np)
    bb = gather_block_batch(engine.dev, torch.from_numpy(engine._test_np[0]), nb, w)
    items = (bb.item_pool, bb.item_row, bb.item_col, bb.item_permT, bb.item_colT)
    with _NoHostSync():
        plans = [block_csr.make_plan(*items, nb), block_resident.make_plan(*items, nb)]
    assert [p.kind for p in plans] == ["pieces", "groups"]


def test_sparse_runners_run_an_empty_test_order():
    """Each runner built with no test batch runs its body (on the card it
    captures it too): the eval columns are 0, the train columns finite."""
    from dgcnn_tpu_torch.batching.packer import map_batch
    from dgcnn_tpu_torch.train import loop

    for which in ("block-xla", "device-coo", "host-coo-pallas"):
        gs, engine = _engine(which)
        train, test = _fold(gs.num_graphs)
        engine.begin_fold(train, test)
        net, opt, gen = _state(gs)
        orders = order_matrix(train, BATCH, engine.slots)[None]
        empty = np.zeros((0, engine.slots), np.int32)
        if isinstance(engine, cv.BlockSparseEngine):
            nb, w = engine.budget_for(orders)
            runner = loop.make_block_run(net, opt, engine.dev, empty, nb, w,
                                         orders.shape[1], gen, engine.block_impl)
        elif isinstance(engine, cv.DeviceCooEngine):
            runner = loop.make_device_coo_run(net, opt, engine.dev, empty,
                                              engine.bucket_for(orders),
                                              orders.shape[1], gen, engine.spmm_impl)
        else:
            epoch = batch_to_device(engine.pack_host(engine._train_set,
                                                     np.arange(len(train))), "cpu")
            runner = loop.make_coo_run(net, opt, lambda j: epoch,
                                       map_batch(engine._test, lambda a: a[:0]),
                                       engine.slots, gen, engine.spmm_impl)
        rows = runner.run_epochs(orders)
        assert np.isfinite(rows).all() and (rows[:, [1, 3]] == 0).all(), which
        assert (rows[:, 0] > 0).all(), which
