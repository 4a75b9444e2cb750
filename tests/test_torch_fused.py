"""The fused epoch runner on the dense layout (dgcnn_tpu_torch/train/loop.py
`FusedRun`, `make_dense_gather_run`, `make_dense_lockstep_run`) and the
chunk loops that drive it (train/cv.py `run_fold`, train/cv_vmap.py):
chunked epochs bitwise equal to the per-epoch loop the runner replaced,
the runner against JAX's fused runners, chunks cut as the reference cuts
them, no host sync inside an epoch body, the fixed fold pattern, no CUDA
graph on the CPU, and the launch counts of a replay."""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dgcnn_tpu.batching.dense import build_dense_dataset_on_device
from dgcnn_tpu.batching.dense import order_matrix as jax_order_matrix
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.cv_vmap import make_dense_vmap_run
from dgcnn_tpu.train.loop import make_dense_gather_run as jax_make_dense_gather_run
from dgcnn_tpu_torch.batching.dense import (
    build_dense_dataset,
    dense_tile,
    gather_dense_batch,
    order_matrix,
)
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import dense_trunk
from dgcnn_tpu_torch.kernels.block_prop import BlockLaunchCounts
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNFoldsNet,
    DGCNNNet,
    init_params,
    leaves,
    stack_params,
)
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train import loop
from dgcnn_tpu_torch.train.cv_vmap import fold_pattern, stacked_orders
from dgcnn_tpu_torch.train.loop import (
    CountedGraph,
    FoldAdam,
    lockstep_train_step,
    make_dense_gather_run,
    make_dense_lockstep_run,
    make_optimizer,
    nll_loss_and_correct,
    train_step,
)
import torch_threads  # noqa: F401  (torch on one CPU thread)

F, BATCH, SLOTS = 3, 8, 8
# a narrow model: every path of the full one at a few percent of its work
SMALL = dict(hidden_dims=(8, 8, 1), conv1d_channels=(4, 8), dense_dim=16)


def _ragged_folds(n=37):
    """Three folds whose train and test step counts differ at batch 8:
    train 20/27/27 graphs (3/4/4 steps), test 17/10/10 (3/2/2)."""
    perm = np.random.default_rng(0).permutation(n).astype(np.int32)
    tests = [perm[:17], perm[17:27], perm[27:]]
    return [(np.setdiff1d(perm, te).astype(np.int32), te) for te in tests]


def _lockstep_orders(folds, epochs, seed=1):
    """[epochs, steps, F, slots] train orders (each fold shuffled on its
    own stream) and the [t_steps, F, slots] test order."""
    rngs = [np.random.default_rng(seed + f) for f in range(len(folds))]
    train = [tr for tr, _ in folds]
    steps = max(-(-len(t) // BATCH) for t in train)
    t_steps = max(-(-len(te) // BATCH) for _, te in folds)
    order4d = np.stack([
        stacked_orders([t[r.permutation(len(t))] for t, r in zip(train, rngs)],
                       BATCH, SLOTS, steps)
        for _ in range(epochs)])
    return order4d, stacked_orders([te for _, te in folds], BATCH, SLOTS, t_steps)


def _chunks(epochs, max_fused):
    """The chunk lengths of the reference's loops: min(left, max_fused)."""
    out, left = [], epochs
    while left:
        k = min(left, max_fused) if max_fused else left
        out.append(k)
        left -= k
    return out


@pytest.fixture(scope="module")
def small():
    """MUTAG-profile graphs, 37 of them, on the CPU in the dense layout;
    the narrow model, dropout 0.5."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=37, seed=5)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    return gs, model, build_dense_dataset(gs, dense_tile(gs), "cpu")


# -- the per-epoch loops the fused runner replaced -------------------------


def _per_epoch_lockstep(net_f, adam_f, data, order3d, test3d, gens):
    """One lockstep epoch as the per-epoch loop ran it: the order moved to
    the device inside the epoch, each step's generators picked from it on
    the host, then the eval steps."""
    orders = torch.from_numpy(order3d)
    real = (orders >= 0).any(dim=-1)
    real_host = (order3d >= 0).any(axis=-1)
    net_f.train()
    losses, corrects = [], []
    for s in range(order3d.shape[0]):
        step_gens = [g if r else None for g, r in zip(gens, real_host[s])]
        loss_f, correct_f = lockstep_train_step(
            net_f, adam_f, gather_dense_batch(data, orders[s].reshape(-1)), real[s],
            step_gens)
        losses.append(loss_f)
        corrects.append(correct_f)
    tr = loop._fold_means(losses, corrects, real)
    net_f.eval()
    te_orders = torch.from_numpy(test3d)
    losses, corrects = [], []
    with torch.no_grad():
        for row in te_orders:
            batch = gather_dense_batch(data, row.reshape(-1))
            lp = net_f(batch, deterministic=True)
            loss_f, correct_f = nll_loss_and_correct(
                lp, batch.y.view(F, -1), batch.graph_mask.view(F, -1))
            losses.append(loss_f)
            corrects.append(correct_f)
    te = loop._fold_means(losses, corrects, (te_orders >= 0).any(dim=-1))
    return torch.stack([tr[0], te[0], tr[1], te[1]], dim=-1).double().numpy()


def _per_epoch_sequential(net, opt, data, order2d, test2d, gen):
    """One epoch as the per-epoch loop ran it: train steps, eval steps."""
    net.train()
    losses, corrects = [], []
    for row in torch.from_numpy(order2d):
        loss, correct = train_step(net, opt, gather_dense_batch(data, row), gen)
        losses.append(loss)
        corrects.append(correct)
    tr = torch.stack(losses).mean(), torch.stack(corrects).sum()
    net.eval()
    losses, corrects = [], []
    with torch.no_grad():
        for row in torch.from_numpy(test2d):
            batch = gather_dense_batch(data, row)
            loss, correct = nll_loss_and_correct(net(batch, deterministic=True),
                                                 batch.y, batch.graph_mask)
            losses.append(loss)
            corrects.append(correct)
    te = torch.stack(losses).mean(), torch.stack(corrects).sum()
    return torch.stack([tr[0], te[0], tr[1], te[1]]).double().numpy()


def _lockstep_pair(model, folds):
    """Two identical lockstep states (nets, Adams, generators)."""
    per_fold = [init_params(torch.Generator().manual_seed(f), model) for f in range(F)]
    out = []
    for _ in range(2):
        net_f = DGCNNFoldsNet(model, stack_params(per_fold))
        out.append((net_f, FoldAdam(net_f),
                    [torch.Generator().manual_seed(40 + f) for f in range(F)]))
    return out


def _sequential_pair(model):
    out = []
    for _ in range(2):
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model))
        out.append((net, make_optimizer(net), torch.Generator().manual_seed(41)))
    return out


@pytest.mark.parametrize("max_fused", [1, 2, 3])
@pytest.mark.parametrize("driver", ["lockstep", "sequential"])
def test_chunked_epochs_are_the_per_epoch_loops_bits(small, driver, max_fused):
    """3 epochs in chunks of `max_fused` through the fused runner against
    the per-epoch loop it replaced, from the same state, dropout on,
    ragged folds: the rows, the parameters and the optimizer's moments
    and step counts bitwise equal."""
    gs, model, data = small
    folds = _ragged_folds()
    if driver == "lockstep":
        order4d, test3d = _lockstep_orders(folds, epochs=3)
        (net_a, adam_a, gens_a), (net_b, adam_b, gens_b) = _lockstep_pair(model, folds)
        want = np.stack([_per_epoch_lockstep(net_a, adam_a, data, o, test3d, gens_a)
                         for o in order4d])
        runner = make_dense_lockstep_run(
            net_b, adam_b, data, test3d,
            fold_pattern([len(tr) for tr, _ in folds], BATCH, order4d.shape[1]), gens_b)
        orders = order4d

        def state(net_f, adam_f):
            return [net_f.flat, adam_f.exp_avg, adam_f.exp_avg_sq, adam_f.steps]

        a, b = (net_a, adam_a), (net_b, adam_b)
    else:
        train, test = folds[0]
        rng = np.random.default_rng(2)
        orders = np.stack([order_matrix(train[rng.permutation(len(train))], BATCH, SLOTS)
                           for _ in range(3)])
        test2d = order_matrix(test, BATCH, SLOTS)
        (net_a, opt_a, gen_a), (net_b, opt_b, gen_b) = _sequential_pair(model)
        want = np.stack([_per_epoch_sequential(net_a, opt_a, data, o, test2d, gen_a)
                         for o in orders])
        runner = make_dense_gather_run(net_b, opt_b, data, test2d, orders.shape[1], gen_b)

        def state(net, opt):
            return [*net.parameters(), *(opt.state[p][k] for p in net.parameters()
                                         for k in ("step", "exp_avg", "exp_avg_sq"))]

        a, b = (net_a, opt_a), (net_b, opt_b)
    got, e = [], 0
    for k in _chunks(3, max_fused):
        got.append(runner.run_epochs(orders[e:e + k]))
        e += k
    got = np.concatenate(got)
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    for x, y in zip(state(*a), state(*b)):
        assert torch.equal(x, y)


def test_one_hot_pick_equals_f_one_hot():
    """The label pick's comparison one-hot is `F.one_hot`'s, value for
    value, so the loss keeps its bits."""
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 3, (2, 16)).astype(np.int32))
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((2, 16, 3))
                                            .astype(np.float32)), dim=-1)
    mask = torch.from_numpy((rng.random((2, 16)) < 0.8).astype(np.float32))
    onehot = torch.nn.functional.one_hot(y.long(), 3).to(lp.dtype)
    n = mask.sum(-1).clamp(min=1.0)
    want = -(((lp * onehot).sum(-1)) * mask).sum(-1) / n
    loss, _ = nll_loss_and_correct(lp, y, mask)
    assert torch.equal(loss, want)


# -- against JAX's fused runners --------------------------------------------


def test_lockstep_chunk_matches_jax_make_dense_vmap_run():
    """One 3-epoch chunk of `run_epochs` against JAX's lockstep runner given
    order4d [3, steps, F, slots], same weights, dropout 0, ragged folds, at
    the tolerances of tests/test_torch_lockstep.py's test (a): rows rtol
    1e-5 (counts exact); parameters rtol 1e-4 / atol 1e-6 on all but one
    weight in 10,000 of each fold, and every weight within lr per step."""
    jgs = jax_synth("MUTAG", num_graphs=37, seed=5)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=37, seed=5)
    n_tile = dense_tile(gs)
    folds = _ragged_folds()
    order4d, test3d = _lockstep_orders(folds, epochs=3)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0)  # full width: the tolerance counts weights
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0)
    keys = jnp.stack([jax.random.PRNGKey(10 + f) for f in range(F)])
    jp_f = jax.vmap(lambda k: jax_init(k, jm))(keys)
    lr, b2, eps = 1e-3, 0.999, 1e-8
    opt = optax.adam(lr, b2=b2, eps=eps)
    jp_out, _, _, jrows = make_dense_vmap_run(jm, opt)(
        jp_f, jax.vmap(opt.init)(jp_f), keys,
        build_dense_dataset_on_device(jgs, n_tile),
        jnp.asarray(order4d), jnp.asarray(test3d))
    jrows = np.asarray(jrows, np.float64)

    net_f = DGCNNFoldsNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp_f))))
    adam_f = FoldAdam(net_f, lr=lr, b2=b2, eps=eps)
    runner = make_dense_lockstep_run(
        net_f, adam_f, build_dense_dataset(gs, n_tile, "cpu"), test3d,
        fold_pattern([len(tr) for tr, _ in folds], BATCH, order4d.shape[1]),
        [torch.Generator().manual_seed(f) for f in range(F)])
    rows = runner.run_epochs(order4d)
    assert rows.shape == jrows.shape == (3, F, 4)
    np.testing.assert_allclose(rows[..., :2], jrows[..., :2], rtol=1e-5)
    np.testing.assert_array_equal(rows[..., 2:], jrows[..., 2:])
    for f in range(F):
        t = int(((order4d[:, :, f] >= 0).any(-1)).sum())
        got = leaves(state_to_params(net_f.fold_state_dict(f)))
        want = [np.asarray(a[f]) for a in jax.tree_util.tree_leaves(jp_out)]
        misses = 0
        for a, b in zip(got, want):
            diff = np.abs(a.numpy() - b)
            misses += int((diff > 1e-6 + 1e-4 * np.abs(b)).sum())
            assert diff.max() <= lr * t
        assert misses <= sum(a.numel() for a in got) // 10_000, f"fold {f}: {misses}"


def test_dense_engine_run_epochs_matches_jax_make_dense_gather_run():
    """`DenseEngine.run_epochs` over 3 permutations against JAX's fused
    runner given order3d [3, steps, slots] and the fold's test order, same
    weights, dropout 0: rows within rtol 1e-5."""
    jgs = jax_synth("MUTAG", num_graphs=40, seed=2)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=2)
    cfg = Config(data_type="MUTAG", batch_size=BATCH, graph_pad_multiple=4)
    engine = cv.DenseEngine(cfg, gs, "cpu")
    train, test = np.arange(30, dtype=np.int32), np.arange(30, 40, dtype=np.int32)
    engine.begin_fold(train, test)
    perms = np.stack([np.random.default_rng(e).permutation(30) for e in range(3)])
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0, **SMALL)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0, **SMALL)
    jp = jax_init(jax.random.PRNGKey(7), jm)
    opt = optax.adam(1e-3)
    slots = engine.slots
    order3d = np.stack([jax_order_matrix(train[p], BATCH, slots) for p in perms])
    _, _, _, jrows = jax_make_dense_gather_run(jm, opt)(
        jp, opt.init(jp), jax.random.PRNGKey(0),
        build_dense_dataset_on_device(jgs, engine.n_tile), jnp.asarray(order3d),
        jnp.asarray(jax_order_matrix(test, BATCH, slots)))
    net = DGCNNNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))))
    rows = engine.run_epochs(net, make_optimizer(net), torch.Generator().manual_seed(0),
                             perms)
    engine.end_fold()
    assert rows.shape == (3, 4)
    np.testing.assert_allclose(rows, np.asarray(jrows, np.float64), rtol=1e-5)


# -- the chunk loops --------------------------------------------------------


def _cfg(root, sub, **kw):
    base = dict(data_type="MUTAG", batch_size=BATCH, num_epochs=5, seed=324,
                num_folds=F, layout="dense", graph_pad_multiple=4, **SMALL,
                data_root=str(root / "data"),
                epochs_dir=str(root / sub / "epochs"),
                statistics_dir=str(root / sub / "statistics"))
    return Config(**{**base, **kw})


@pytest.mark.parametrize("cv_parallel", ["folds", "sequential"])
def test_chunks_are_cut_as_the_reference_cuts_them(tmp_path, cv_parallel):
    """5 epochs under `max_fused_epochs` 2: every fold's epoch events carry
    `chunk_epochs` 2, 2, 2, 2, 1 (chunks of 2, 2 and 1), and the fold CSVs
    are those of `max_fused_epochs` 1, byte for byte."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=3)
    for m in (2, 1):
        cv.run_cross_validation(_cfg(tmp_path, f"m{m}", cv_parallel=cv_parallel,
                                     max_fused_epochs=m), dataset=gs, device="cpu")
    events = [json.loads(ln) for ln in (tmp_path / "m2" / "statistics" /
                                        "MUTAG_events.jsonl").read_text().splitlines()]
    for fold in range(1, F + 1):
        mine = [e for e in events if e["kind"] == "epoch" and e["fold"] == fold]
        assert [e["epoch"] for e in mine] == [1, 2, 3, 4, 5]
        assert [e["chunk_epochs"] for e in mine] == [2, 2, 2, 2, 1]
        assert mine[0]["epoch_seconds"] == mine[1]["epoch_seconds"]
        name = f"MUTAG_results_{fold}.csv"
        assert (tmp_path / "m2" / "statistics" / name).read_text() == (
            tmp_path / "m1" / "statistics" / name).read_text()
    assert ("folds_in_lockstep" in mine[0]) == (cv_parallel == "folds")


class _NoHostSync(TorchDispatchMode):
    """Raises on every op that reads a tensor back to the host or sizes
    its output by the data: `_local_scalar_dense` (`.item()`), `nonzero`,
    `masked_select`, `unique`, and indexing by a boolean mask (an `index`
    whose index is bool). `allow(tensor)` may excuse a scalar read."""

    BANNED = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
              "_unique", "_unique2", "unique_dim", "unique_consecutive")

    def __init__(self, allow=lambda t: False):
        super().__init__()
        self.allow = allow
        self.excused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        masked = (name.startswith("index") and isinstance(args[1], (list, tuple))
                  and any(i is not None and i.dtype == torch.bool for i in args[1]))
        if name in self.BANNED or masked:
            if name == "_local_scalar_dense" and self.allow(args[0]):
                self.excused += 1
            else:
                raise AssertionError(f"host sync in an epoch body: {func}")
        return func(*args, **(kwargs or {}))


def test_the_sync_guard_catches_what_it_should():
    t = torch.arange(4)
    for fn in (lambda: t.sum().item(), lambda: t.nonzero(), lambda: t[t > 1],
               lambda: torch.masked_select(t, t > 1), lambda: torch.unique(t)):
        with pytest.raises(AssertionError, match="host sync"), _NoHostSync():
            fn()


@pytest.mark.parametrize("driver", ["lockstep", "sequential"])
def test_epoch_bodies_make_no_host_sync(small, driver):
    """Two epochs of each body under a dispatch mode that raises on any
    host read-back. The one read excused is the CPU Adam's step count
    (torch refuses `capturable` on the CPU; on the card `make_optimizer`
    keeps it on the device), and only in the sequential body."""
    gs, model, data = small
    folds = _ragged_folds()
    if driver == "lockstep":
        order4d, test3d = _lockstep_orders(folds, epochs=2)
        (net_f, adam_f, gens), _ = _lockstep_pair(model, folds)
        runner = make_dense_lockstep_run(
            net_f, adam_f, data, test3d,
            fold_pattern([len(tr) for tr, _ in folds], BATCH, order4d.shape[1]), gens)
        guard = _NoHostSync()
    else:
        train, test = folds[0]
        order4d = np.stack([order_matrix(train, BATCH, SLOTS)] * 2)
        (net, opt, gen), _ = _sequential_pair(model)
        runner = make_dense_gather_run(net, opt, data, order_matrix(test, BATCH, SLOTS),
                                       order4d.shape[1], gen)

        def adam_step(t):
            return any(t.data_ptr() == st["step"].data_ptr() for st in opt.state.values())

        guard = _NoHostSync(allow=adam_step)
    for order in order4d:
        runner.order.copy_(torch.from_numpy(order))
        with guard:
            runner.body()
    assert torch.isfinite(runner.rows).all()
    assert (guard.excused > 0) == (driver == "sequential")


# -- the fixed fold pattern -------------------------------------------------


def test_fold_pattern_is_every_epochs_and_the_runner_refuses_another(small):
    """`stacked_orders` puts each fold's padding rows after its batches, so
    the real-fold pattern is `fold_pattern` of the fold sizes under any
    permutation; the runner raises on an order with another pattern or
    shape."""
    gs, model, data = small
    folds = _ragged_folds()
    order4d, test3d = _lockstep_orders(folds, epochs=4, seed=9)
    pattern = fold_pattern([len(tr) for tr, _ in folds], BATCH, order4d.shape[1])
    assert pattern.shape == (4, F) and not pattern.all()
    for order in order4d:
        np.testing.assert_array_equal((order >= 0).any(-1), pattern)
    (net_f, adam_f, gens), _ = _lockstep_pair(model, folds)
    runner = make_dense_lockstep_run(net_f, adam_f, data, test3d, pattern, gens)
    moved = order4d[:1].copy()
    moved[0, [0, -1], 0] = moved[0, [-1, 0], 0]  # fold 0 skips step 0 instead
    with pytest.raises(ValueError, match="real steps"):
        runner.run_epochs(moved)
    with pytest.raises(ValueError, match="do not fit"):
        runner.run_epochs(order4d[:1, :-1])
    before = net_f.flat.clone()
    runner.run_epochs(order4d[:1])
    assert not torch.equal(before, net_f.flat)


@pytest.mark.parametrize("cv_parallel,layout", [
    ("folds", dict(layout="dense")), ("sequential", dict(layout="dense")),
    ("sequential", dict(layout="block")), ("sequential", dict(layout="coo")),
    ("sequential", dict(layout="coo", spmm_impl="pallas")),
], ids=["folds", "sequential", "block", "coo", "coo-host"])
def test_a_cpu_run_builds_no_cuda_graph(tmp_path, monkeypatch, cv_parallel, layout):
    """On the CPU every epoch runs the body eagerly, on every layout: no
    CUDA graph, capture or stream is ever made."""
    def refuse(*a, **k):
        raise AssertionError("a CPU run touched a CUDA graph")

    for name in ("CUDAGraph", "graph", "Stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=1)
    res = cv.run_cross_validation(
        _cfg(tmp_path, "x", cv_parallel=cv_parallel, num_epochs=3, max_fused_epochs=2,
             **layout),
        dataset=gs, device="cpu")
    assert len(res["test_accuracies"]) == F


# -- launch counts of a replay ----------------------------------------------


class _FakeGraph:
    """Stands in for a `torch.cuda.CUDAGraph`: counts its replays."""

    def __init__(self):
        self.replays = 0
        self.generators = []
        self.on_replay = lambda: None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1
        self.on_replay()


def test_a_replay_adds_the_captures_counts_once():
    """The counters' difference over the capture is taken back at its end
    and added once per replay, for any counter object (the trunk's and the
    block and SpMM kernels')."""
    trunk, block = dense_trunk.TrunkLaunchCounts(), BlockLaunchCounts()
    trunk.fwd_launches, block.f1_bwd = 5, 2
    graph = CountedGraph(_FakeGraph(), (trunk, block))
    with graph.capture():
        trunk.fwd_launches += 3
        trunk.resident_fwd += 3
        block.count(True, 1)
    assert (trunk.fwd_launches, trunk.resident_fwd, block.bwd_launches,
            block.f1_bwd) == (5, 0, 0, 2)
    for _ in range(4):
        graph.replay()
    assert graph.graph.replays == 4
    assert (trunk.fwd_launches, trunk.resident_fwd, block.bwd_launches,
            block.f1_bwd) == (17, 12, 4, 6)


def test_the_runner_warms_up_captures_once_then_replays(monkeypatch):
    """`FusedRun` on a stand-in card: the chunk's first epoch runs the body
    eagerly (the warm-up), the body is captured once with every dropout
    generator registered, each later epoch is one replay, and the trunk
    counter reads one epoch's launches per epoch run."""
    made = []

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            self.graph = graph

        def __enter__(self):
            state["capturing"] = True

        def __exit__(self, *exc):
            state["capturing"] = False

    def new_graph():
        g = _FakeGraph()
        g.on_replay = run_recorded
        made.append(g)
        return g

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    state = {"capturing": False, "ran": 0}
    order = torch.zeros((2, 3), dtype=torch.int32)
    rows = torch.zeros(4)

    def run_recorded():  # what a replay executes
        state["ran"] += 1
        rows.fill_(float(order.sum()))

    def body():
        dense_trunk.launches.fwd_launches += 2  # a wrapper's count, per Python call
        if not state["capturing"]:
            run_recorded()

    gens = [torch.Generator(), torch.Generator()]
    runner = loop.FusedRun(body, order, rows, np.ones(2, dtype=bool), gens)
    runner.graphs, runner.stream = True, Stream()  # as on the card
    dense_trunk.launches.reset()
    try:
        orders = np.arange(3 * 2 * 3, dtype=np.int32).reshape(3, 2, 3)
        out = runner.run_epochs(orders)
        np.testing.assert_array_equal(out[:, 0], orders.reshape(3, -1).sum(-1))
        assert len(made) == 1 and made[0].replays == 2 and state["ran"] == 3
        assert made[0].generators == gens
        assert dense_trunk.launches.fwd_launches == 2 * 3
        assert runner.capture_seconds is not None
        runner.run_epochs(orders[:1])
        assert len(made) == 1 and made[0].replays == 3
        assert dense_trunk.launches.fwd_launches == 2 * 4
    finally:
        dense_trunk.launches.reset()
