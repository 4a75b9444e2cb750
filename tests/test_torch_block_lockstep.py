"""Fold-lockstep on the block-sparse layout (dgcnn_tpu_torch): the merged
gather (`gather_block_batch_folds`) and its budgets (`block_fold_extents`)
against the reference's after the row-id map, the merged-stream
propagation under both kernels' plans against JAX's
`block_propagate_folds` (forward and VJP), `sort_pool_folds` against
JAX's on tied and ±0 keys, `apply_block_folds` against JAX's and against
`apply_block` fold by fold, the lockstep epochs against JAX's
`make_block_vmap_run`, the lockstep driver against the sequential driver
(rows within the reference's 5e-4, dropout masks bitwise), `auto`
dispatch, and the grow-only budgets with one runner a budget."""

import dataclasses
import functools
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_fused import SMALL, _NoHostSync
from test_torch_fused_sparse import _stand_in_card

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_block_folds as jax_apply_block_folds
from dgcnn_tpu.models.dgcnn import block_propagate_folds as jax_propagate_folds
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.ops.sort_pool import sort_pool_folds as jax_sort_pool_folds
from dgcnn_tpu.train.cv import DeviceCooEngine as JDeviceCooEngine
from dgcnn_tpu.train.cv_vmap import make_block_vmap_run
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import block_csr, block_resident
from dgcnn_tpu_torch.models import dgcnn as port_model
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNFoldsNet,
    DGCNNNet,
    apply_block,
    apply_block_folds,
    init_params,
    stack_params,
)
from dgcnn_tpu_torch.ops.sort_pool import sort_pool_folds
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv, cv_vmap
from dgcnn_tpu_torch.train.loop import (
    FoldAdam,
    epoch_rows,
    make_block_lockstep_run,
    make_optimizer,
    nll_loss_and_correct,
)
import torch_threads  # noqa: F401  (torch on one CPU thread)

F, BATCH, SLOTS = 3, 8, 8
KERNELS = {"pallas": block_csr, "xla": block_resident}


@functools.lru_cache(maxsize=None)
def _data(n=36, seed=4):
    gs = synthesize_tu_dataset("DD", num_graphs=n, seed=seed)
    jset = jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(gs))
    tset = tbs.block_graphset_to_device(tbs.build_block_graphset(gs), "cpu")
    return gs, jset, tset


def _rows(n=36, seed=1):
    """[F, SLOTS] graph ids: fold 0 full, fold 1 with empty slots, fold 2
    with a single graph."""
    perm = np.random.default_rng(seed).permutation(n).astype(np.int32)
    rows = perm[:F * SLOTS].reshape(F, SLOTS).copy()
    rows[1, [2, 5, 7]] = -1
    rows[2, 1:] = -1
    return rows


def _budgets(tset, rows, headroom=(2, 9)):
    nb, w = tbs.block_fold_extents(tset.nb.numpy(), tset.block_count.numpy(), rows[None])
    return nb + headroom[0], w + headroom[1]


def _batches(rows):
    gs, jset, tset = _data()
    nb, w = _budgets(tset, rows)
    jb = jax.jit(functools.partial(jbs.gather_block_batch_folds, nb_budget=nb,
                                   w_budget=w))(jset, jnp.asarray(rows))
    tb = tbs.gather_block_batch_folds(tset, torch.from_numpy(rows), nb, w)
    return gs, jset, tset, jb, tb, nb, w


def _port_ids(r, nb):
    """The reference's row ids f·(nb+1) + row → the port's f·nb + row."""
    r = np.asarray(r)
    return (r // (nb + 1)) * nb + r % (nb + 1)


def test_gather_folds_equals_jax_after_the_row_id_map():
    """Every field of the merged batch against the reference's: x and the
    node arrays bitwise, item lists exact once the reference's row ids are
    mapped (no real item on the reference's extra row; padding F·(nb+1)
    → F·nb), the source ids as they are; a fold with one graph."""
    for rows in (_rows(), np.array([[0, 1, -1, -1], [-1, -1, -1, -1], [2, -1, 3, 4]],
                                   np.int32)):
        _, _, _, jb, tb, nb, w = _batches(rows)
        assert int(tb.num_items) == int(jb.num_items) < w
        want = {
            "x": np.asarray(jb.x), "item_pool": np.asarray(jb.item_pool),
            "item_row": _port_ids(jb.item_rowseg, nb), "item_col": np.asarray(jb.item_colsrc),
            "item_permT": np.asarray(jb.item_permT),
            "item_colT": _port_ids(jb.item_colTseg, nb),
            "node_graph": np.asarray(jb.node_graph), "node_mask": np.asarray(jb.node_mask),
            "y": np.asarray(jb.y), "graph_mask": np.asarray(jb.graph_mask),
            "num_items": np.asarray(jb.num_items),
        }
        assert {f.name for f in dataclasses.fields(tbs.FoldBlockBatch)} == set(want)
        for name, b in want.items():
            a = getattr(tb, name).numpy()
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert (tb.item_row.numpy()[int(tb.num_items):] == F * nb).all()
        assert (np.diff(tb.item_row.numpy()) >= 0).all()
        assert (np.diff(tb.item_colT.numpy()) >= 0).all()


def test_fold_extents_equal_the_reference_and_budget_grows_only():
    """`block_fold_extents` against the reference's on random [k, steps, F,
    slots] order matrices; the engine's lockstep budgets are the
    reference's rule (geometric grid, floors 8 and 64) and grow only."""
    gs, jset, tset = _data()
    nb_h, bc_h = tset.nb.numpy(), tset.block_count.numpy()
    rng = np.random.default_rng(0)
    engine = cv.BlockSparseEngine(Config(data_type="DD", batch_size=BATCH,
                                         graph_pad_multiple=4), gs, "cpu")
    floor = (8, 64)
    for trial in range(6):
        mat = rng.integers(-1, gs.num_graphs, (2, 3, F, engine.slots)).astype(np.int32)
        if trial == 0:
            mat[:] = -1
            mat[..., 0] = 0
        want = jbs.block_fold_extents(nb_h, bc_h, mat)
        assert tbs.block_fold_extents(nb_h, bc_h, mat) == want
        floor = tuple(max(floor[i], JDeviceCooEngine._geom_round(want[i], (8, 64)[i]))
                      for i in (0, 1))
        assert engine.budget_for(mat, folds=True) == floor
    assert engine.budget_for(mat[:, :, :, :1], folds=True) == floor  # never shrinks


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_merged_propagation_matches_jax_block_propagate_folds(impl):
    """The merged stream through a kernel's plain version, walking the
    kernel's plan (pieces or groups) over nb' = F·nb block-rows, against
    JAX's `block_propagate_folds` on the reference's batch: forward, and
    the VJP of a random cotangent through `jax.vjp`, rtol 1e-5."""
    gs, jset, tset, jb, tb, nb, w = _batches(_rows())
    rng = np.random.default_rng(3)
    d = 5
    hb = rng.standard_normal((F, nb, 128, d)).astype(np.float32)
    g = rng.standard_normal((F, nb, 128, d)).astype(np.float32)
    jargs = (jset.pool, jb.item_pool, jb.item_rowseg, jb.item_colsrc, jb.item_permT,
             jb.item_colTseg, jb.num_items)
    want, vjp = jax.vjp(lambda h: jax_propagate_folds(h, *jargs), jnp.asarray(hb))
    want_g, = vjp(jnp.asarray(g))
    mod = KERNELS[impl]
    items = (tb.item_pool, tb.item_row, tb.item_col, tb.item_permT, tb.item_colT)
    plan = mod.make_plan(*items, F * nb)
    assert plan.kind == ("pieces" if impl == "pallas" else "groups")
    x = torch.from_numpy(hb).reshape(F * nb, 128, d).requires_grad_()
    prop = port_model.BLOCK_PROPAGATE[impl][0]
    out = prop(x, tset.pool, *items, tb.num_items, plan)
    out.backward(torch.from_numpy(g).reshape(F * nb, 128, d))
    np.testing.assert_allclose(out.detach().numpy().reshape(hb.shape), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy().reshape(hb.shape), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("row_block", [0, 8])
@pytest.mark.parametrize("k", [3, 6])
def test_sort_pool_folds_matches_jax_on_ties(k, row_block):
    """Keys from {−1, 0, 1} with ±0 mixed in, each fold's graphs in runs of
    8 nodes (block-row aligned), padded runs and a graph smaller than k:
    the pooled rows bitwise JAX's `sort_pool_folds` at the same
    `row_block`, and the gradient reaching each kept row once."""
    rng = np.random.default_rng(k + row_block)
    slots = 4
    runs = np.array([[0, 0, 1, 4, 2, 3, 3, 4],
                     [1, 1, 1, 0, 2, 4, 4, 4],
                     [4, 4, 4, 4, 4, 4, 4, 4]], np.int32)  # 4 = padding
    node_graph = np.repeat(runs, 8, axis=1)
    node_graph[0, 28:32] = slots  # a partly padded run
    x = rng.standard_normal((F, node_graph.shape[1], 4)).astype(np.float32)
    x[..., -1] = rng.integers(-1, 2, node_graph.shape).astype(np.float32)
    x[:, ::5, -1] = -0.0
    want = jax_sort_pool_folds(jnp.asarray(x), jnp.asarray(node_graph), slots, k,
                               row_block=row_block)
    xt = torch.from_numpy(x).requires_grad_()
    got = sort_pool_folds(xt, torch.from_numpy(node_graph), slots, k, row_block=row_block)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    gr = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(gr))
    jg = jax.grad(lambda a: (jax_sort_pool_folds(a, jnp.asarray(node_graph), slots, k,
                                                 row_block=row_block) * gr).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def _jax_models(gs, dropout=0.5):
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=dropout)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=dropout)
    keys = jnp.stack([jax.random.PRNGKey(20 + f) for f in range(F)])
    jp_f = jax.vmap(lambda key: jax_init(key, jm))(keys)
    return jm, tm, keys, jp_f, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp_f)))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_apply_block_folds_matches_jax_and_apply_block_per_fold(impl):
    """Deterministic, shared weights: the log-probs against JAX's
    `apply_block_folds` at rtol 1e-5; and with dropout on, fold f's
    log-probs, dropout mask and parameter gradients against `apply_block`
    of fold f's weights on fold f's own batch, its generator ending in the
    same state."""
    rows = _rows()
    gs, jset, tset, jb, tb, nb, w = _batches(rows)
    jm, tm, _, jp_f, params_f = _jax_models(gs)
    want = jax_apply_block_folds(jp_f, jm, jb, jset.pool)
    net_f = DGCNNFoldsNet(tm, params_f)
    got = net_f(tb, pool=tset.pool, block_impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    gens = [torch.Generator().manual_seed(60 + f) for f in range(F)]
    lp, acts = net_f(tb, deterministic=False, dropout_gens=gens, pool=tset.pool,
                     block_impl=impl, return_activations=True)
    loss_f, _ = nll_loss_and_correct(lp, tb.y, tb.graph_mask)
    loss_f.sum().backward()
    for f in range(F):
        net = DGCNNNet(tm, state_to_params(net_f.fold_state_dict(f)))
        gen = torch.Generator().manual_seed(60 + f)
        b = tbs.gather_block_batch(tset, torch.from_numpy(rows[f]), nb, w)
        lp1, acts1 = apply_block(net.params(), tm, b, tset.pool, deterministic=False,
                                 dropout_gen=gen, return_activations=True,
                                 block_impl=impl)
        nll_loss_and_correct(lp1, b.y, b.graph_mask)[0].backward()
        assert torch.equal(acts["dropout_keep"][f], acts1["dropout_keep"])
        assert torch.equal(gens[f].get_state(), gen.get_state())
        np.testing.assert_allclose(lp[f].detach().numpy(), lp1.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        for (name, p_f), p in zip(net_f.named_parameters(), net.parameters()):
            np.testing.assert_allclose(p_f.grad[f].numpy(), p.grad.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"fold {f} {name}")


def _ragged_folds(n):
    """Three folds whose train and test step counts differ at batch 8."""
    perm = np.random.default_rng(0).permutation(n).astype(np.int32)
    tests = [perm[:12], perm[12:20], perm[20:]]
    return [(np.setdiff1d(perm, te).astype(np.int32), te) for te in tests]


def test_lockstep_epochs_match_jax_make_block_vmap_run():
    """Same weights, same orders, dropout 0, ragged folds: the port's block
    lockstep runner against JAX's `make_block_vmap_run` at the same
    budgets, 2 epochs: losses within rtol 1e-5, correct counts equal."""
    gs, jset, tset = _data()
    jgs = jax_synth("DD", num_graphs=36, seed=4)
    folds = _ragged_folds(gs.num_graphs)
    rng = np.random.default_rng(1)
    train = [tr for tr, _ in folds]
    steps = max(-(-len(t) // BATCH) for t in train)
    t_steps = max(-(-len(te) // BATCH) for _, te in folds)
    order4d = np.stack([cv_vmap.stacked_orders(
        [t[rng.permutation(len(t))] for t in train], BATCH, SLOTS, steps)
        for _ in range(2)])
    test3d = cv_vmap.stacked_orders([te for _, te in folds], BATCH, SLOTS, t_steps)
    assert (test3d[-1] == -1).all(-1).any()  # a fold skips the last test step
    nb, w = (cv._geom_round(v, m) for v, m in zip(
        tbs.block_fold_extents(tset.nb.numpy(), tset.block_count.numpy(),
                               np.concatenate([order4d.reshape(-1, F, SLOTS), test3d])),
        (8, 64)))
    jm, tm, keys, jp_f, params_f = _jax_models(gs, dropout=0.0)
    opt = optax.adam(1e-3)
    jrows = make_block_vmap_run(jm, opt, nb, w)(
        jp_f, jax.vmap(opt.init)(jp_f), keys,
        jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(jgs)),
        jnp.asarray(order4d), jnp.asarray(test3d))[3]
    net_f = DGCNNFoldsNet(tm, params_f)
    gens = [torch.Generator().manual_seed(f) for f in range(F)]
    runner = make_block_lockstep_run(net_f, FoldAdam(net_f), tset, test3d, nb, w,
                                     (order4d[0] >= 0).any(-1), gens, "pallas")
    rows = runner.run_epochs(order4d)
    jrows = np.asarray(jrows, np.float64)
    assert rows.shape == jrows.shape == (2, F, 4)
    np.testing.assert_allclose(rows[..., :2], jrows[..., :2], rtol=1e-5)
    np.testing.assert_array_equal(rows[..., 2:], jrows[..., 2:])


def _cv_cfg(root, sub, **kw):
    base = dict(data_type="DD", batch_size=BATCH, num_epochs=2, seed=324, num_folds=3,
                layout="block", graph_pad_multiple=4, max_fused_epochs=1,
                data_root=str(root / "data"), epochs_dir=str(root / sub / "epochs"),
                statistics_dir=str(root / sub / "statistics"))
    return Config(**{**base, **kw})


def _events(cfg):
    with open(f"{cfg.statistics_dir}/DD_events.jsonl") as fh:
        return [json.loads(ln) for ln in fh]


@pytest.fixture(scope="module")
def seq_and_lockstep(tmp_path_factory):
    """The sequential and lockstep drivers (both kernels' plain versions)
    on the same 36 DD graphs: 3 folds, batch 8, 2 epochs in chunks of 1,
    dropout 0.5."""
    root = tmp_path_factory.mktemp("cv")
    gs = _data()[0]
    cfgs = {mode: _cv_cfg(root, mode, cv_parallel=mode)
            for mode in ("sequential", "folds")}
    cfgs["auto"] = _cv_cfg(root, "auto", block_impl="xla")
    res = {mode: cv.run_cross_validation(cfg, dataset=gs, device="cpu")
           for mode, cfg in cfgs.items()}
    return cfgs, res


def test_block_lockstep_matches_sequential_driver(seq_and_lockstep):
    """Every fold's CSV rows within rtol/atol 5e-4 of the sequential
    driver's (the reference's own lockstep tolerance), ragged folds,
    dropout on; the same accuracies."""
    cfgs, res = seq_and_lockstep
    assert res["folds"]["test_accuracies"] == res["sequential"]["test_accuracies"]
    for fold in (1, 2, 3):
        a, b = (np.loadtxt(f"{cfgs[m].statistics_dir}/DD_results_{fold}.csv",
                           delimiter=",", skiprows=1) for m in ("sequential", "folds"))
        assert a.shape == b.shape == (2, 5)
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4, err_msg=f"fold {fold}")


def test_auto_locksteps_block(seq_and_lockstep, capsys):
    """`cv_parallel="auto"` on the block layout trains in lockstep, as the
    reference does on one device: every epoch event carries
    `folds_in_lockstep`, and nothing says "not ported"; the other kernel's
    plain version gives the explicit lockstep run's rows."""
    cfgs, res = seq_and_lockstep
    assert "not ported" not in capsys.readouterr().out
    events = _events(cfgs["auto"])
    assert events[0]["layout"] == "block" and events[0]["block_impl"] == "xla"
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [(e["epoch"], e["fold"]) for e in epochs] == [
        (ep, f) for ep in (1, 2) for f in (1, 2, 3)]
    assert all(e["folds_in_lockstep"] == 3 and e["chunk_epochs"] == 1 for e in epochs)
    assert cv.lockstep_engages(cfgs["auto"], _data()[0], "block")
    for fold in (1, 2, 3):
        a, b = (np.loadtxt(f"{cfgs[m].statistics_dir}/DD_results_{fold}.csv",
                           delimiter=",", skiprows=1) for m in ("auto", "folds"))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_block_lockstep_dropout_masks_are_the_sequential_bits(monkeypatch):
    """Over one epoch of ragged folds, each fold's dropout masks in block
    lockstep are bitwise the sequential epoch's for that fold, step by
    step, and its generator ends in the same state (a fold draws nothing
    on a step past its own)."""
    seen = []
    inner = port_model._pooled_to_log_probs

    def record(params, model, pooled, deterministic, gen, acts):
        out = inner(params, model, pooled, deterministic, gen, acts)
        if not deterministic:
            seen.append(acts["dropout_keep"])
        return out

    monkeypatch.setattr(port_model, "_pooled_to_log_probs", record)
    gs, _, tset = _data()
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    folds = _ragged_folds(gs.num_graphs)
    train = [tr for tr, _ in folds]
    steps = max(-(-len(t) // BATCH) for t in train)
    t_steps = max(-(-len(te) // BATCH) for _, te in folds)
    order = cv_vmap.stacked_orders(train, BATCH, SLOTS, steps)
    test3d = cv_vmap.stacked_orders([te for _, te in folds], BATCH, SLOTS, t_steps)
    assert not (order[-1] >= 0).any(-1).all()  # a fold skips the last step
    nb, w = _budgets(tset, np.concatenate([order, test3d]), (0, 0))
    per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
    net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
    gens = [torch.Generator().manual_seed(7 + f) for f in range(F)]
    make_block_lockstep_run(net_f, FoldAdam(net_f), tset, test3d, nb, w,
                            (order >= 0).any(-1), gens).run_epochs(order[None])
    lock, seen[:] = list(seen), []
    for f in range(F):
        net = DGCNNNet(tm, per_fold[f])
        gen = torch.Generator().manual_seed(7 + f)
        own = order[:, f][(order[:, f] >= 0).any(-1)]
        own_test = test3d[:, f][(test3d[:, f] >= 0).any(-1)]
        epoch_rows(net, make_optimizer(net),
                   lambda r: tbs.gather_block_batch(tset, r, nb, w),
                   torch.from_numpy(own), torch.from_numpy(own_test), gen,
                   pool=tset.pool, block_impl="pallas")
        assert len(seen) == len(own) <= len(lock)
        for s, mask in enumerate(seen):
            assert torch.equal(lock[s][f], mask), f"fold {f} step {s}"
        assert torch.equal(gens[f].get_state(), gen.get_state()), f"fold {f}"
        seen.clear()


def _wrap_lockstep_runners(monkeypatch):
    """`_stand_in_card` for the lockstep runners: their bodies run on the
    CPU, their captures and replays on stand-in graphs."""
    made = _stand_in_card(monkeypatch)
    for name in ("make_block_lockstep_run", "make_multi_lockstep_run"):
        build = getattr(cv_vmap, name)

        def on_card(*a, _build=build, **k):
            runner = _build(*a, **k)
            runner.graphs, runner.stream = True, torch.cuda.current_stream()
            return runner

        monkeypatch.setattr(cv_vmap, name, on_card)
    return made


def _chunks(engine, folds):
    """Three chunks of per-fold epoch orders: two at the smallest-first
    order, then one with every fold's largest graphs first."""
    sizes = engine._block_counts[:-1]
    asc = [tr[np.argsort(sizes[tr], kind="stable")] for tr, _ in folds]
    desc = [tr[np.argsort(-sizes[tr], kind="stable")] for tr, _ in folds]
    return [[asc, asc], [asc], [desc, asc]]


def test_budget_grows_only_one_runner_a_budget(monkeypatch):
    """`lockstep_chunk` over three chunks: the budget is the reference's
    rule over each chunk's orders and the test order, grows at the chunk
    with the largest graphs and only there; on a stand-in card the first
    runner replays, the grown budget drops it with its graph and builds
    exactly one new runner, which captures once; the chunk bodies make no
    host sync; and the rows across the growth equal a run built at the
    grown budget from the start."""
    gs, _, tset = _data()
    folds = _ragged_folds(gs.num_graphs)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    cfg = Config(data_type="DD", batch_size=BATCH, graph_pad_multiple=4)
    test_ids = [te for _, te in folds]

    def run(floors=None, card=False):
        engine = cv.BlockSparseEngine(cfg, gs, "cpu")
        if floors:
            engine.floor_nb, engine.floor_w = floors
        per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
        net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
        adam_f = FoldAdam(net_f)
        gens = [torch.Generator().manual_seed(7 + f) for f in range(F)]
        keys, rows = [], []
        for ids_k in _chunks(engine, folds):
            runner, orders = cv_vmap.lockstep_chunk(engine, net_f, adam_f, gens, ids_k,
                                                    test_ids)
            keys.append(engine.runners.key)
            if card:
                rows.append(runner.run_epochs(orders))
            else:
                runner.order.copy_(torch.from_numpy(orders[0]))
                with _NoHostSync():
                    runner.body()
                rows.append(runner.rows.double().numpy()[None])
                if len(orders) > 1:
                    rows.append(runner.run_epochs(orders[1:]))
        return keys, np.concatenate(rows), engine

    keys, rows, _ = run()
    assert keys[0] == keys[1] and keys[2] > keys[1]
    grown_keys, grown_rows, _ = run(floors=keys[2])
    assert grown_keys == [keys[2]] * 3
    np.testing.assert_array_equal(rows, grown_rows)

    made = _wrap_lockstep_runners(monkeypatch)
    card_keys, _, engine = run(card=True)
    assert card_keys == keys
    assert len(made) == 2 and [g.replays for g in made] == [2, 1]
    gone = weakref.ref(made[0])
    made.pop(0)
    assert gone() is None  # the first runner's graph went with its drop
    engine.end_fold()
    assert engine.runners.runner is None
