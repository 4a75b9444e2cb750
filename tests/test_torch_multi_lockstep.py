"""Fold-lockstep on the multi-tile dense layout (dgcnn_tpu_torch): the
fold-stacked forward `apply_multi_dense_folds` against JAX's (log-probs,
y and graph mask in its slot order) and against `apply_multi_dense` fold
by fold (dropout masks bitwise, gradients), the lockstep epochs against
JAX's `make_multi_vmap_run`, the lockstep driver against the sequential
driver (rows within the reference's 5e-4, dropout masks bitwise), the
grow-only slot tuple with one runner a tuple, and the dispatch: `auto`
never locksteps multi on one device."""

import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_block_lockstep import _wrap_lockstep_runners
from test_torch_fused import SMALL, _NoHostSync
from test_torch_multi_engine import FIELDS, _collab, _engine

from dgcnn_tpu.batching import multi_dense as jmd
from dgcnn_tpu.batching.dense import gather_dense_batch as jax_gather
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_multi_dense_folds as jax_apply_folds
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.cv_vmap import make_multi_vmap_run
from dgcnn_tpu_torch.batching.dense import gather_dense_batch
from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch, route_order_rows
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.models import dgcnn as port_model
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNFoldsNet,
    DGCNNNet,
    apply_multi_dense,
    init_params,
    stack_params,
)
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv, cv_vmap
from dgcnn_tpu_torch.train.loop import (
    FoldAdam,
    epoch_rows,
    make_optimizer,
    nll_loss_and_correct,
)
import torch_threads  # noqa: F401  (torch on one CPU thread)

F, BATCH = 3, 8


def _ragged_folds(n=40):
    """Three folds whose train and test step counts differ at batch 8:
    test 12/8/20 (2/1/3 steps), train 28/32/20 (4/4/3 steps)."""
    perm = np.random.default_rng(0).permutation(n).astype(np.int32)
    tests = [perm[:12], perm[12:20], perm[20:]]
    return [(np.setdiff1d(perm, te).astype(np.int32), te) for te in tests]


def _step(engine, seed=1):
    """One lockstep step: fold f's batch of 8 graphs (fold 2's holds 3),
    each routed into the classes at the slot tuple that fits all three;
    the port's fold-major MultiDenseBatch and the reference's per-class
    batches of F × S_c slots, each fold's own ids, and the slots."""
    rng = np.random.default_rng(seed)
    ids = [rng.permutation(40)[:n] for n in (8, 8, 3)]
    counts = np.stack([np.bincount(engine.routing.class_of[i], minlength=4) for i in ids])
    slots = tuple(int(s) for s in -(-counts.max(0) // 4) * 4)
    rows = [route_order_rows(engine.routing, i, slots) for i in ids]
    flat = [np.concatenate([r[c] for r in rows]) for c in range(len(slots))]
    jclasses = [jax.tree_util.tree_map(jnp.asarray, c) for c in jmd.build_multi_dense(
        jax_synth("COLLAB", num_graphs=40, seed=3), engine.tiles)[0]]
    tb = MultiDenseBatch(tuple(gather_dense_batch(d, torch.from_numpy(r))
                               for d, r in zip(engine.classes, flat)), num_folds=F)
    jb = tuple(jax_gather(d, jnp.asarray(r)) for d, r in zip(jclasses, flat))
    return tb, jb, ids, slots


def _models(gs, dropout):
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=dropout, **SMALL)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=dropout, **SMALL)
    keys = jnp.stack([jax.random.PRNGKey(30 + f) for f in range(F)])
    jp_f = jax.vmap(lambda k: jax_init(k, jm))(keys)
    return jm, tm, keys, jp_f, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp_f)))


def test_apply_multi_dense_folds_matches_jax():
    """Shared weights, dropout off, a step whose folds leave classes empty:
    the log-probs [F, ΣS_c, C] against JAX's `apply_multi_dense_folds` at
    rtol 1e-5, and the batch's fold-major y and graph mask equal to the
    y and graph mask JAX returns, in its slot order."""
    gs, engine = _collab(), _engine()
    tb, jb, _, slots = _step(engine)
    jm, tm, _, jp_f, params_f = _models(gs, 0.0)
    jlp, jy, jgm = jax_apply_folds(jp_f, jm, jb, F)
    lp = DGCNNFoldsNet(tm, params_f)(tb)
    assert lp.shape == (F, sum(slots), gs.num_classes)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tb.y.view(F, -1).numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tb.graph_mask.view(F, -1).numpy(), np.asarray(jgm))
    assert (tb.graph_mask.view(F, -1).sum(1).numpy() == [8, 8, 3]).all()


def test_fold_forward_equals_apply_multi_dense_per_fold():
    """With dropout on: fold f's log-probs, dropout mask and parameter
    gradients against `apply_multi_dense` of fold f's weights on fold f's
    own batch, its generator ending in the same state."""
    gs, engine = _collab(), _engine()
    tb, _, ids, slots = _step(engine, seed=2)
    _, tm, _, _, params_f = _models(gs, 0.5)
    net_f = DGCNNFoldsNet(tm, params_f)
    gens = [torch.Generator().manual_seed(70 + f) for f in range(F)]
    lp, acts = net_f(tb, deterministic=False, dropout_gens=gens, return_activations=True)
    loss_f, _ = nll_loss_and_correct(lp, tb.y.view(F, -1), tb.graph_mask.view(F, -1))
    loss_f.sum().backward()
    for f in range(F):
        net = DGCNNNet(tm, state_to_params(net_f.fold_state_dict(f)))
        gen = torch.Generator().manual_seed(70 + f)
        own = MultiDenseBatch(tuple(
            gather_dense_batch(d, torch.from_numpy(r))
            for d, r in zip(engine.classes, route_order_rows(engine.routing, ids[f], slots))))
        lp1, acts1 = apply_multi_dense(net.params(), tm, own.classes, deterministic=False,
                                       dropout_gen=gen, return_activations=True)
        nll_loss_and_correct(lp1, own.y, own.graph_mask)[0].backward()
        assert torch.equal(acts["dropout_keep"][f], acts1["dropout_keep"])
        assert torch.equal(gens[f].get_state(), gen.get_state())
        np.testing.assert_allclose(lp[f].detach().numpy(), lp1.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        for (name, p_f), p in zip(net_f.named_parameters(), net.parameters()):
            np.testing.assert_allclose(p_f.grad[f].numpy(), p.grad.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"fold {f} {name}")


def _orders(engine, folds, epochs, seed=1):
    """`epochs` epochs of each fold's training graphs, shuffled."""
    rng = np.random.default_rng(seed)
    return [[tr[rng.permutation(len(tr))] for tr, _ in folds] for _ in range(epochs)]


def test_lockstep_epochs_match_jax_make_multi_vmap_run():
    """Same weights, same orders, dropout 0, ragged folds: the port's multi
    lockstep runner (as `lockstep_chunk` builds it) against JAX's
    `make_multi_vmap_run` given each class's [k, steps, F, S_c] slice of
    the orders, 2 epochs: losses within rtol 1e-5, correct counts equal."""
    gs, engine = _collab(), _engine()
    folds = _ragged_folds()
    jm, tm, keys, jp_f, params_f = _models(gs, 0.0)
    net_f = DGCNNFoldsNet(tm, params_f)
    gens = [torch.Generator().manual_seed(f) for f in range(F)]
    test_ids = [te for _, te in folds]
    runner, orders = cv_vmap.lockstep_chunk(engine, net_f, FoldAdam(net_f), gens,
                                            _orders(engine, folds, 2), test_ids)
    slots = engine.runners.key
    rows = runner.run_epochs(orders)
    bounds = np.cumsum((0,) + slots)

    def per_class(order):
        return tuple(jnp.asarray(order[..., a:b]) for a, b in zip(bounds[:-1], bounds[1:]))

    jdata = tuple(jax.tree_util.tree_map(jnp.asarray, c) for c in jmd.build_multi_dense(
        jax_synth("COLLAB", num_graphs=40, seed=3), engine.tiles)[0])
    t_steps = max(-(-len(te) // BATCH) for te in test_ids)
    test3d = cv_vmap.stack_folds([engine.epoch_order(te, slots) for te in test_ids],
                                 t_steps)
    opt = optax.adam(1e-3)
    jrows = make_multi_vmap_run(jm, opt)(
        jp_f, jax.vmap(opt.init)(jp_f), keys, jdata, per_class(orders),
        per_class(test3d))[3]
    jrows = np.asarray(jrows, np.float64)
    assert rows.shape == jrows.shape == (2, F, 4)
    np.testing.assert_allclose(rows[..., :2], jrows[..., :2], rtol=1e-5)
    np.testing.assert_array_equal(rows[..., 2:], jrows[..., 2:])


def _cv_cfg(root, sub, **kw):
    base = dict(FIELDS, num_folds=3, num_epochs=2, max_fused_epochs=1, layout="multi",
                data_root=str(root / "data"), statistics_dir=str(root / sub / "statistics"),
                epochs_dir=str(root / sub / "epochs"), **SMALL)
    return Config(**{**base, **kw})


def test_multi_lockstep_matches_sequential_driver(tmp_path, capsys):
    """`cv_parallel="folds"` against "sequential" on the same 40 graphs (3
    folds, four tile classes, dropout 0.5): every fold's CSV rows within
    rtol/atol 5e-4, the same accuracies; every lockstep epoch event
    carries `folds_in_lockstep`, `run_start` the tiles and slot floors;
    under "auto" on one device the folds run one after another."""
    gs = _collab()
    cfgs = {mode: _cv_cfg(tmp_path, mode, cv_parallel=mode)
            for mode in ("sequential", "folds", "auto")}
    res = {m: cv.run_cross_validation(c, dataset=gs, device="cpu") for m, c in cfgs.items()}
    assert "not ported" not in capsys.readouterr().out
    assert res["folds"]["test_accuracies"] == res["sequential"]["test_accuracies"]
    for fold in (1, 2, 3):
        a, b = (np.loadtxt(f"{cfgs[m].statistics_dir}/COLLAB_results_{fold}.csv",
                           delimiter=",", skiprows=1) for m in ("sequential", "folds"))
        assert a.shape == b.shape == (2, 5)
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4, err_msg=f"fold {fold}")
    for mode, lockstep in (("folds", True), ("auto", False)):
        with open(f"{cfgs[mode].statistics_dir}/COLLAB_events.jsonl") as fh:
            events = [json.loads(ln) for ln in fh]
        assert events[0]["layout"] == "multi" and events[0]["tiles"] == [32, 64, 128, 208]
        assert len(events[0]["slot_floors"]) == 4
        epochs = [e for e in events if e["kind"] == "epoch"]
        assert len(epochs) == 6
        assert all(("folds_in_lockstep" in e) == lockstep for e in epochs), mode
    assert not cv.lockstep_engages(cfgs["auto"], gs, "multi")
    assert cv.lockstep_engages(cfgs["folds"], gs, "multi")


def test_multi_lockstep_dropout_masks_are_the_sequential_bits(monkeypatch):
    """Over one epoch of ragged folds, each fold's dropout masks in multi
    lockstep are bitwise the sequential epoch's for that fold, step by
    step ([ΣS_c, dense] a step), and its generator ends in the same state."""
    seen = []
    inner = port_model._pooled_to_log_probs

    def record(params, model, pooled, deterministic, gen, acts):
        out = inner(params, model, pooled, deterministic, gen, acts)
        if not deterministic:
            seen.append(acts["dropout_keep"])
        return out

    monkeypatch.setattr(port_model, "_pooled_to_log_probs", record)
    gs, engine = _collab(), _engine()
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    folds = _ragged_folds()
    per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
    net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
    gens = [torch.Generator().manual_seed(7 + f) for f in range(F)]
    ids = _orders(engine, folds, 1)
    runner, orders = cv_vmap.lockstep_chunk(engine, net_f, FoldAdam(net_f), gens, ids,
                                            [te for _, te in folds])
    slots = engine.runners.key
    runner.run_epochs(orders)
    lock, seen[:] = list(seen), []
    bounds = np.cumsum((0,) + slots)

    def batch_fn(row):
        return MultiDenseBatch(tuple(gather_dense_batch(d, row[a:b]) for d, a, b in
                                     zip(engine.classes, bounds[:-1], bounds[1:])))

    for f in range(F):
        net = DGCNNNet(tm, per_fold[f])
        gen = torch.Generator().manual_seed(7 + f)
        own = torch.from_numpy(engine.epoch_order(ids[0][f], slots))
        epoch_rows(net, make_optimizer(net), batch_fn, own,
                   torch.from_numpy(engine.epoch_order(folds[f][1], slots)), gen)
        assert len(seen) == len(own) <= len(lock)
        for s, mask in enumerate(seen):
            assert torch.equal(lock[s][f], mask), f"fold {f} step {s}"
        assert torch.equal(gens[f].get_state(), gen.get_state()), f"fold {f}"
        seen.clear()


def test_a_grown_slot_tuple_gets_one_new_lockstep_runner(monkeypatch):
    """On a stand-in card, from floors of 4: two chunks share one runner
    (one capture, then replays, the body making no host sync); a chunk
    whose batch crowds one class grows the slot tuple there and only
    there, drops the runner with its graph and captures once more; the
    run's `end_fold` drops the runner."""
    made = _wrap_lockstep_runners(monkeypatch)
    gs, engine = _collab(), _engine()
    engine.slot_floor[:] = 4
    folds = _ragged_folds()
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    net_f = DGCNNFoldsNet(tm, stack_params(
        [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]))
    adam_f = FoldAdam(net_f)
    gens = [torch.Generator().manual_seed(f) for f in range(F)]
    test_ids = [te for _, te in folds]
    cls = engine.routing.class_of
    crowd = [tr[np.argsort(cls[tr] != np.bincount(cls[tr]).argmax(), kind="stable")]
             for tr, _ in folds]  # the most common class first: 8 in batch 1
    keys = []
    for ids_k in ([[tr for tr, _ in folds]] * 2, [[tr for tr, _ in folds]], [crowd]):
        runner, orders = cv_vmap.lockstep_chunk(engine, net_f, adam_f, gens, ids_k,
                                                test_ids)
        keys.append(engine.runners.key)
        rows = runner.run_epochs(orders)
        assert np.isfinite(rows).all()
        if len(keys) == 1:
            runner.order.copy_(torch.from_numpy(orders[0]))
            with _NoHostSync():
                runner.body()
    assert keys[0] == keys[1] != keys[2]
    assert all(b >= a for a, b in zip(keys[1], keys[2])) and 8 in keys[2]
    assert len(made) == 2 and [g.replays for g in made] == [2, 0]
    gone = weakref.ref(made[0])
    made.pop(0)
    del runner
    assert gone() is None
    engine.end_fold()
    assert engine.runners.runner is None


def test_fold_forward_refuses_a_batch_of_another_fold_count():
    """A `MultiDenseBatch` of another fold count than the weights' is
    refused by the fold-stacked forward."""
    gs, engine = _collab(), _engine()
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes, **SMALL)
    net_f = DGCNNFoldsNet(tm, stack_params(
        [init_params(torch.Generator().manual_seed(f), tm) for f in range(2)]))
    tb = _step(engine)[0]
    with pytest.raises(ValueError, match="3 folds"):
        net_f(tb)
