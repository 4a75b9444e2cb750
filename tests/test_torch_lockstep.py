"""Fold-lockstep on the dense layout (dgcnn_tpu_torch/train/cv_vmap.py):
the port's lockstep epochs against JAX's `make_dense_vmap_run` on shared
weights and orders, the fold-stacked forward against `apply_dense` fold
by fold, the fold-stacked Adam against `torch.optim.Adam`, the lockstep
driver against the port's sequential driver (ragged folds, dropout on,
masks bitwise), its checkpoints, and the `cv_parallel` dispatch."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgcnn_tpu.batching.dense import build_dense_dataset_on_device
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.cv_vmap import make_dense_vmap_run
from dgcnn_tpu_torch.batching.dense import (
    build_dense_dataset,
    dense_tile,
    gather_dense_batch,
)
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models import dgcnn as port_model
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNFoldsNet,
    DGCNNNet,
    apply_dense,
    init_params,
    leaves,
    stack_params,
)
from dgcnn_tpu_torch.parity.convert import fold_state, params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.cv_vmap import stacked_orders
from dgcnn_tpu_torch.train.loop import (
    FoldAdam,
    epoch_rows,
    make_dense_lockstep_run,
    make_optimizer,
    nll_loss_and_correct,
)
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint
import torch_threads  # noqa: F401  (torch on one CPU thread)

F, BATCH, SLOTS = 3, 8, 8


def _ragged_folds(n=37):
    """Three folds whose train AND test step counts differ at batch 8:
    test 17/10/10 (3/2/2 steps), train 20/27/27 (3/4/4 steps)."""
    perm = np.random.default_rng(0).permutation(n).astype(np.int32)
    tests = [perm[:17], perm[17:27], perm[27:]]
    return [(np.setdiff1d(perm, te).astype(np.int32), te) for te in tests]


def _orders(folds, epochs, seed=1):
    rng = np.random.default_rng(seed)
    train = [tr for tr, _ in folds]
    steps = max(-(-len(t) // BATCH) for t in train)
    t_steps = max(-(-len(te) // BATCH) for _, te in folds)
    order4d = np.stack([
        stacked_orders([t[rng.permutation(len(t))] for t in train], BATCH, SLOTS, steps)
        for _ in range(epochs)])
    test3d = stacked_orders([te for _, te in folds], BATCH, SLOTS, t_steps)
    return order4d, test3d


def test_lockstep_epochs_match_jax_make_dense_vmap_run():
    """(a) Same weights (carried by the converter), same orders, dropout 0,
    ragged folds: the epoch rows [k, F, 4] and the final per-fold
    parameters of the port's lockstep against JAX's lockstep runner.

    Parameters are held at rtol 1e-4 / atol 1e-6, all but at most one
    weight in 10,000 of each fold, and every weight within lr per step.
    Where a weight's gradients are about Adam's eps = 1e-8 (a lin1 row of
    a readout feature that is a relu of a near-cancelled sum, active on
    one graph), its update lr·m̂/(√v̂ + eps) follows the last bits of that
    sum, which the two frameworks round differently. On this data 2 of the
    156,105 weights miss the tight tolerance (≤ 6.5e-6 off); the port's
    sequential driver, run on the same batches, misses it on 4 (≤ 1.1e-5
    off)."""
    jgs = jax_synth("MUTAG", num_graphs=37, seed=5)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=37, seed=5)
    n_tile = dense_tile(gs)
    folds = _ragged_folds()
    order4d, test3d = _orders(folds, epochs=2)
    assert (order4d[0, -1, 0] == -1).all() and (test3d[-1, 1:] == -1).all()

    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0)
    keys = jnp.stack([jax.random.PRNGKey(10 + f) for f in range(F)])
    jp_f = jax.vmap(lambda k: jax_init(k, jm))(keys)
    lr, b2, eps = 1e-3, 0.999, 1e-8
    opt = optax.adam(lr, b2=b2, eps=eps)
    jp_out, jopt, _, jrows = make_dense_vmap_run(jm, opt)(
        jp_f, jax.vmap(opt.init)(jp_f), keys,
        build_dense_dataset_on_device(jgs, n_tile),
        jnp.asarray(order4d), jnp.asarray(test3d))
    jrows = np.asarray(jrows, np.float64)

    net_f = DGCNNFoldsNet(tm, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp_f))))
    adam_f = FoldAdam(net_f, lr=lr, b2=b2, eps=eps)
    data = build_dense_dataset(gs, n_tile, "cpu")
    gens = [torch.Generator().manual_seed(f) for f in range(F)]
    runner = make_dense_lockstep_run(net_f, adam_f, data, test3d,
                                     (order4d[0] >= 0).any(-1), gens)
    rows = np.concatenate([runner.run_epochs(order4d[j:j + 1])
                           for j in range(len(order4d))])
    assert rows.shape == jrows.shape == (2, F, 4)
    np.testing.assert_allclose(rows[..., :2], jrows[..., :2], rtol=1e-5)
    np.testing.assert_array_equal(rows[..., 2:], jrows[..., 2:])

    count = np.asarray(jopt[0].count)  # optax.adam = chain(scale_by_adam, scale)
    for f in range(F):
        t = int(count[f])
        assert t == ((order4d[:, :, f] >= 0).any(-1)).sum()  # its own steps only
        got = leaves(state_to_params(net_f.fold_state_dict(f)))
        want = [np.asarray(a[f]) for a in jax.tree_util.tree_leaves(jp_out)]
        misses = 0
        for a, b in zip(got, want):
            diff = np.abs(a.numpy() - b)
            misses += int((diff > 1e-6 + 1e-4 * np.abs(b)).sum())
            assert diff.max() <= lr * t
        assert misses <= sum(a.numel() for a in got) // 10_000, f"fold {f}: {misses}"


def test_fold_stacked_jax_state_converts_and_slices():
    """The reference's lockstep state (every leaf with a leading fold axis)
    carries into a `DGCNNFoldsNet`; each fold slices back out as the
    `DGCNNNet` state of that fold's own tree."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=12, seed=1)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    jp_f = jax.tree_util.tree_map(np.asarray, jax.vmap(lambda k: jax_init(k, jm))(
        jnp.stack([jax.random.PRNGKey(f) for f in range(F)])))
    state_f = params_from_jax(jp_f)
    net_f = DGCNNFoldsNet(tm, state_to_params(state_f))
    assert {k: v.shape for k, v in net_f.state_dict().items()} == {
        k: v.shape for k, v in state_f.items()}
    for f in range(F):
        want = params_from_jax(jax.tree_util.tree_map(lambda a: a[f], jp_f))
        for got in (net_f.fold_state_dict(f), fold_state(state_f, f)):
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], want[k]) for k in want)
        DGCNNNet(tm, state_to_params(want)).load_state_dict(net_f.fold_state_dict(f))
    # every parameter is a view of the flat buffer, in parameters() order
    off = 0
    for p in net_f.parameters():
        assert p.data_ptr() == net_f.flat.data_ptr() + 4 * off
        off += p.numel()
    assert off == net_f.flat.numel()


def test_fold_forward_and_gradients_equal_apply_dense_per_fold():
    """(b) `apply_dense_folds` on F folds' stacked batch (one fold padded
    to all −1, so it draws no dropout) against `apply_dense` fold by fold:
    log-probs and every gradient per fold within rtol 1e-5, dropout masks
    bitwise, the same draws from each fold's generator."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=9)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    data = build_dense_dataset(gs, dense_tile(gs), "cpu")
    per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
    rows = torch.from_numpy(np.random.default_rng(3).permutation(40)[:F * SLOTS]
                            .reshape(F, SLOTS).astype(np.int32))
    rows[0, 6:] = -1
    rows[2] = -1  # a fold with no real graph in this step
    net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
    gens = [torch.Generator().manual_seed(100 + f) for f in range(F)]
    gens[2] = None
    batch = gather_dense_batch(data, rows.reshape(-1))
    lp, acts = net_f(batch, deterministic=False, dropout_gens=gens,
                     return_activations=True)
    loss_f, _ = nll_loss_and_correct(lp, batch.y.view(F, -1),
                                     batch.graph_mask.view(F, -1))
    loss_f.sum().backward()
    for f in range(2):
        net = DGCNNNet(tm, per_fold[f])
        gen = torch.Generator().manual_seed(100 + f)
        b = gather_dense_batch(data, rows[f])
        lp1, acts1 = apply_dense(net.params(), tm, b, deterministic=False,
                                 dropout_gen=gen, return_activations=True)
        nll_loss_and_correct(lp1, b.y, b.graph_mask)[0].backward()
        assert torch.equal(acts["dropout_keep"][f], acts1["dropout_keep"])
        assert torch.equal(gens[f].get_state(), gen.get_state())
        np.testing.assert_allclose(lp[f].detach().numpy(), lp1.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
        for (name, p_f), p in zip(net_f.named_parameters(), net.parameters()):
            np.testing.assert_allclose(p_f.grad[f].numpy(), p.grad.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"fold {f} {name}")
    assert all(float(p.grad[2].abs().max()) == 0.0 for p in net_f.parameters())


def test_fold_adam_matches_torch_adam_on_each_folds_real_steps():
    """(c) `FoldAdam` with fold 1 masked on steps 1 and 3 against
    `torch.optim.Adam` run per fold on its real steps only: same
    parameters, moments and step counts. The bias corrections are taken
    in float64 as torch's Adam takes them on the host, and the update
    follows its order of operations, so the two agree to a few ulp."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=8, seed=1)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
    net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
    adam_f = FoldAdam(net_f, lr=3e-3)
    nets = [DGCNNNet(tm, p) for p in per_fold]
    opts = [make_optimizer(n, lr=3e-3) for n in nets]
    rng = np.random.default_rng(0)
    real_steps = [[True] * 5, [True, False, True, False, True], [True] * 5]
    for step in range(5):
        real = [real_steps[f][step] for f in range(F)]
        for p_f, *ps in zip(net_f.parameters(), *[n.parameters() for n in nets]):
            g = torch.from_numpy(rng.standard_normal(p_f.shape).astype(np.float32))
            p_f.grad = g.clone()
            for f, p in enumerate(ps):
                p.grad = g[f].clone()
        adam_f.step(torch.tensor(real))
        for f in range(F):
            if real[f]:
                opts[f].step()
    for f in range(F):
        state = adam_f.fold_state(f)
        assert [float(s) for s in state["step"]] == [float(sum(real_steps[f]))] * len(
            state["step"])
        for i, p in enumerate(nets[f].parameters()):
            st = opts[f].state[p]
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(state[key][i].numpy(), st[key].numpy(),
                                           rtol=1e-6, atol=1e-12)
        for (name, a), b in zip(net_f.fold_state_dict(f).items(),
                                nets[f].state_dict().values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=f"fold {f} {name}")


def _cv_cfg(root, sub, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=3, seed=324,
                num_folds=3, layout="dense", graph_pad_multiple=4,
                data_root=str(root / "data"),
                epochs_dir=str(root / sub / "epochs"),
                statistics_dir=str(root / sub / "statistics"))
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def seq_and_lockstep(tmp_path_factory):
    """The port's sequential and lockstep drivers on the same 73 graphs:
    3 folds, batch 16, train 48/49/49 graphs → 3 vs 4 steps, dropout 0.5."""
    root = tmp_path_factory.mktemp("cv")
    gs = synthesize_tu_dataset("MUTAG", num_graphs=73, seed=9)
    res = {
        mode: cv.run_cross_validation(_cv_cfg(root, mode, cv_parallel=mode),
                                      dataset=gs, device="cpu")
        for mode in ("sequential", "folds")
    }
    return root, gs, res


def test_lockstep_matches_sequential_driver(seq_and_lockstep):
    """(d) Every fold's CSV row within rtol/atol 5e-4 of the sequential
    driver's (the reference's own lockstep tolerance,
    tests/test_cv_vmap.py), ragged folds, dropout on; the events carry
    `folds_in_lockstep`, and `chunk_epochs` 3: the three epochs are one
    chunk under the default `max_fused_epochs` 25."""
    root, _, res = seq_and_lockstep
    assert res["folds"]["test_accuracies"] == res["sequential"]["test_accuracies"]
    for fold in (1, 2, 3):
        a = np.loadtxt(root / "sequential" / "statistics" / f"MUTAG_results_{fold}.csv",
                       delimiter=",", skiprows=1)
        b = np.loadtxt(root / "folds" / "statistics" / f"MUTAG_results_{fold}.csv",
                       delimiter=",", skiprows=1)
        assert a.shape == b.shape == (3, 5)
        np.testing.assert_allclose(b, a, rtol=5e-4, atol=5e-4, err_msg=f"fold {fold}")
    events = [json.loads(ln) for ln in (root / "folds" / "statistics" /
                                        "MUTAG_events.jsonl").read_text().splitlines()]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [(e["epoch"], e["fold"]) for e in epochs] == [
        (ep, f) for ep in (1, 2, 3) for f in (1, 2, 3)]
    assert all(e["folds_in_lockstep"] == 3 and e["chunk_epochs"] == 3 for e in epochs)


def test_lockstep_dropout_masks_are_the_sequential_bits(monkeypatch):
    """(d) Over one epoch of ragged folds, each fold's dropout masks in
    lockstep are bitwise the sequential driver's for that fold, step by
    step, and a fold draws nothing on its padded step (its generator ends
    in the sequential generator's state)."""
    seen = []
    inner = port_model._pooled_to_log_probs

    def record(params, model, pooled, deterministic, gen, acts):
        out = inner(params, model, pooled, deterministic, gen, acts)
        if not deterministic:
            seen.append(acts["dropout_keep"])
        return out

    monkeypatch.setattr(port_model, "_pooled_to_log_probs", record)
    gs = synthesize_tu_dataset("MUTAG", num_graphs=37, seed=5)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    data = build_dense_dataset(gs, dense_tile(gs), "cpu")
    fn = lambda r: gather_dense_batch(data, r)  # noqa: E731
    folds = _ragged_folds()
    order4d, test3d = _orders(folds, epochs=1)
    per_fold = [init_params(torch.Generator().manual_seed(f), tm) for f in range(F)]
    net_f = DGCNNFoldsNet(tm, stack_params(per_fold))
    gens = [torch.Generator().manual_seed(7 + f) for f in range(F)]
    make_dense_lockstep_run(net_f, FoldAdam(net_f), data, test3d,
                            (order4d[0] >= 0).any(-1), gens).run_epochs(order4d[:1])
    lock, seen[:] = list(seen), []
    for f in range(F):
        net = DGCNNNet(tm, per_fold[f])
        gen = torch.Generator().manual_seed(7 + f)
        own = order4d[0][:, f][(order4d[0][:, f] >= 0).any(-1)]
        own_test = test3d[:, f][(test3d[:, f] >= 0).any(-1)]
        epoch_rows(net, make_optimizer(net), fn, torch.from_numpy(own),
                   torch.from_numpy(own_test), gen)
        assert len(seen) == len(own)
        assert len(own) < len(lock) if f == 0 else len(own) == len(lock)
        for s, mask in enumerate(seen):
            assert torch.equal(lock[s][f], mask), f"fold {f} step {s}"
        assert torch.equal(gens[f].get_state(), gen.get_state()), f"fold {f}"
        seen.clear()


def test_lockstep_checkpoints_have_the_sequential_bundle(seq_and_lockstep):
    """(e) A lockstep fold's `epochs/` bundle has the sequential bundle's
    keys and shapes, and its Adam step count is the fold's own."""
    root, _, _ = seq_and_lockstep
    for fold in (1, 2, 3):
        seq = load_checkpoint(str(root / "sequential" / "epochs" / f"MUTAG_{fold}"))
        lock = load_checkpoint(str(root / "folds" / "epochs" / f"MUTAG_{fold}"))

        def shapes(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: v for key, sub in tree.items()
                        for k, v in shapes(sub, f"{prefix}/{key}").items()}
            return {prefix: np.shape(tree)}

        assert shapes(lock) == shapes(seq)
        np.testing.assert_array_equal(lock["opt_state"]["step"]["0"],
                                      seq["opt_state"]["step"]["0"])
        DGCNNNet(DGCNN(num_features=8, num_classes=2),
                 state_to_params({k: torch.from_numpy(v)
                                  for k, v in lock["params"].items()}))


@pytest.mark.parametrize("budget", [128 << 20, 1])
def test_auto_locksteps_exactly_when_the_reference_would(tmp_path, capsys, budget):
    """(f) Under `cv_parallel="auto"` the dense layout runs lockstep exactly
    when `_lockstep_would_engage` says so (the byte budget flips it); the
    "not ported yet" notice is gone."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=2)
    cfg = _cv_cfg(tmp_path, "a", num_epochs=1, lockstep_max_step_bytes=budget)
    engage = cv._lockstep_would_engage(cfg, gs, dense_tile(gs))
    assert engage == (budget > 1)
    cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    assert "not ported" not in capsys.readouterr().out
    events = [json.loads(ln) for ln in (tmp_path / "a" / "statistics" /
                                        "MUTAG_events.jsonl").read_text().splitlines()]
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert len(epochs) == 3
    assert all(("folds_in_lockstep" in e) == engage for e in epochs)


@pytest.mark.parametrize("layout, error, match", [
    ("block", None, None),
    ("multi", None, None),
    ("coo", ValueError, "incompatible with: layout='coo'"),
    ("halo", ValueError, "incompatible with: layout='halo'"),
])
def test_explicit_folds_on_other_layouts(tmp_path, layout, error, match):
    """(f) `cv_parallel="folds"` off the dense layout: block and multi (two
    tile classes) train all folds in lockstep, every epoch event carrying
    `folds_in_lockstep`; coo and halo raise the reference's ValueError."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=2)
    cfg = _cv_cfg(tmp_path, "x", cv_parallel="folds", layout=layout, num_epochs=1,
                  multi_dense_min_tile=16)
    if error is not None:
        with pytest.raises(error, match=match):
            cv.run_cross_validation(cfg, dataset=gs, device="cpu")
        return
    res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    assert len(res["test_accuracies"]) == 3
    events = [json.loads(ln) for ln in (tmp_path / "x" / "statistics" /
                                        "MUTAG_events.jsonl").read_text().splitlines()]
    assert events[0]["layout"] == layout
    epochs = [e for e in events if e["kind"] == "epoch"]
    assert [(e["epoch"], e["fold"]) for e in epochs] == [(1, f) for f in (1, 2, 3)]
    assert all(e["folds_in_lockstep"] == 3 and np.isfinite(e["train_loss"])
               for e in epochs)
