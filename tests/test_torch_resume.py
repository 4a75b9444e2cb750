"""In-flight checkpoints and `--resume` on the CPU: a run crashed at a
chunk boundary and resumed writes the uninterrupted run's fold CSVs byte
for byte and its `epochs/` bundles bit for bit, on every ported layout
(the port of tests/test_resume.py); the complete-run fast path, the
demotion of a partly complete auto-lockstep run, the refusal past
`num_epochs`, the chunks cut at the checkpoint cadence, the engine floors
a resumed fold starts from; `--opt_flatten` against per-leaf Adam; the
bundle loader (utils/checkpoint.py `load_into`)."""

import json
import os

import numpy as np
import pytest
import torch

import dgcnn_tpu_torch.train.cv as cv
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNFoldsNet, DGCNNNet, init_params, stack_params
from dgcnn_tpu_torch.train.loop import FlatAdam, FoldAdam, make_optimizer
from dgcnn_tpu_torch.utils.checkpoint import (
    _flatten, adam_state, load_checkpoint, load_into, save_checkpoint,
)
import torch_threads  # noqa: F401  (torch on one CPU thread)

GS = synthesize_tu_dataset("MUTAG", num_graphs=40, seed=5)


@pytest.fixture(autouse=True)
def _no_curves(monkeypatch):
    """The run tail's curve PNG costs ~0.5 s a run and is tested in
    test_torch_run_tail.py; these runs skip drawing it."""
    from dgcnn_tpu_torch.train import plots

    monkeypatch.setattr(plots, "render_curves", lambda *a, **k: "")


def _cfg(tmp_path, tag, **kw):
    base = dict(data_type="MUTAG", batch_size=16, num_epochs=4, num_folds=2,
                max_fused_epochs=2, checkpoint_every=2,
                data_root=str(tmp_path / "data"),
                epochs_dir=str(tmp_path / tag / "epochs"),
                statistics_dir=str(tmp_path / tag / "statistics"))
    return Config(**{**base, **kw})


class _Crash(RuntimeError):
    pass


def _crash_at(monkeypatch, epoch, fold=None):
    """Make the event log raise at the `epoch` event (of `fold`): events
    are written before the chunk's in-flight bundle, so the last bundle
    on disk is the previous chunk boundary's."""
    orig = cv.EventLog.write

    def exploding_write(self, **event):
        if event.get("kind") == "epoch" and event["epoch"] == epoch and (
                fold is None or event["fold"] == fold):
            raise _Crash()
        return orig(self, **event)

    monkeypatch.setattr(cv.EventLog, "write", exploding_write)
    return lambda: monkeypatch.setattr(cv.EventLog, "write", orig)


def _run(cfg, gs=GS):
    return cv.run_cross_validation(cfg, dataset=gs, device="cpu")


def _csvs(cfg):
    return [open(cv.fold_csv(cfg, f)).read() for f in range(1, cfg.num_folds + 1)]


def _bundles(cfg):
    return [dict(_flatten(load_checkpoint(cv.fold_bundle(cfg, f))))
            for f in range(1, cfg.num_folds + 1)]


def _assert_same_run(got, want):
    assert _csvs(got) == _csvs(want)
    for a, b in zip(_bundles(got), _bundles(want)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CASES = {
    "dense-sequential": dict(layout="dense", cv_parallel="sequential"),
    "dense-lockstep": dict(layout="dense"),
    "dense-lockstep-opt_flatten": dict(layout="dense", opt_flatten=True),
    "block-lockstep-pallas": dict(layout="block", block_impl="pallas"),
    "block-lockstep-xla": dict(layout="block", block_impl="xla"),
    "coo-sequential": dict(layout="coo", node_pad_multiple=64, edge_pad_multiple=128),
    "multi-sequential": dict(layout="multi", multi_dense_min_tile=16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_crashed_and_resumed_run_is_the_uninterrupted_run(tmp_path, monkeypatch, capsys,
                                                          case):
    kw = CASES[case]
    full = _cfg(tmp_path, "full", **kw)
    _run(full)
    lockstep = "lockstep" in case
    crash = _cfg(tmp_path, "crash", **kw)
    restore = _crash_at(monkeypatch, 3, fold=None if lockstep else 1)
    with pytest.raises(_Crash):
        _run(crash)
    restore()
    inflight = os.path.join(crash.epochs_dir,
                            "MUTAG_lockstep_inflight" if lockstep else "MUTAG_1_inflight")
    assert os.path.exists(inflight + ".npz")
    assert int(load_checkpoint(inflight)["epoch"]) == 2
    capsys.readouterr()
    _run(_cfg(tmp_path, "crash", checkpoint_resume=True, **kw))
    out = capsys.readouterr().out
    assert ("[all folds] resumed at epoch 3 (lockstep)" if lockstep
            else "[fold 1] resumed at epoch 3") in out
    _assert_same_run(crash, full)
    if kw.get("opt_flatten"):  # vector-shaped moments in every bundle
        assert [np.shape(v) for v in load_checkpoint(cv.fold_bundle(crash, 1))[
            "opt_state"]["exp_avg"].values()] == [(52035,)]
    assert not os.path.exists(inflight + ".npz")
    assert sorted(os.listdir(crash.epochs_dir)) == sorted(
        f"MUTAG_{f}{s}" for f in (1, 2) for s in (".npz", ".treedef.json"))


@pytest.mark.parametrize("crash", ["mid-fold", "fresh-fold"])
def test_resumed_fold_starts_from_the_uninterrupted_runs_floors(tmp_path, monkeypatch,
                                                                crash):
    """The engine's grow-only floors travel with a resume. Fold 1's first
    chunk grows the multi-tile engine's first slot floor (a patch active
    in the first two runs only), beyond what the later chunks need; the
    slot tuple sets the dropout draws (one a slot), so a chunk run at
    another tuple makes other bits. Mid-fold (crashed in fold 1 at epoch
    3), the in-flight bundle carries the floors; a fold begun fresh after
    a resume (crashed in fold 2 at epoch 1, no in-flight bundle of its
    own) starts from `epochs/<DS>_floors`, the floors after fold 1."""
    kw = CASES["multi-sequential"]
    real = cv.MultiDenseEngine.slots_for
    grow, keys = [True], []

    def slots_for(self, *seqs):
        if grow[0] and getattr(self, "_fold", 0) == 1 and self.slot_floor[0] < 16:
            self.slot_floor = self.slot_floor.copy()
            self.slot_floor[0] = 16
        out = real(self, *seqs)
        keys.append((getattr(self, "_fold", 0), out))
        return out

    monkeypatch.setattr(cv.MultiDenseEngine, "slots_for", slots_for)
    full = _cfg(tmp_path, "full", **kw)
    _run(full)
    want = [k for f, k in keys if f][-3 if crash == "mid-fold" else -2:]
    assert all(k[0] == 16 for k in want)
    broken = _cfg(tmp_path, "crash", **kw)
    restore = _crash_at(monkeypatch, *((3, 1) if crash == "mid-fold" else (1, 2)))
    with pytest.raises(_Crash):
        _run(broken)
    restore()
    grow[0] = False
    keys.clear()
    _run(_cfg(tmp_path, "crash", checkpoint_resume=True, **kw))
    assert [k for f, k in keys if f] == want
    _assert_same_run(broken, full)
    assert not os.path.exists(os.path.join(broken.epochs_dir, "MUTAG_floors.npz"))


@pytest.mark.parametrize("layout", ["block", "coo", "multi"])
def test_rows_do_not_depend_on_block_and_coo_floors(tmp_path, layout):
    """What a budget changes on the CPU: one fold at the engine's initial
    floors and at grown ones. The block and COO budgets only pad (their
    rows are the same bits); the multi-tile slot tuple also sets the
    dropout draws (other bits), so its floors must travel with a resume."""
    kw = {**CASES[{"block": "block-lockstep-pallas", "coo": "coo-sequential",
                   "multi": "multi-sequential"}[layout]], "num_epochs": 2}
    grown = {"block": {"floor_nb": 32, "floor_w": 256},
             "coo": {"floor_nodes": 1024, "floor_edges": 4096},
             "multi": {"slot_floor": np.array([16, 16])}}[layout]
    rows = []
    for floors in ({}, grown):
        cfg = _cfg(tmp_path, str(len(rows)), **kw)
        train, test = cv.get_folds(GS.y, "", 2, cfg.seed, data_type="MUTAG")[0]
        engine = cv.make_engine(cfg, GS, torch.device("cpu"), layout)
        for name, v in floors.items():
            assert np.all(v >= getattr(engine, name)) and np.any(v > getattr(engine, name))
            setattr(engine, name, v)
        model = cv._model_from_config(cfg, GS.num_features, GS.num_classes)
        m = cv.run_fold(cfg, GS, model, 1, train, test, engine, cv.EventLog(None))
        rows.append(np.array([m.rows[c] for c in m.COLUMNS]))
    assert np.array_equal(rows[0], rows[1]) == (layout != "multi")


def test_complete_run_resumes_as_complete(tmp_path, capsys):
    """The lockstep fast path: every fold's CSV is complete, so nothing
    trains and no artifact is rewritten."""
    cfg = _cfg(tmp_path, "run", layout="dense")
    _run(cfg)
    before = {p: os.stat(os.path.join(d, p)).st_mtime_ns
              for d in (cfg.epochs_dir, cfg.statistics_dir) for p in os.listdir(d)
              if not p.endswith((".jsonl", "overall.csv", ".png"))}
    capsys.readouterr()
    res = _run(_cfg(tmp_path, "run", layout="dense", checkpoint_resume=True))
    out = capsys.readouterr().out
    assert out.count("resumed (complete)") == 2 and "Train Acc" not in out
    assert res["test_accuracies"] == [float(c.splitlines()[-1].split(",")[4])
                                      for c in _csvs(cfg)]
    after = {p: os.stat(os.path.join(d, p)).st_mtime_ns
             for d in (cfg.epochs_dir, cfg.statistics_dir) for p in before
             if os.path.exists(os.path.join(d, p))}
    assert after == before


@pytest.mark.parametrize("cv_parallel", ["auto", "folds"])
def test_partly_complete_auto_lockstep_run_is_demoted(tmp_path, monkeypatch, capsys,
                                                      cv_parallel):
    """A sequential run crashed in fold 2 (fold 1 complete), resumed where
    `auto` would lockstep the dense folds: only fold 2 runs, on the
    sequential driver from its in-flight bundle, fold 1's CSV and bundle
    stay byte for byte as they were, and the result is the uninterrupted
    sequential run's. `cv_parallel="folds"` keeps lockstep: every fold
    retrains."""
    seq = dict(layout="dense", cv_parallel="sequential")
    full = _cfg(tmp_path, "full", **seq)
    _run(full)
    crash = _cfg(tmp_path, "crash", **seq)
    restore = _crash_at(monkeypatch, 3, fold=2)
    with pytest.raises(_Crash):
        _run(crash)
    restore()
    fold1 = [open(p, "rb").read() for p in (cv.fold_csv(crash, 1),
                                            cv.fold_bundle(crash, 1) + ".npz")]
    capsys.readouterr()
    _run(_cfg(tmp_path, "crash", layout="dense", cv_parallel=cv_parallel,
              checkpoint_resume=True))
    out = capsys.readouterr().out
    if cv_parallel == "auto":
        assert "redoing only the incomplete folds sequentially" in out
        assert "[fold 1] resumed (complete)" in out and "[fold 2] resumed at epoch 3" in out
        assert [open(p, "rb").read() for p in (cv.fold_csv(crash, 1),
                                               cv.fold_bundle(crash, 1) + ".npz")] == fold1
        _assert_same_run(crash, full)
    else:
        assert "resumed" not in out
        lock = _cfg(tmp_path, "lock", layout="dense", cv_parallel="folds")
        _run(lock)
        assert _csvs(crash) == _csvs(lock)


@pytest.mark.parametrize("lockstep", [False, True], ids=["sequential", "lockstep"])
def test_resume_past_num_epochs_refuses(tmp_path, monkeypatch, lockstep):
    kw = dict(layout="dense", cv_parallel="auto" if lockstep else "sequential")
    restore = _crash_at(monkeypatch, 3)
    with pytest.raises(_Crash):
        _run(_cfg(tmp_path, "run", **kw))
    restore()
    with pytest.raises(ValueError, match="beyond --num_epochs=1"):
        _run(_cfg(tmp_path, "run", num_epochs=1, checkpoint_resume=True, **kw))


@pytest.mark.parametrize("lockstep", [False, True], ids=["sequential", "lockstep"])
def test_chunks_are_cut_at_the_checkpoint_cadence(tmp_path, monkeypatch, lockstep):
    """max_fused_epochs 4, checkpoint_every 3, 5 epochs: chunks of 3 and 2
    epochs (`chunk_epochs` ≤ the cadence in every event), the in-flight
    bundle written after epoch 3."""
    cfg = _cfg(tmp_path, "run", layout="dense", num_epochs=5, max_fused_epochs=4,
               checkpoint_every=3, cv_parallel="auto" if lockstep else "sequential")
    restore = _crash_at(monkeypatch, 5, fold=1)
    with pytest.raises(_Crash):
        _run(cfg)
    restore()
    with open(os.path.join(cfg.statistics_dir, "MUTAG_events.jsonl")) as f:
        events = [e for e in map(json.loads, f) if e["kind"] == "epoch"]
    assert [e["chunk_epochs"] for e in events if e["fold"] == 1] == [3, 3, 3, 2]
    inflight = os.path.join(cfg.epochs_dir, "MUTAG_lockstep_inflight" if lockstep
                            else "MUTAG_1_inflight")
    bundle = load_checkpoint(inflight)
    assert int(bundle["epoch"]) == 3
    assert set(bundle) == ({"params_f", "opt_f", "rng_f", "epoch", "metrics"} if lockstep
                           else {"params", "opt_state", "rng", "epoch", "metrics"})
    rows = np.asarray(bundle["metrics"]["test_loss"])
    assert rows.shape == ((2, 3) if lockstep else (3,))


@pytest.mark.parametrize("layout", ["dense", "coo"])
def test_opt_flatten_rows_are_the_per_leaf_rows(tmp_path, layout):
    """`--opt_flatten` (`FlatAdam`, one update over the raveled vector):
    every fold's rows and parameters bitwise the per-leaf Adam's, its
    bundles' moments vector-shaped."""
    kw = dict(layout=layout, cv_parallel="sequential", checkpoint_every=0,
              node_pad_multiple=64, edge_pad_multiple=128)
    leaf, flat = _cfg(tmp_path, "leaf", **kw), _cfg(tmp_path, "flat", opt_flatten=True, **kw)
    _run(leaf)
    _run(flat)
    assert _csvs(flat) == _csvs(leaf)
    for f in (1, 2):
        a, b = (load_checkpoint(cv.fold_bundle(c, f)) for c in (leaf, flat))
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert [np.shape(v) for v in b["opt_state"]["exp_avg"].values()] == [(52035,)]
        assert len(a["opt_state"]["exp_avg"]) == 16


def test_a_resume_across_opt_flatten_fails_loudly(tmp_path, monkeypatch):
    restore = _crash_at(monkeypatch, 3)
    with pytest.raises(_Crash):
        _run(_cfg(tmp_path, "run", layout="dense", cv_parallel="sequential",
                  opt_flatten=True))
    restore()
    with pytest.raises(ValueError, match="opt_flatten"):
        _run(_cfg(tmp_path, "run", layout="dense", cv_parallel="sequential",
                  checkpoint_resume=True))


def _model():
    return DGCNN(num_features=GS.num_features, num_classes=GS.num_classes)


def test_flat_adam_steps_are_the_per_leaf_adam_bits():
    """The port's counterpart of
    tests/test_train.py::test_flat_adam_matches_per_leaf_adam."""
    model = _model()
    nets = [DGCNNNet(model, init_params(torch.Generator().manual_seed(1), model))
            for _ in range(2)]
    leaf, flat = make_optimizer(nets[0], lr=3e-3), make_optimizer(nets[1], lr=3e-3, flat=True)
    assert isinstance(flat, FlatAdam) and len(flat.param_groups[0]["params"]) == 1
    gen = torch.Generator().manual_seed(2)
    for _ in range(5):
        grads = [torch.randn(p.shape, generator=gen) for p in nets[0].parameters()]
        for net, opt in ((nets[0], leaf), (nets[1], flat)):
            opt.zero_grad()
            for p, g in zip(net.parameters(), grads):
                p.grad = g.clone()
            opt.step()
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    state = adam_state(flat)
    assert [t.shape for t in state["exp_avg"]] == [(52035,)]
    assert float(state["step"][0]) == 5


def test_load_into_copies_in_place_and_refuses_other_layouts(tmp_path):
    """A bundle goes back into the live tensors (the same storage, which a
    captured graph holds): a net's parameters, a fresh Adam's (its state
    created first), a `FoldAdam`'s buffers and a generator's state; a
    per-leaf Adam state does not load into a `FlatAdam`."""
    model = _model()
    src = DGCNNNet(model, init_params(torch.Generator().manual_seed(1), model))
    opt = make_optimizer(src)
    for p in src.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    gen = torch.Generator().manual_seed(7)
    torch.rand(5, generator=gen)
    params_f = stack_params([init_params(torch.Generator().manual_seed(s), model)
                             for s in (1, 2)])
    net_f = DGCNNFoldsNet(model, params_f)
    adam_f = FoldAdam(net_f)
    adam_f.steps.fill_(3.0)
    adam_f.exp_avg.normal_(generator=torch.Generator().manual_seed(4))
    path = str(tmp_path / "b")
    save_checkpoint(path, {"params": src.state_dict(), "opt_state": adam_state(opt),
                           "rng": gen.get_state(), "fold": adam_f.state_tensors()})
    bundle = load_checkpoint(path)

    dst = DGCNNNet(model, init_params(torch.Generator().manual_seed(9), model))
    ptrs = [p.data_ptr() for p in dst.parameters()]
    dst_opt = make_optimizer(dst)
    load_into(dst, bundle["params"])
    load_into(dst_opt, bundle["opt_state"])
    assert [p.data_ptr() for p in dst.parameters()] == ptrs
    for a, b in zip(src.parameters(), dst.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(src.parameters(), dst.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], dst_opt.state[q][key])
    g2 = torch.Generator().manual_seed(0)
    load_into(g2, bundle["rng"])
    assert torch.equal(torch.rand(3, generator=g2), torch.rand(3, generator=gen))
    net_g = DGCNNFoldsNet(model, params_f)
    adam_g = FoldAdam(net_g)
    ptr = adam_g.exp_avg.data_ptr()
    load_into(adam_g, bundle["fold"])
    assert adam_g.exp_avg.data_ptr() == ptr
    assert torch.equal(adam_g.exp_avg, adam_f.exp_avg) and torch.equal(adam_g.steps,
                                                                      adam_f.steps)
    with pytest.raises(ValueError, match="opt_flatten"):
        load_into(make_optimizer(dst, flat=True), bundle["opt_state"])
    with pytest.raises(ValueError, match="opt_flatten"):
        load_into(FoldAdam(net_g, flat_state=True), bundle["fold"])
