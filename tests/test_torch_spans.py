"""The program's span recorder (dgcnn_tpu_torch/train/metrics.py
`SpanRecorder`, `SPANS`) and its spans in the CV driver, the fused runner
and the mesh: nothing recorded and no profiler range opened while it is
off and no profiler runs, the spans as ranges under a profiler alone, a
fold switch's spans in order with their parents and chunk, the
runner's warm-up, capture and replays on a stand-in card, the spans as
`user_annotation` events on the profiler's clock, the host COO engine's
`pack_seconds` summed from its spans, and `gather_folds`' span on a
two-rank gloo grid."""

import contextlib

import numpy as np
import pytest
import torch

from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNNNet, init_params
from dgcnn_tpu_torch.train import cv, loop, metrics
from dgcnn_tpu_torch.train.metrics import NULL_SPAN, SPANS
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

SMALL = dict(hidden_dims=(8, 8, 1), conv1d_channels=(4, 8), dense_dim=16)
SWITCH = ["fold.end", "fold.begin", "engine.orders", "runner.build", "runner.stage"]


def _cfg(**kw):
    return Config(**{**dict(data_type="MUTAG", batch_size=8, num_epochs=4, seed=11,
                            num_folds=3, layout="dense", graph_pad_multiple=4, **SMALL),
                     **kw})


@pytest.fixture(scope="module")
def gs():
    return synthesize_tu_dataset("MUTAG", num_graphs=30, seed=4)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test leaves the process's one recorder off and empty."""
    yield
    SPANS.stop()
    assert not SPANS.on


def _fold(cfg, gs, f):
    """(train, test) ids of fold f of three."""
    ids = np.arange(gs.num_graphs)
    test = ids[f::3]
    return np.setdiff1d(ids, test), test


def _chunk(engine, cfg, gs, fold, k=2):
    """Begin `fold` on `engine` and run one chunk of k epochs."""
    model = cv._model_from_config(cfg, gs.num_features, gs.num_classes)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(fold), model, "cpu"))
    opt = loop.make_optimizer(net)
    train, test = _fold(cfg, gs, fold)
    engine.begin_fold(train, test)
    rng = np.random.default_rng(fold)
    return engine.run_epochs(net, opt, torch.Generator().manual_seed(fold),
                             np.stack([rng.permutation(len(train)) for _ in range(k)]))


def _switch(engine, cfg, gs):
    """Fold 0's chunk, then the switch into fold 1 and its chunk."""
    _chunk(engine, cfg, gs, 0)
    engine.end_fold()
    return _chunk(engine, cfg, gs, 1)


def _annotations(prof):
    """(name, start_ns) of the profiler's host user annotations."""
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
            if e.activity_type() == "user_annotation"]


def test_off_the_recorder_records_nothing_and_opens_no_range(gs, monkeypatch):
    """Off, with no profiler running, a span site gets the null span: a
    fold switch on the dense engine records nothing, opens no profiler
    range and reads no clock."""

    class NoClock:
        @staticmethod
        def time_ns():
            raise AssertionError("a span read the clock with the recorder off")

    record_function = torch.autograd.profiler.record_function

    def no_range(name, *args):
        assert name not in {"engine.build", "engine.orders", *SWITCH}, \
            f"{name} opened a profiler range with no profiler running"
        return record_function(name, *args)  # torch's own ranges (the optimizer's)

    cfg = _cfg()
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "dense")
    monkeypatch.setattr(metrics, "time", NoClock)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_range)
    assert SPANS.span("runner.replay") is NULL_SPAN and not SPANS.on
    _switch(engine, cfg, gs)
    assert SPANS.records == [] and SPANS.stop() == []


def test_a_fold_switch_records_its_spans_in_order(gs):
    """On, the dense sequential engine's switch records fold.end →
    fold.begin → engine.orders → runner.build → runner.stage, all at the
    top level and of the chunk that follows fold 0's, each span's seq its
    count among its name's, and the chunks' orders with their epochs."""
    cfg = _cfg()
    SPANS.start()
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "dense")
    _switch(engine, cfg, gs)
    records = SPANS.stop()
    assert [r["name"] for r in records] == (["engine.build", "fold.begin", "engine.orders",
                                             "runner.build", "runner.stage"] + SWITCH)
    assert [r["id"] for r in records] == list(range(len(records)))
    assert all(r["parent"] is None and r["rank"] == 0 for r in records)
    switch = records[5:]
    assert {r["chunk"] for r in records[:5]} == {0} and {r["chunk"] for r in switch} == {1}
    assert [r["seq"] for r in switch] == [0, 1, 1, 1, 1]
    starts = [r["start_ns"] for r in records]
    assert starts == sorted(starts) and all(r["end_ns"] >= r["start_ns"] for r in records)
    assert records[0]["attrs"] == {"layout": "dense"}
    assert [r["attrs"] for r in records if r["name"] == "engine.orders"] == [
        {"epochs": 2}, {"epochs": 2}]
    assert records[8]["attrs"]["key"] == "2"  # the second fold's runner
    assert "allocated" not in records[5]["attrs"]  # no card: no allocator count


def test_spans_nest_and_the_host_coo_engine_sums_its_packing_from_them(gs):
    """The host COO engine packs the fold's test set in `begin_fold`: its
    `engine.orders` span (stage "pack") has `fold.begin` for parent, and
    `pack_seconds` is the sum of the pack spans' seconds, as with the
    recorder off it is the sum of their clock reads."""
    cfg = _cfg(layout="coo", spmm_impl="pallas")
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "coo")
    assert isinstance(engine, cv.CooEngine)
    _chunk(engine, cfg, gs, 0)
    off = dict(engine.pack_seconds)
    assert off["pack"] > 0 and off["blockcoo"] > 0
    SPANS.start()
    _chunk(engine, cfg, gs, 1)
    records = SPANS.stop()
    begin = next(r for r in records if r["name"] == "fold.begin")
    packs = [r for r in records if r["name"] == "engine.orders"]
    assert [p["attrs"].get("stage") for p in packs] == [
        "pack", "blockcoo", "pack", "blockcoo", "pack", "blockcoo", "pin"]
    assert [p["parent"] for p in packs[:2]] == [begin["id"]] * 2
    assert all(p["parent"] is None for p in packs[2:])
    for stage in ("pack", "blockcoo"):
        spans = sum(p["end_ns"] - p["start_ns"] for p in packs
                    if p["attrs"].get("stage") == stage) / 1e9
        assert engine.pack_seconds[stage] - off[stage] == pytest.approx(spans, abs=1e-9)


@contextlib.contextmanager
def _stand_in_card(monkeypatch):
    """Every `FusedRun` graphed on the CPU, its own warm-up and capture
    run: the capture runs the body eagerly and a replay runs nothing (the
    spans, not the rows, are under test here). Yields the graphs made."""
    made = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    def new_graph():
        made.append(Graph())
        return made[-1]

    init = loop.FusedRun.__init__

    def graphed(self, *a, **k):
        init(self, *a, **k)
        self.graphs, self.stream = True, Stream()

    monkeypatch.setattr(loop.FusedRun, "__init__", graphed)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", new_graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    yield made


def test_a_runner_records_its_warm_up_capture_and_replays(gs, monkeypatch):
    """On a stand-in card a runner's first chunk records runner.stage,
    runner.warmup, runner.capture and one runner.replay an epoch after the
    first, all of one chunk; the next chunk's stage and replays take the
    next chunk's id. The runner's `warmup_seconds` and `capture_seconds`
    are its spans' seconds."""
    cfg = _cfg()
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "dense")
    with _stand_in_card(monkeypatch) as made:
        train, test = _fold(cfg, gs, 0)
        model = cv._model_from_config(cfg, gs.num_features, gs.num_classes)
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model, "cpu"))
        opt, gen = loop.make_optimizer(net), torch.Generator().manual_seed(0)
        engine.begin_fold(train, test)

        def perms(k):
            return np.stack([np.random.default_rng(k + j).permutation(len(train))
                             for j in range(k)])

        SPANS.start()
        engine.run_epochs(net, opt, gen, perms(3))
        engine.run_epochs(net, opt, gen, perms(2))
        records = SPANS.stop()
    assert len(made) == 1
    names = [(r["name"], r["chunk"]) for r in records]
    assert names == [("engine.orders", 0), ("runner.build", 0), ("runner.stage", 0),
                     ("runner.warmup", 0), ("runner.capture", 0), ("runner.replay", 0),
                     ("runner.replay", 0), ("engine.orders", 1), ("runner.stage", 1),
                     ("runner.replay", 1), ("runner.replay", 1)]
    assert [r["seq"] for r in records if r["name"] == "runner.replay"] == [0, 1, 2, 3]
    runner = engine.runners.runner
    for name, seconds in (("runner.warmup", runner.warmup_seconds),
                          ("runner.capture", runner.capture_seconds)):
        (rec,) = [r for r in records if r["name"] == name]
        assert seconds == pytest.approx((rec["end_ns"] - rec["start_ns"]) / 1e9, abs=1e-9)
    assert all("device_ms" not in r["attrs"] for r in records)  # no card, no events


def test_the_run_loops_epoch_events_carry_warm_up_and_capture_seconds(gs, monkeypatch,
                                                                      tmp_path):
    """`run_fold`'s epoch events: `warmup_seconds` and `capture_seconds`
    on a chunk that built a runner (the runner's), null on the others."""
    import json

    cfg = _cfg(num_folds=2, num_epochs=3, max_fused_epochs=2, cv_parallel="sequential",
               statistics_dir=str(tmp_path / "statistics"),
               epochs_dir=str(tmp_path / "epochs"))
    with _stand_in_card(monkeypatch) as made:
        cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    assert len(made) == 2  # a runner a fold
    with open(tmp_path / "statistics" / "MUTAG_events.jsonl") as f:
        epochs = [e for e in map(json.loads, f) if e["kind"] == "epoch"]
    assert [e["runner_built"] for e in epochs] == [True, True, False] * 2
    for e in epochs:
        for key in ("warmup_seconds", "capture_seconds"):
            assert (e[key] is not None) == e["runner_built"], (key, e)


def test_spans_are_profiler_ranges_on_its_clock(gs):
    """With the recorder on under a CPU profiler, every span is a
    `user_annotation` of its name, opening within 1 ms of the recorder's
    stamp: the spans and the trace share one clock."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "dense")
    _chunk(engine, cfg, gs, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        SPANS.start()
        engine.end_fold()
        _chunk(engine, cfg, gs, 1)
        records = SPANS.stop()
    assert [r["name"] for r in records] == SWITCH
    ranges = sorted((a for a in _annotations(prof) if a[0] in SWITCH), key=lambda a: a[1])
    assert [n for n, _ in ranges] == SWITCH
    for rec, (_, start_ns) in zip(records, ranges):
        assert abs(rec["start_ns"] - start_ns) < 1e6, (rec["name"], rec["start_ns"] - start_ns)


def test_a_profiler_alone_names_the_spans_without_recording(gs):
    """A running profiler (the CLI's `--profile`, a traced benchmark
    stretch) turns the spans into profiler ranges with the recorder off,
    and nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "dense")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert not SPANS.on
        _switch(engine, cfg, gs)
    assert SPANS.records == [] and SPANS.span("runner.replay") is NULL_SPAN
    names = [n for n, _ in _annotations(prof)]
    assert names.count("fold.begin") == 2 and names.count("runner.stage") == 2
    assert names.count("fold.end") == 1 and names.count("runner.build") == 2


def test_a_span_that_raises_closes_and_tail_spans_take_the_last_chunk():
    """A span left by an exception is closed (the next span's parent is
    not it); a `tail` span takes the chunk that just ended; `timed` spans
    give seconds with the recorder on and off."""
    with SPANS.span("x", timed=True) as off:
        pass
    assert off.seconds is not None and off.seconds >= 0
    SPANS.start()
    with pytest.raises(ValueError), SPANS.span("a"):
        raise ValueError
    with SPANS.span("b") as b:
        with SPANS.span("c", timed=True) as c:
            c["n"] = 3
    SPANS.chunk_done()
    with SPANS.span("mesh.gather", tail=True):
        pass
    with SPANS.span("d"):
        pass
    records = SPANS.stop()
    assert [(r["name"], r["parent"], r["chunk"]) for r in records] == [
        ("a", None, 0), ("b", None, 0), ("c", 1, 0), ("mesh.gather", None, 0),
        ("d", None, 1)]
    assert records[2]["attrs"] == {"n": 3} and c.seconds <= b.seconds


def test_gather_folds_records_its_span_on_every_rank(tmp_path):
    """`gather_folds` on a two-rank gloo grid: each rank's rows reach both,
    and both record `mesh.gather` with matching seqs, each with the chunk
    it gathers and its rank; rank 1 arrives 0.2 s late each time, which
    the spans' starts show (a gloo broadcast blocks the host, so rank 0's
    span lasts until the late rank's arrival; nccl's would not)."""
    ranks = torch_mesh_worker.spawn(tmp_path, 2, [
        {"name": "g", "kind": "spans_gather", "delay": 0.2}])
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["g/rows"], [[[0, 0], [1, 1]]] * 2)
        assert res["g/seq"].tolist() == [0, 1] and res["g/chunk"].tolist() == [0, 1]
        assert res["g/rank"].tolist() == [r, r]
    late = ranks[1]["g/start_ns"] - ranks[0]["g/start_ns"]
    assert (late > 0.15e9).all()
    assert (ranks[0]["g/end_ns"] >= ranks[1]["g/start_ns"]).all()
