"""The port's user-facing tools (dgcnn_tpu_torch/tools/): the counterparts
of tests/test_tools.py's release report, TensorBoard export (and its
deduplication of replayed epochs), run diffing and release validation,
and the trace summary over the CLI's `--profile` trace. The report is
held against the reference's tools/release_report.py on the same input:
the same rows but for the steady-state median (and the speedup it
gives); the heading names the card."""

import ast
import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest

from dgcnn_tpu.train.tensorboard import export_events as jax_export
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.tools import (
    diff_runs,
    export_tensorboard,
    release_report,
    release_validation,
    summarize_trace,
)
from tools import release_report as jax_report
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _epoch(fold, epoch, seconds, k, **kw):
    return {"kind": "epoch", "fold": fold, "epoch": epoch, "epoch_seconds": seconds,
            "chunk_epochs": k, "train_loss": 0.5, "test_loss": 0.6,
            "train_accuracy": 90.0, "test_accuracy": 85.0, **kw}


def _release_root(tmp_path):
    """A written release run: MUTAG in lockstep (10 folds, 6 epochs in
    chunks of 2: the first chunk warms up), PROTEINS sequential (2 folds,
    each fold's first chunk warms up, fold 2's second chunk grew a budget)."""
    stats = tmp_path / "statistics"
    stats.mkdir()
    with open(tmp_path / "summary.jsonl", "w") as f:
        for ds, layout, cvp in (("MUTAG", "dense", "folds"),
                                ("PROTEINS", "dense", "sequential")):
            f.write(json.dumps({
                "dataset": ds, "dtype": "float32", "adj_dtype": "auto",
                "block_impl": "auto", "wall_s": 12.5, "test_acc_mean": 90.0,
                "test_acc_std": 2.0, "train_acc_mean": 95.0, "card": CARD,
                "device": "cuda", "layout": layout, "cv_parallel": cvp,
                "num_epochs": 6, "num_folds": 10, "launches": {}}) + "\n")
    with open(stats / "MUTAG_events.jsonl", "w") as f:
        f.write(json.dumps({"kind": "run_start", "layout": "dense"}) + "\n")
        for e in range(1, 7):
            for fold in range(1, 11):
                f.write(json.dumps(_epoch(
                    fold, e, 0.5 if e <= 2 else 0.004 + 0.001 * (e % 3), 2,
                    folds_in_lockstep=10, runner_built=e <= 2)) + "\n")
    with open(stats / "PROTEINS_events.jsonl", "w") as f:
        for fold in (1, 2):
            for e in range(1, 7):
                grown = fold == 2 and e in (3, 4)
                f.write(json.dumps(_epoch(
                    fold, e, 0.9 if e <= 2 or grown else 0.002 * e, 2,
                    runner_built=e <= 2 or grown)) + "\n")
    return tmp_path


def _rows(text):
    return {ln.split(" | ")[0].lstrip("| ").split(" (")[0]:
            [c.strip() for c in ln.strip("|\n").split("|")]
            for ln in text.splitlines() if ln.startswith("| ") and "---" not in ln
            and not ln.startswith("| dataset")}


def test_release_report_renders_the_references_rows_at_the_steady_median(tmp_path):
    root = _release_root(tmp_path)
    ours = release_report.render(str(root))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_report.main(str(root))
    theirs = _rows(buf.getvalue())
    mine = _rows(ours)
    assert set(mine) == set(theirs) == set(jax_report.REFERENCE)
    for ds in mine:  # every cell but the epoch median and the speedup it gives
        assert mine[ds][:1] + mine[ds][2:3] + mine[ds][4:] == \
            theirs[ds][:1] + theirs[ds][2:3] + theirs[ds][4:], ds
    # lockstep: 0.004-0.006 s over 10 folds, the two warm-up epochs' 20 rows out
    assert mine["MUTAG"][1] == "0.50 ms (20 rows left out)"
    assert theirs["MUTAG"][1] != mine["MUTAG"][1]
    # sequential: each fold's first chunk and fold 2's grown chunk left out
    assert mine["PROTEINS"][1] == "10.00 ms (6 rows left out)"
    assert mine["DD"][1] == "—"
    heading = ours.splitlines()[0]
    assert CARD in heading and "TPU" not in ours
    assert "MUTAG dense, folds; PROTEINS dense, sequential" in ours


def test_release_report_keeps_the_last_of_a_replayed_epoch(tmp_path):
    root = _release_root(tmp_path)
    with open(root / "statistics" / "MUTAG_events.jsonl", "a") as f:
        for fold in range(1, 11):  # a resumed run re-appends epoch 6, slower
            f.write(json.dumps(_epoch(fold, 6, 0.5, 2, folds_in_lockstep=10)) + "\n")
    median, left = release_report.steady_epoch_seconds(
        str(root / "statistics" / "MUTAG_events.jsonl"))
    assert left == 20 and median == pytest.approx(0.0006)  # 0.0005 with both kept


def test_tensorboard_export_writes_the_references_points(tmp_path):
    pytest.importorskip("tensorboardX")
    ev = tmp_path / "MUTAG_events.jsonl"
    with open(ev, "w") as f:
        f.write(json.dumps({"kind": "run_start"}) + "\n")
        for fold in (1, 2):
            for e in (1, 2, 3):
                f.write(json.dumps({**_epoch(fold, e, 0.01, 1), "ts": 1e9,
                                    "edges_per_second": 1e8}) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert export_tensorboard.main([str(ev), "--logdir", str(tmp_path / "runs")]) == 0
    assert f"{2 * 3 * 6} scalar points" in buf.getvalue()
    assert jax_export(str(ev), str(tmp_path / "ref")) == 2 * 3 * 6
    for fold in (1, 2):
        run_dir = tmp_path / "runs" / "MUTAG" / f"fold_{fold}"
        files = list(run_dir.glob("events.out.tfevents.*"))
        assert files and files[0].stat().st_size > 0


def test_tensorboard_export_dedupes_replayed_epochs(tmp_path):
    pytest.importorskip("tensorboardX")
    ev = tmp_path / "MUTAG_events.jsonl"
    with open(ev, "w") as f:
        for e in (1, 2, 3):
            f.write(json.dumps({**_epoch(1, e, 0.01, 1), "edges_per_second": 1e8}) + "\n")
        for e in (2, 3):  # crash + resume replays epochs 2-3
            f.write(json.dumps({**_epoch(1, e, 0.01, 1, train_loss=0.1),
                                "edges_per_second": 1e8}) + "\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        export_tensorboard.main([str(ev), "--logdir", str(tmp_path / "runs")])
    assert f"{3 * 6} scalar points" in buf.getvalue()
    assert jax_export(str(ev), str(tmp_path / "ref")) == 3 * 6


def _stats_dir(d, rows, lockstep=False):
    d.mkdir()
    (d / "X_results_1.csv").write_text("epoch,acc\n1,90\n")
    with open(d / "X_events.jsonl", "w") as f:
        f.write(json.dumps({"kind": "run_start", "ts": hash(str(d)) % 1000}) + "\n")
        for fold, epoch, loss in rows:
            f.write(json.dumps(_epoch(fold, epoch, hash(str(d)) % 7 * 0.1, 1,
                                      train_loss=loss,
                                      **({"folds_in_lockstep": 2} if lockstep else {})))
                    + "\n")
    return d


@pytest.mark.parametrize("lockstep", [False, True], ids=["sequential", "lockstep"])
def test_diff_runs_on_equal_and_differing_runs(tmp_path, lockstep, capsys):
    rows = [(f, 1, 0.5) for f in (1, 2)]
    a = _stats_dir(tmp_path / "a", rows, lockstep)
    b = _stats_dir(tmp_path / "b", rows, lockstep)
    assert diff_runs.main([str(a), str(b)]) == 0  # walls and timestamps differ
    assert "metrics-identical" in capsys.readouterr().out
    c = _stats_dir(tmp_path / "c", [(1, 1, 0.5), (2, 1, 0.25)], lockstep)  # fold 2 only
    assert diff_runs.main([str(a), str(c)]) == 1
    assert "METRICS DIFFER" in capsys.readouterr().out
    (b / "X_results_1.csv").write_text("epoch,acc\n1,91\n")
    assert diff_runs.main([str(a), str(b)]) == 1
    (b / "X_results_1.csv").unlink()
    assert diff_runs.main([str(a), str(b)]) == 1
    assert "MISSING  X_results_1.csv" in capsys.readouterr().out


def test_diff_runs_refuses_two_logs_without_metric_rows(tmp_path, capsys):
    a = _stats_dir(tmp_path / "a", [])
    b = _stats_dir(tmp_path / "b", [])
    assert diff_runs.main([str(a), str(b)]) == 1
    assert "NO METRIC ROWS" in capsys.readouterr().out


def _reference_summary_keys():
    """The keys of the summary line tools/release_validation.py writes (the
    dict literal it passes to json.dumps)."""
    tree = ast.parse((ROOT / "tools" / "release_validation.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no summary dict in tools/release_validation.py")


def test_release_validation_bf16_on_the_cpu(tmp_path):
    """`--dtype bfloat16 --platform cpu` at toy depth: one summary line with
    the reference's keys and the port's, the layout `auto` resolved to."""
    assert release_validation.main([
        "MUTAG", "--out_root", str(tmp_path), "--num_epochs", "1", "--dtype", "bfloat16",
        "--platform", "cpu"]) == 0
    (line,) = (tmp_path / "summary.jsonl").read_text().splitlines()
    row = json.loads(line)
    want = _reference_summary_keys()
    assert len(want) == 8 and want <= set(row)
    assert row["dataset"] == "MUTAG" and row["dtype"] == "bfloat16"
    assert np.isfinite(row["test_acc_mean"]) and np.isfinite(row["test_acc_std"])
    assert (row["layout"], row["cv_parallel"], row["device"], row["card"]) == (
        "dense", "folds", "cpu", None)
    assert (row["num_epochs"], row["num_folds"], row["launches"]) == (1, 10, {})
    events = [json.loads(ln) for ln in
              (tmp_path / "statistics" / "MUTAG_events.jsonl").read_text().splitlines()]
    assert [e["runner_built"] for e in events if e["kind"] == "epoch"] == [True] * 10
    report = release_report.render(str(tmp_path))
    assert "no card (cpu)" in report.splitlines()[0]
    assert "| MUTAG (bfloat16, adj=auto) | — (10 rows left out) |" in report


def test_release_validation_counts_every_kernel_the_loop_counts():
    """The summary's `launches` read the loop's one list of launch counters
    (the list `CountedGraph` credits on replay), every kernel in it."""
    from dgcnn_tpu_torch.train.loop import KERNEL_COUNTERS

    counts = release_validation.kernel_counts()
    assert list(counts) == list(KERNEL_COUNTERS) and len(counts) == 6
    assert all(counts[n] == dict(vars(c)) for n, c in KERNEL_COUNTERS.items())
    assert release_validation.launches_since(counts) == {}


def test_release_validation_raises_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        release_validation.main(["MUTAG", "--out_root", str(tmp_path)])
    assert not (tmp_path / "summary.jsonl").exists()


def test_summarize_trace_over_the_clis_profile_trace(tmp_path, capsys):
    """The trace `--profile` writes on the CPU (tests/test_torch_train.py's
    run): no device events, the host's ATen ops by total, the program's
    spans by name."""
    cli.main(["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
              "--num_folds", "2", "--num_epochs", "1", "--layout", "dense",
              "--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path),
              "--profile", str(tmp_path / "prof")])
    (trace,) = (tmp_path / "prof").glob("trace_*.json")
    s = summarize_trace.summarize(str(trace))
    assert s["device"]["ops"] == [] and s["device"]["busy_us"] == 0
    names = [n for n, _, _ in s["host"]["ops"]]
    assert any(n.startswith("aten::") for n in names) and "GcnTrunkFn" in names
    totals = [d for _, d, _ in s["host"]["ops"]]
    assert totals == sorted(totals, reverse=True) and s["host"]["span_us"] > 0
    # the two folds in lockstep: one chunk through one runner
    spans = {n: calls for n, _, calls in s["spans"]["ops"]}
    assert spans == {"engine.build": 1, "engine.orders": 1, "runner.build": 1,
                     "runner.stage": 1, "fold.end": 1}
    capsys.readouterr()
    pid = int(trace.stem.split("_")[1])
    prof = str(tmp_path / "prof")
    assert summarize_trace.main([prof, "--top", "5", "--pid", str(pid)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# {trace}" and "(no events)" in out[1]
    assert out[2].startswith("# host:") and out[9].startswith("# spans:")
    assert len(out) == 3 + 1 + 5 + 2 + 5
    with pytest.raises(SystemExit):
        summarize_trace.main([prof, "--pid", str(pid + 1)])


def test_summarize_trace_splits_the_cards_kernels_from_the_hosts_ops(tmp_path):
    """A torch.profiler Chrome trace as the card's run writes it: kernels,
    copies and sets on the device side, ATen ops on the host side, the
    program's spans (host user annotations, or host ops by their names, as
    some torch versions file them) on their own; runtime calls, the card's
    annotation ranges and flow events in none."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "trunk_resident_fwd(TrunkArgs)",
         "ts": 100, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "trunk_resident_fwd(TrunkArgs)",
         "ts": 200, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 80, "dur": 9},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10, "dur": 4},
        {"ph": "X", "cat": "user_annotation", "name": "runner.replay", "ts": 78,
         "dur": 12},
        {"ph": "X", "cat": "cpu_op", "name": "fold.begin", "ts": 2, "dur": 3},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "runner.replay", "ts": 100,
         "dur": 150},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 80},
    ]
    path = tmp_path / "trace_7.json"
    path.write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "trace_3.json").write_text(json.dumps({"traceEvents": []}))
    os.utime(tmp_path / "trace_3.json", (0, 0))
    assert summarize_trace.find_trace(str(tmp_path)) == str(path)  # the newest
    s = summarize_trace.summarize(str(path))
    assert s["device"]["ops"] == [("trunk_resident_fwd(TrunkArgs)", 80.0, 2),
                                  ("Memcpy HtoD", 5.0, 1)]
    assert s["device"]["busy_us"] == 85.0 and s["device"]["span_us"] == 160.0
    assert s["host"]["ops"] == [("aten::mm", 4.0, 1)]
    assert s["spans"]["ops"] == [("runner.replay", 12.0, 1), ("fold.begin", 3.0, 1)]
    assert "trunk_resident_fwd" in summarize_trace.table("device", s["device"], 30)
