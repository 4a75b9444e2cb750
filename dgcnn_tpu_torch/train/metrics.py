"""Metrics writers — the observability layer.

Replaces the reference's visdom live plots + pandas CSVs (reference
train.py:80,122-125,130-131,144-145) with server-free artifacts:

  * per-fold CSV `statistics/<DS>_results_<fold>.csv` with the same columns
    and index label as the reference (epoch, train_loss, test_loss,
    train_accuracy, test_accuracy);
  * overall CSV `statistics/<DS>_results_overall.csv` (fold-indexed);
  * an append-only JSONL event stream (`statistics/<DS>_events.jsonl`) with
    throughput fields (edges/s, step time) the reference never had;
  * the program's spans (`SPANS`, a `SpanRecorder`): where the host works
    between and around the card's replays, kept in memory while recording
    and, under a profiler, named in its trace.

The writers are a copy of dgcnn_tpu/train/metrics.py (plain Python), so
the port writes the same artifacts with the same columns; the spans are
the port's own.
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler


class FoldMetrics:
    """Accumulates per-epoch metrics for one fold (reference
    train.py:113-121)."""

    COLUMNS = ("train_loss", "test_loss", "train_accuracy", "test_accuracy")

    def __init__(self):
        self.rows: Dict[str, List[float]] = {c: [] for c in self.COLUMNS}

    def append(self, train_loss, test_loss, train_acc, test_acc):
        self.rows["train_loss"].append(float(train_loss))
        self.rows["test_loss"].append(float(test_loss))
        self.rows["train_accuracy"].append(float(train_acc))
        self.rows["test_accuracy"].append(float(test_acc))

    def last(self, column: str) -> float:
        return self.rows[column][-1]

    def to_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("epoch," + ",".join(self.COLUMNS) + "\n")
            for i in range(len(self.rows["train_loss"])):
                vals = ",".join(str(self.rows[c][i]) for c in self.COLUMNS)
                f.write(f"{i + 1},{vals}\n")


def completed_fold_accuracies(csv_path: str, num_epochs: int
                              ) -> Optional[Tuple[float, float]]:
    """If a fold CSV already holds `num_epochs` rows, its last epoch's
    (train_acc, test_acc), so that `--resume` can skip the fold (the
    reference's `_completed_fold_accuracies`, dgcnn_tpu/train/cv.py:218)."""
    if not os.path.exists(csv_path):
        return None
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    if len(lines) != num_epochs + 1:
        return None
    last = lines[-1].split(",")
    return float(last[3]), float(last[4])


def write_overall_csv(path: str, train_accs: List[float], test_accs: List[float]):
    """`statistics/<DS>_results_overall.csv` (reference train.py:144-145)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("fold,train_accuracy,test_accuracy\n")
        for i, (tr, te) in enumerate(zip(train_accs, test_accs), start=1):
            f.write(f"{i},{tr},{te}\n")


class EventLog:
    """Append-only JSONL event stream for programmatic observability."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, **event) -> None:
        if not self.path:
            return
        event.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")


class _NullSpan:
    """What a span site gets while the recorder is off and no profiler
    runs: entering, leaving and setting an attribute do nothing."""

    seconds = None
    kept = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Timed(_NullSpan):
    """A span whose seconds the program itself reads (`timed=True`) while
    the recorder is off and no profiler runs: two clock reads, nothing
    recorded."""

    def __enter__(self):
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = (time.time_ns() - self._t0) / 1e9
        return False


class _Span:
    """One open span while the recorder is on or a profiler runs
    (`SpanRecorder.span`): a record only in the first case."""

    __slots__ = ("_owner", "_name", "_device", "_rec", "_range", "_events", "_t0",
                 "seconds")

    def __init__(self, owner: "SpanRecorder", name: str, device, tail: bool):
        self._owner, self._name, self._device = owner, name, device
        self._range = self._events = None
        self.seconds = None
        self._rec = None
        if owner.on:
            seq = owner._seq.get(name, 0)
            owner._seq[name] = seq + 1
            chunk = owner.chunk - 1 if tail and owner.chunk else owner.chunk
            self._rec = {"name": name, "id": len(owner.records), "parent": None,
                         "chunk": chunk, "seq": seq, "rank": owner.rank,
                         "start_ns": 0, "end_ns": 0, "attrs": {}}

    @property
    def kept(self) -> bool:
        return self._rec is not None

    def __setitem__(self, key: str, value) -> None:
        if self._rec is not None:
            self._rec["attrs"][key] = value

    def __enter__(self):
        o, rec = self._owner, self._rec
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self._name)
            self._range.__enter__()
        if rec is not None:
            rec["parent"] = o._open[-1] if o._open else None
            o.records.append(rec)
            o._open.append(rec["id"])
            if self._device is not None and torch.device(self._device).type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record()
        self._t0 = time.time_ns()
        if rec is not None:
            rec["start_ns"] = self._t0
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        self.seconds = (t1 - self._t0) / 1e9
        rec = self._rec
        if rec is not None:
            rec["end_ns"] = t1
            self._owner._open.pop()
            if self._events is not None:
                self._events[1].record()
                self._owner._pending.append((rec, *self._events))
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class SpanRecorder:
    """The program's spans: where the host works between and around the
    card's replays (the fold switch, a chunk's orders and staging, a
    runner's build, warm-up, capture and replays, the mesh's fold gather).

    A span site is `with SPANS.span(name) as s:` around the work, with
    `s[key] = value` for an attribute. While the recorder is off and no
    profiler runs, a span costs two flag checks (`on` and the profiler's
    own): `span` hands back `NULL_SPAN`, and nothing reads a clock, makes
    a CUDA event or records (a `timed` span, whose seconds the program
    itself reads, reads the clock twice). Between
    `start` and `stop` each span is a record (a dict):

      name, id (its index in the records), parent (the id of the span open
      around it, or None), chunk, seq (how many spans of this name came
      before it: ranks that make the same calls give matching spans one
      seq), rank, start_ns and end_ns, attrs.

    The stamps are `time.time_ns()`, the Unix-epoch clock that the
    profiler's (kineto's) events are stamped with, so spans, device events
    and the ranks of one host share a timeline. A span given a `device`
    (`runner.warmup`, `runner.replay`) also records a pair of CUDA events
    on the current stream; `chunk_done`, after the chunk's rows reached
    the host, reads them into `attrs["device_ms"]` without waiting.
    `chunk` counts the chunks whose rows had reached the host when the
    span opened, so a chunk's fold switch, orders, runner build, staging,
    warm-up, capture and replays share one; a `tail` span (the mesh's
    gather of a chunk's rows) takes the chunk that just ended.

    While a profiler runs (the CLI's `--profile`, a traced benchmark
    stretch), each span is also a `record_function` range of its name,
    whether or not the recorder records, so the trace names the program's
    work. No span goes inside an epoch body, which a CUDA graph captures:
    the finest grain is one replay. One recorder a process (`SPANS`), as
    the kernels' launch counters are one dict (train/loop.py
    `KERNEL_COUNTERS`)."""

    def __init__(self):
        self.on = False  # recording; a span site reads it and the profiler's flag
        self.records: List[dict] = []
        self.chunk = 0
        self.rank = 0
        self._open: List[int] = []
        self._pending: list = []
        self._seq: Dict[str, int] = {}

    def span(self, name: str, device=None, timed: bool = False, tail: bool = False):
        """A context manager: the span `name` (see the class docstring)."""
        if not (self.on or _profiler._is_profiler_enabled):
            return _Timed() if timed else NULL_SPAN
        return _Span(self, name, device, tail)

    def start(self) -> None:
        """Record from here on, from a clean slate (records, chunk and seq
        counts), stamping the process group's rank where there is one."""
        dist = torch.distributed
        self.records, self._open, self._pending, self._seq = [], [], [], {}
        self.chunk = 0
        self.rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self.on = True

    def stop(self) -> List[dict]:
        """Stop recording; the records since `start`, their device times
        read (the caller has synchronized: no wait is added)."""
        self._settle()
        self.on = False
        records, self.records = self.records, []
        self._open, self._pending = [], []
        return records

    def chunk_done(self) -> None:
        """A chunk's rows are on the host (train/loop.py `FusedRun`): read
        its device times; the spans after this belong to the next chunk."""
        if self.on:
            self._settle()
            self.chunk += 1

    def _settle(self) -> None:
        pending = []
        for rec, begin, end in self._pending:
            if end.query():
                rec["attrs"]["device_ms"] = begin.elapsed_time(end)
            else:
                pending.append((rec, begin, end))
        self._pending = pending


SPANS = SpanRecorder()


def spanned(name: str):
    """Decorate a function so that each call runs in the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with SPANS.span(name):
                return fn(*args, **kwargs)
        return run
    return wrap
