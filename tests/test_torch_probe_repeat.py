"""dgcnn_tpu_torch/tools/probe_repeat.py on the CPU: its batch is
chip_smoke.py phase 4a's card-vs-CPU lockstep batch, its digest is the
one chip_smoke prints beside that check, and fresh processes and
repetitions give one bit pattern. (Its card runs happen on the card.)"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dgcnn_tpu_torch.batching.dense import dense_tile
from dgcnn_tpu_torch.tools import cpu_pin, probe_repeat
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_the_batch_and_outputs_are_chip_smokes():
    gs, batch = probe_repeat.lockstep_batch()
    want = cs.stack_batches(cs.lockstep_parts(gs, dense_tile(gs), "NCI1"))
    for fld in dataclasses.fields(batch):
        np.testing.assert_array_equal(getattr(batch, fld.name), getattr(want, fld.name))
    outs = probe_repeat.outputs(gs, batch, "cpu")
    assert [n for n, _ in outs][:3] == ["log_probs", "gcn.0.b", "gcn.0.w"]
    assert all(torch.isfinite(t).all() for _, t in outs)
    assert probe_repeat.digest(outs) == probe_repeat.digest(
        [(n, t.clone()) for n, t in outs])


def test_fresh_processes_give_one_pattern(capsys, monkeypatch):
    monkeypatch.setattr(cpu_pin, "THREADS", 1)  # the children's torch, as this one's
    assert probe_repeat.main(["--devices", "cpu", "--runs", "2", "--reps", "2"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["cpu"]["cpu_side"][0].startswith("1 torch threads, MKL_CBWR=AVX2")
    assert report["cpu"]["distinct_across_processes"] == 1
    assert report["cpu"]["distinct_within_a_process"] == 1
    assert len(report["cpu"]["patterns"]) == 2 and "card_vs_cpu" not in report


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_the_card_is_asked_for_by_default():
    assert probe_repeat.main(["--runs", "1", "--reps", "1"]) == 1
