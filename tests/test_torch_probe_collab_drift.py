"""dgcnn_tpu_torch/tools/probe_collab_drift.py on the CPU at a toy size: the
four runs, the distances from the first, and a rerun bitwise. (Its card
runs happen on the card.)"""

import json

from dgcnn_tpu_torch.tools import probe_collab_drift
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_it_prints_each_runs_distance_from_the_sequential_rows(capsys):
    assert probe_collab_drift.main(["--graphs", "60", "--epochs", "2",
                                    "--platform", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["graphs"] == 60 and out["card"] is None
    assert set(out["distance"]) == {"perturbed", "lockstep", "sequential_again"}
    assert all(v == 0.0 for v in out["distance"]["sequential_again"].values())
    assert all(len(out["rows"][k]) == 2 and len(out["rows"][k][0]) == 2 for k in out["rows"])
