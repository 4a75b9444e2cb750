"""dgcnn_tpu_torch/tools/probe_epoch_seconds.py on the CPU: one line with
every epoch's seconds from the run's event log, from the package first on
the path. (Its card runs happen on the card.)"""

import json

from dgcnn_tpu_torch.tools import probe_epoch_seconds
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_it_prints_every_epochs_seconds_of_the_run(capsys):
    assert probe_epoch_seconds.main(["--data_type", "MUTAG", "--folds", "2", "--epochs",
                                     "2", "--eager", "--platform", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(f, e) for f, e, _ in out["epoch_seconds"]] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    assert all(s > 0 for _, _, s in out["epoch_seconds"]) and out["wall_s"] > 0
    assert out["package"].endswith("dgcnn_tpu_torch") and out["card"] is None
