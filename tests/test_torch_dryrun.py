"""The port's multi-device dry run (dgcnn_tpu_torch/graft_entry.py
`dryrun_multichip`, the port of `__graft_entry__.py:35-235`) on two `gloo`
CPU ranks: every leg passes its gate (the DP epoch finite; the COO,
dense, block and halo mesh engines ≥ 70 %; fold-sharded lockstep on
(2, 1) equal to one device fold for fold, 10 folds, ≥ 70 %), and without a
card the default device raises."""

import pytest
import torch

from dgcnn_tpu_torch import graft_entry
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_dryrun_multichip_passes_on_two_cpu_ranks():
    res = graft_entry.dryrun_multichip(2, device="cpu")
    for leg in ("coo", "dense", "block", "halo"):
        assert res[leg] >= 70.0, (leg, res)
    assert len(res["folds"]) == 10 and sum(res["folds"]) / 10 >= 70.0
    assert torch.isfinite(torch.tensor([res["dp_train_loss"], res["dp_eval_loss"]])).all()


def test_dryrun_without_a_card_raises_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.main(["--dryrun", "2"])
