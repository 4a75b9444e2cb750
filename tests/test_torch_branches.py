"""chip_smoke.py's card-vs-CPU checks hold both devices' gradients on the
same branches (`chip_smoke.Branches`): the ReLUs, the max-pool selects
and the sort-pool orders the card took are replayed on the CPU, and each
one the CPU's own values would take otherwise must be a near-tie within
the check's tolerance. Here both runs are on the CPU: the recorded run's
weights are perturbed by a few rounding errors, standing in for the
card's other summation orders, or by far more, standing in for a wrong
kernel."""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dgcnn_tpu_torch.batching.dense import batch_to_device, dense_tile, order_matrix
from dgcnn_tpu_torch.batching.device_coo import (
    build_device_graphset, device_graphset_to, gather_coo_batch)
from dgcnn_tpu_torch.batching.packer import compute_bucket
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct
from dgcnn_tpu_torch.utils.profiling import ATOL, RTOL, rel_err
import torch_threads  # noqa: F401  (torch on one CPU thread)


def tol(t):
    return ATOL + RTOL * t.detach().double().abs().max().item()


def perturb(params, eps):
    """Each weight times (1 + u), u uniform in [−eps, eps], from a seed."""
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in params:
            p.mul_(1 + eps * (2 * torch.rand(p.shape, generator=gen) - 1))


@pytest.fixture(scope="module")
def nci1_lockstep():
    """chip_smoke phase 4a's lockstep batch: synthetic NCI1, the ten
    folds' first 50 training graphs stacked on the slot axis."""
    gs = synthesize_tu_dataset("NCI1")
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    host = cs.stack_batches(cs.lockstep_parts(gs, dense_tile(gs), "NCI1"))

    def run(branches, mode, eps=0.0):
        b = batch_to_device(host, "cpu")
        net = cs.folds_net(model, "cpu")
        if eps:
            perturb([net.flat], eps)
        with branches.taken(mode) if branches else contextlib.nullcontext():
            lp = net(b)
        loss, _ = nll_loss_and_correct(lp, b.y.view(cs.FOLDS, -1),
                                       b.graph_mask.view(cs.FOLDS, -1))
        loss.sum().backward()
        return [("log_probs", lp.detach())] + [(n, p.grad.clone())
                                               for n, p in net.named_parameters()]

    return run


@pytest.fixture(scope="module")
def mutag_coo():
    """One synthetic MUTAG batch of 50 on the device-assembled COO layout,
    pooled by the global sort (`sort_pool`)."""
    gs = synthesize_tu_dataset("MUTAG")
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    bucket = compute_bucket(gs, 50)
    row = order_matrix(np.arange(gs.num_graphs, dtype=np.int32), 50, bucket.num_graphs)[0]
    dset = device_graphset_to(build_device_graphset(gs), "cpu")

    def run(branches, mode, eps=0.0):
        b = gather_coo_batch(dset, torch.from_numpy(row), bucket)
        net = DGCNNNet(model, init_params(torch.Generator().manual_seed(3), model, "cpu"))
        if eps:
            perturb(net.parameters(), eps)
        with branches.taken(mode):
            lp = net(b, spmm_impl="xla")
        loss, _ = nll_loss_and_correct(lp, b.y, b.graph_mask)
        loss.backward()
        return [("log_probs", lp.detach())] + [(n, p.grad.clone())
                                               for n, p in net.named_parameters()]

    return run


def beyond(got, want):
    """Names of the tensors outside the check's tolerance."""
    return [n for (n, a), (_, c) in zip(got, want) if not rel_err(a, c)[2]]


@pytest.mark.parametrize("batch", ["nci1_lockstep", "mutag_coo"])
def test_replaying_a_run_on_its_own_branches_is_bitwise(batch, request):
    run = request.getfixturevalue(batch)
    branches = cs.Branches(tol)
    rec = run(branches, "record")
    rep = run(branches, "replay")
    assert all(torch.equal(a, c) for (_, a), (_, c) in zip(rec, rep))
    assert branches.summary() == "none"
    kinds = {k for k, _ in branches.log}
    assert {"ReLU", "max-pool"} <= kinds
    assert ("sort-pool top-k" if batch == "nci1_lockstep" else "sort-pool order") in kinds


def test_near_ties_move_gradients_and_the_replay_aligns_them(nci1_lockstep):
    """The refused check's signature: rounding-sized differences leave the
    log-probs within tolerance and push gradients beyond it through a
    branch taken otherwise; on the same branches every tensor agrees."""
    plain = nci1_lockstep(None, None)
    off = beyond(nci1_lockstep(None, None, 1e-5), plain)
    assert off and "log_probs" not in off and off[0] == "gcn.0.b"
    branches = cs.Branches(tol)
    rec = nci1_lockstep(branches, "record", 1e-5)
    rep = nci1_lockstep(branches, "replay")
    assert beyond(rec, rep) == []
    assert branches.near["ReLU"][0] >= 1
    assert all(w < 1 for _, w in branches.near.values())


@pytest.mark.parametrize("batch,eps,kind", [
    ("nci1_lockstep", 1e-3, "sort-pool top-k"),
    ("mutag_coo", 1e-2, "sort-pool order"),
])
def test_a_difference_beyond_the_tolerance_still_fails(batch, eps, kind, request):
    run = request.getfixturevalue(batch)
    branches = cs.Branches(tol)
    run(branches, "record", eps)
    with pytest.raises(AssertionError, match=f"^{kind}: the card decides"):
        run(branches, "replay")


def test_near_ties_of_the_global_sort_replay(mutag_coo):
    branches = cs.Branches(tol)
    rec = mutag_coo(branches, "record", 1e-4)
    rep = mutag_coo(branches, "replay")
    assert beyond(rec, rep) == []
    assert branches.near["sort-pool order"][0] >= 2


def test_a_replay_on_another_path_fails(nci1_lockstep, mutag_coo):
    branches = cs.Branches(tol)
    nci1_lockstep(branches, "record")
    with pytest.raises(AssertionError, match="is not the card's"):
        mutag_coo(branches, "replay")
