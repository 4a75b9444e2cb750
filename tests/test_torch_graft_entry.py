"""The port's single-device forward entry (dgcnn_tpu_torch/graft_entry.py)
against the reference's `__graft_entry__.entry` shapes, `apply`, and
`torch.compile` on the CPU (the `aot_eager` backend: inductor is slow on
the CPU; chip_smoke.py runs the default backend on the card)."""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from dgcnn_tpu_torch import graft_entry
from dgcnn_tpu_torch.batching.packer import GraphBatch
from dgcnn_tpu_torch.models.dgcnn import DGCNN, apply, apply_coo, apply_dense
import torch_threads  # noqa: F401  (torch on one CPU thread)


def test_entry_returns_what_apply_gives_on_the_references_shapes():
    fn, (params, batch) = graft_entry.entry(device="cpu")
    _, (jparams, jbatch) = jentry.entry()
    assert isinstance(batch, GraphBatch)
    for name in ("x", "edge_src", "edge_dst", "edge_mask", "node_graph", "node_mask",
                 "y", "graph_mask"):
        got, want = getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name))
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), name
    assert int(batch.num_graphs) == int(jbatch.num_graphs) == 50
    assert [tuple(l["w"].shape) for l in params["gcn"]] == [
        tuple(l["w"].shape) for l in jparams["gcn"]]
    lp = fn(params, batch)
    model = DGCNN(num_features=batch.x.shape[1], num_classes=2)
    assert lp.shape == (batch.y.shape[0], 2) and torch.isfinite(lp).all()
    assert torch.equal(lp, apply_coo(params, model, batch))
    assert torch.equal(lp, apply(params, model, batch, spmm_impl="xla"))


def test_apply_dispatches_on_the_batch_layout():
    from dgcnn_tpu_torch.batching.dense import batch_to_device, dense_tile, pack_dense_batch
    from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
    from dgcnn_tpu_torch.models.dgcnn import init_params

    gs = synthesize_tu_dataset("MUTAG", num_graphs=10, seed=3)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    params = init_params(torch.Generator().manual_seed(1), model)
    dense = batch_to_device(pack_dense_batch(gs, np.arange(10), dense_tile(gs), 16), "cpu")
    got = apply(params, model, dense, spmm_impl="onehot")  # dropped for dense
    assert torch.equal(got, apply_dense(params, model, dense))


def test_entry_under_torch_compile_gives_the_same_log_probs():
    torch._dynamo.reset()
    fn, args = graft_entry.entry(device="cpu")
    want = fn(*args)
    got = torch.compile(fn, backend="aot_eager")(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_entry_refuses_a_missing_card_and_its_cli_runs_on_the_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            graft_entry.entry()
    assert graft_entry.main(["--platform", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [56, 2] and out["finite"]


def test_the_row_kernel_launch_is_an_operator_with_a_fake_implementation():
    """torch.compile traces the forward on the card through the row
    kernel's operator: its fake implementation gives the launch's output
    shape without running it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from dgcnn_tpu_torch.kernels import spmm_pallas

    with FakeTensorMode():
        row_ptr = torch.empty(11, dtype=torch.int32)
        col = torch.empty(30, dtype=torch.int32)
        out = torch.ops.dgcnn_tpu_torch.spmm_rows(
            row_ptr, None, col, col, torch.empty(30), torch.empty(10, 7), False,
            spmm_pallas.CURRENT)
    assert out.shape == (10, 7) and out.dtype == torch.float32
