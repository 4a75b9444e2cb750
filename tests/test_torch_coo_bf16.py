"""bf16 compute on the COO layout, against the reference.

The reference's `apply_coo` under compute_dtype="bfloat16" rounds x at
entry, each W_i at its product and each layer's masked output to bf16,
and keeps everything between (h = x @ W summed in fp32, the SpMM, the
self-loop term, the bias, tanh) in fp32 (dgcnn_tpu/models/dgcnn.py:213,
:226, :244; dgcnn_tpu/ops/gcn.py:126). The port's `apply_coo` does the
same, so its SpMM kernels run fp32 under either compute dtype:

  * log-probs and parameter gradients of the port's `apply_coo` against
    JAX's on one packed batch with the same weights, MUTAG and NCI1, under
    each SpMM name (JAX's block-COO kernel in interpret mode). Tolerances
    are the bf16 ones of tests/test_torch_mixed_precision.py: log-probs
    within 5e-3, gradients within 1e-2 of the largest gradient element by
    element and 1e-2 of the whole gradient's norm (fp32 sums taken in
    other orders can put a value on the other side of a bf16 rounding
    boundary; autograd's `.float()` and JAX's transpose of `astype` round
    dx and dW at the same points);
  * every layer's output is bf16 and every SpMM takes fp32 h;
  * `run_cross_validation` on COO under bf16 compute, with both engines,
    writes each fold's CSV and bundle with finite losses.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_coo as jax_apply_coo
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu_torch.batching import packer as tpk
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, leaves
from dgcnn_tpu_torch.ops import gcn as tgcn
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct
import torch_threads  # noqa: F401  (torch on one CPU thread)

IDX = {"MUTAG": [0, 3, 5, 8, 11, 2, 14, 9], "NCI1": [1, 4, 6, 9, 12, 13, 0, 7]}
IMPLS = ["xla", "onehot", "pallas"]


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


@functools.lru_cache(maxsize=None)
def _batches(name):
    """One packed batch in both packages, with block-pair structures."""
    gs = synthesize_tu_dataset(name, num_graphs=16, seed=4)
    host = tpk.add_blockcoo(tpk.pack_batch(gs, IDX[name], tpk.compute_bucket(gs, 8)),
                            eb=128)
    jhost = jpk.pack_batch(_jset(gs), IDX[name], jpk.compute_bucket(_jset(gs), 8))
    return gs, tpk.batch_to_device(host, "cpu"), jpk.add_blockcoo(jhost, eb=128)


def _models(gs):
    kw = dict(num_features=gs.num_features, num_classes=gs.num_classes,
              dropout_rate=0.0, compute_dtype="bfloat16")
    jm = JDGCNN(**kw)
    jp = jax_init(jax.random.PRNGKey(7), jm)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, DGCNN(**kw), jp, state


@functools.lru_cache(maxsize=None)
def _jax_lp_grads(name, impl):
    gs, _, jb = _batches(name)
    jm, _, jp, _ = _models(gs)

    def jloss(p):
        lp = jax_apply_coo(p, jm, jb, spmm_impl=impl)
        return jax_nll(lp, jb.y, jb.graph_mask)[0], lp

    (_, lp), g = jax.value_and_grad(jloss, has_aux=True)(jp)
    return np.asarray(lp), [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


def _check_lp(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=5e-3)


def _check_grads(got, want):
    g = np.concatenate([a.numpy().ravel() for a in got])
    w = np.concatenate([b.ravel() for b in want])
    scale = np.abs(w).max()
    assert scale > 0
    assert np.abs(g - w).max() <= 1e-2 * scale, np.abs(g - w).max() / scale
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(IDX))
def test_apply_coo_bf16_matches_jax(name, impl, monkeypatch):
    gs, tb, _ = _batches(name)
    _, tm, _, state = _models(gs)
    want_lp, want_g = _jax_lp_grads(name, impl)
    seen = []
    spmm = tgcn.spmm

    def spy(*args, **kw):
        seen.append(args[3].dtype)
        return spmm(*args, **kw)

    monkeypatch.setattr(tgcn, "spmm", spy)
    net = DGCNNNet(tm, state_to_params(state))
    lp, acts = net(tb, spmm_impl=impl, return_activations=True)
    assert lp.dtype == torch.float32
    assert [acts[f"gcn{i + 1}"].dtype for i in range(4)] == [torch.bfloat16] * 4
    assert seen == [torch.float32] * 4
    _check_lp(lp, want_lp)
    nll_loss_and_correct(lp, tb.y, tb.graph_mask)[0].backward()
    _check_grads([p.grad for p in leaves(net.params())], want_g)


def _epoch_events(cfg):
    with open(f"{cfg.statistics_dir}/{cfg.data_type}_events.jsonl") as f:
        return [e for e in map(json.loads, f) if e["kind"] == "epoch"]


@pytest.mark.parametrize("engine,kw", [
    ("device", dict(spmm_impl="xla")),
    ("host", dict(spmm_impl="pallas")),
    ("host", dict(spmm_impl="onehot", coo_assembly="host")),
], ids=["device-xla", "host-pallas", "host-onehot"])
def test_cross_validation_trains_coo_under_bf16(tmp_path, engine, kw):
    gs = synthesize_tu_dataset("MUTAG", num_graphs=24, seed=6)
    cfg = Config(data_type="MUTAG", batch_size=8, num_epochs=2, num_folds=2,
                 max_fused_epochs=2, layout="coo", compute_dtype="bfloat16",
                 data_root=str(tmp_path / "data"), epochs_dir=str(tmp_path / "epochs"),
                 statistics_dir=str(tmp_path / "statistics"),
                 hidden_dims=(8, 8, 1), conv1d_channels=(4, 8), dense_dim=16, **kw)
    want = cv.CooEngine if engine == "host" else cv.DeviceCooEngine
    assert isinstance(cv.make_engine(cfg, gs, torch.device("cpu"), "coo"), want)
    res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    events = _epoch_events(cfg)
    assert len(events) == 4 and np.isfinite(res["train_accuracy_mean"])
    for e in events:
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["test_loss"])
    for f in (1, 2):
        assert (tmp_path / "statistics" / f"MUTAG_results_{f}.csv").exists()
        assert (tmp_path / "epochs" / f"MUTAG_{f}.npz").exists()
