"""The port's DGCNN on the COO layout (apply_coo, models/dgcnn.py) against
JAX `apply_coo`: weights carried across with `params_from_jax`,
activations, log-probs and parameter gradients through every SpMM name
(JAX's block-COO kernel in interpret mode where the batch carries
structures), the COO logits against the port's dense layout, a 5-step
Adam trajectory, the two COO engines against each other, and the COO CV
driver and CLI on the CPU."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgcnn_tpu.batching import device_coo as jdc
from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_coo as jax_apply_coo
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu.train.metrics import FoldMetrics as JFoldMetrics
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.batching import device_coo as tdc
from dgcnn_tpu_torch.batching import packer as tpk
from dgcnn_tpu_torch.batching.dense import batch_to_device as dense_to_device
from dgcnn_tpu_torch.batching.dense import dense_tile, pack_dense_batch
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, apply_coo, apply_dense, leaves
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import make_optimizer, nll_loss_and_correct, train_step
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint
import torch_threads  # noqa: F401  (torch on one CPU thread)

ACTS = ("gcn1", "gcn2", "gcn3", "gcn4", "sort_pool", "log_probs")
IDX = {"MUTAG": [0, 3, 5, 8, 11, 2], "DD": [1, 4, 6, 9, 12, 13]}


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


@functools.lru_cache(maxsize=None)
def _batches(name):
    """One packed batch in both packages, with and without structures."""
    gs = synthesize_tu_dataset(name, num_graphs=16, seed=4)
    bucket = tpk.compute_bucket(gs, 8)
    host = tpk.pack_batch(gs, IDX[name], bucket)
    jhost = jpk.pack_batch(_jset(gs), IDX[name], jpk.compute_bucket(_jset(gs), 8))
    return (gs, tpk.batch_to_device(host, "cpu"),
            tpk.batch_to_device(tpk.add_blockcoo(host, eb=128), "cpu"),
            jhost, jpk.add_blockcoo(jhost, eb=128))


def _models(gs, key=0):
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0)
    jp = jax_init(jax.random.PRNGKey(key), jm)
    return jm, tm, jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _port_batch(name, impl):
    _, tb, tbc, _, _ = _batches(name)
    return tbc if impl == "pallas" else tb


@functools.lru_cache(maxsize=None)
def _jax_acts(name, jimpl):
    gs, _, _, jb, jbc = _batches(name)
    jm, _, jp, _ = _models(gs)
    batch = jbc if jimpl == "pallas" else jb
    return jax_apply_coo(jp, jm, batch, spmm_impl=jimpl, return_activations=True)[1]


@pytest.mark.parametrize("impl", ["xla", "onehot", "pallas", "auto"])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(IDX))
def test_activations_match_jax_apply_coo(name, jimpl, impl):
    gs = _batches(name)[0]
    _, tm, _, state = _models(gs)
    want = _jax_acts(name, jimpl)
    # "auto" is resolved above the model, as the engines do
    _, got = apply_coo(state_to_params(state), tm, _port_batch(name, impl),
                       spmm_impl=Config(spmm_impl=impl).resolved_spmm_impl(),
                       return_activations=True)
    for key in ACTS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{name} {key}")


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name, jimpl):
    gs, _, _, jb, jbc = _batches(name)
    jm, _, jp, _ = _models(gs, key=2)
    batch = jbc if jimpl == "pallas" else jb

    def jloss(p):
        lp = jax_apply_coo(p, jm, batch, spmm_impl=jimpl)
        return jax_nll(lp, batch.y, batch.graph_mask)[0]

    return jax.value_and_grad(jloss)(jp)


@pytest.mark.parametrize("impl", ["xla", "onehot", "pallas"])
@pytest.mark.parametrize("jimpl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(IDX))
def test_nll_gradients_match_jax(name, jimpl, impl):
    gs = _batches(name)[0]
    _, tm, _, state = _models(gs, key=2)
    jloss_v, jgrads = _jax_loss_grads(name, jimpl)
    net = DGCNNNet(tm, state_to_params(state))
    b = _port_batch(name, impl)
    loss, _ = nll_loss_and_correct(net(b, spmm_impl=impl), b.y, b.graph_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=1e-5)
    got = [p.grad for p in leaves(net.params())]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("node_scale", [False, True])
def test_gcn_ops_match_jax(node_scale):
    """gcn_degree, gcn_edge_weights and both forms of gcn_conv (per-edge
    weights, and node-row scalings around the mask-weighted SpMM)."""
    from dgcnn_tpu.ops import gcn as jgcn
    from dgcnn_tpu_torch.ops import gcn as tgcn

    _, tb, _, jb, _ = _batches("DD")
    n = tb.x.shape[0]
    rng = np.random.default_rng(1)
    w = rng.standard_normal((tb.x.shape[1], 16)).astype(np.float32) * 0.1
    b = rng.standard_normal(16).astype(np.float32)
    j_deg = jgcn.gcn_degree(jnp.asarray(jb.edge_dst), jnp.asarray(jb.edge_mask), n)
    t_deg = tgcn.gcn_degree(tb.edge_dst, tb.edge_mask, n)
    np.testing.assert_array_equal(t_deg.numpy(), np.asarray(j_deg))
    j_ew = jgcn.gcn_edge_weights(jnp.asarray(jb.edge_src), jnp.asarray(jb.edge_dst),
                                 jnp.asarray(jb.edge_mask), j_deg)
    t_ew = tgcn.gcn_edge_weights(tb.edge_src, tb.edge_dst, tb.edge_mask, t_deg)
    np.testing.assert_allclose(t_ew.numpy(), np.asarray(j_ew), rtol=1e-6, atol=0)
    if node_scale:
        j_w, t_w = jnp.asarray(jb.edge_mask), tb.edge_mask
        j_s, t_s = jax.lax.rsqrt(j_deg), torch.rsqrt(t_deg)
    else:
        j_w, t_w, j_s, t_s = j_ew, t_ew, None, None
    want = jgcn.gcn_conv(jnp.asarray(jb.x), jnp.asarray(w), jnp.asarray(b),
                         jnp.asarray(jb.edge_src), jnp.asarray(jb.edge_dst), j_w, j_deg,
                         node_scale=j_s)
    got = tgcn.gcn_conv(tb.x, torch.from_numpy(w), torch.from_numpy(b), tb.edge_src,
                        tb.edge_dst, t_w, t_deg, node_scale=t_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_coo_logits_equal_the_dense_layout():
    """The same graphs through apply_coo and apply_dense give the same
    log-probs (the equality tests/test_dense.py pins on the JAX side)."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=16, seed=4)
    _, tm, _, state = _models(gs)
    params = state_to_params(state)
    idx = IDX["MUTAG"]
    coo = apply_coo(params, tm, tpk.batch_to_device(
        tpk.pack_batch(gs, idx, tpk.BucketSpec(512, 2048, len(idx))), "cpu"))
    dense = apply_dense(params, tm, dense_to_device(
        pack_dense_batch(gs, np.asarray(idx), dense_tile(gs), len(idx)), "cpu"))
    torch.testing.assert_close(coo, dense, rtol=1e-5, atol=1e-6)


def test_forward_rejects_unknown_spmm_impl():
    gs, tb = _batches("MUTAG")[:2]
    _, tm, _, state = _models(gs)
    with pytest.raises(ValueError, match="spmm impl"):
        DGCNNNet(tm, state_to_params(state))(tb, spmm_impl="other")


def test_five_adam_steps_match_jax_coo_step():
    gs = synthesize_tu_dataset("DD", num_graphs=20, seed=4)
    jgs = _jset(gs)
    order = np.random.default_rng(0).permutation(gs.num_graphs)
    rows = [np.concatenate([order[i * 3 : i * 3 + 3], [-1]]).astype(np.int32)
            for i in range(5)]
    n, e = tdc.batch_extents(gs.node_counts(), gs.edge_counts(), np.stack(rows))
    bucket = tpk.BucketSpec(cv._geom_round(n, 256), cv._geom_round(e, 1024), 4)
    jbucket = jpk.BucketSpec(bucket.num_nodes, bucket.num_edges, 4)
    jdev = jax.device_put(jdc.build_device_graphset(jgs))
    tdev = tdc.device_graphset_to(tdc.build_device_graphset(gs), "cpu")
    jm, tm, jp, state = _models(gs, key=5)
    net = DGCNNNet(tm, state_to_params(state))
    opt = optax.adam(1e-3)
    opt_state = opt.init(jp)

    @jax.jit
    def jstep(p, s, idx, key):
        b = jdc.gather_coo_batch(jdev, idx, jbucket)

        def loss_fn(p):
            lp = jax_apply_coo(p, jm, b, deterministic=False, dropout_rng=key)
            return jax_nll(lp, b.y, b.graph_mask)[0]

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    optimizer = make_optimizer(net)
    gen = torch.Generator().manual_seed(0)
    for i, idx in enumerate(rows):
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.asarray(idx), jax.random.PRNGKey(i))
        tb = tdc.gather_coo_batch(tdev, torch.from_numpy(idx), bucket)
        loss, _ = train_step(net, optimizer, tb, gen, spmm_impl="xla")
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    for a, b in zip(leaves(net.params()), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def _cfg(tmp_path, **kw):
    base = dict(
        data_type="DD", layout="coo", num_folds=2, num_epochs=2, batch_size=8,
        data_root=str(tmp_path / "data"),
        statistics_dir=str(tmp_path / "statistics"),
        epochs_dir=str(tmp_path / "epochs"),
    )
    return Config(**{**base, **kw})


@pytest.mark.parametrize("spmm_impl", ["auto", "pallas"])
def test_device_coo_engine_equals_host_engine(tmp_path, spmm_impl):
    """DeviceCooEngine and CooEngine (geometric vs worst-case buckets; for
    pallas the host engine attaches structures) train the same: equal epoch
    rows and parameters."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=4)
    kw = dict(data_type="MUTAG", batch_size=8, node_pad_multiple=128,
              edge_pad_multiple=128, graph_pad_multiple=4)
    host = cv.CooEngine(Config(coo_assembly="host", spmm_impl=spmm_impl, **kw), gs, "cpu")
    dev = cv.DeviceCooEngine(Config(**kw), gs, "cpu")
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    results = []
    for engine in (host, dev):
        engine.begin_fold(np.arange(24), np.arange(24, 30))
        net = DGCNNNet(model, cv.init_params(torch.Generator().manual_seed(0), model))
        opt = make_optimizer(net)
        gen = torch.Generator().manual_seed(7)
        rows = engine.run_epochs(net, opt, gen, [np.random.default_rng(e).permutation(24)
                                                 for e in range(3)])
        results.append((rows, [p.detach() for p in net.parameters()]))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(results[1][1], results[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_engine_choice_follows_reference():
    gs = synthesize_tu_dataset("MUTAG", num_graphs=12, seed=1)
    pick = {
        (impl, asm): type(cv.make_engine(Config(data_type="MUTAG", spmm_impl=impl,
                                                coo_assembly=asm), gs, "cpu", "coo"))
        for impl in ("auto", "xla", "onehot", "pallas") for asm in ("device", "host")
    }
    for (impl, asm), cls in pick.items():
        want = cv.CooEngine if impl == "pallas" or asm == "host" else cv.DeviceCooEngine
        assert cls is want, (impl, asm)
    assert Config().resolved_spmm_impl() in ("xla", "onehot")
    assert Config(spmm_impl="onehot").resolved_spmm_impl() == "onehot"


def test_coo_engine_pads_structures_to_the_epochs_largest_batch():
    """Under pallas, CooEngine pads an epoch's block-pair structures to that
    epoch's largest batch; the reference's padding to `blockcoo_item_bound`
    (one XLA shape per run) only appends sentinel items and null slots to
    the same arrays."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=4)
    eng = cv.CooEngine(Config(data_type="MUTAG", batch_size=8, spmm_impl="pallas"),
                       gs, "cpu")
    order = np.random.default_rng(0).permutation(30)
    s, w_pad, w_padT = eng.pack_host(gs, order).blockcoo
    real = np.stack([s.row_ptr[:, -1], s.row_ptrT[:, -1]])
    w = s.ls.shape[1]
    assert w == real.max() and (real < w).any()
    bound = tpk.blockcoo_item_bound(gs, 8)
    assert bound > w
    ref_s, ref_w, ref_wT = tpk.add_blockcoo(
        tpk.pack_epoch(gs, order, 8, eng.bucket), pad_items_to=bound).blockcoo
    nb = eng.bucket.num_nodes // 128
    for f in type(s).ARRAYS:
        got, want = getattr(s, f), getattr(ref_s, f)
        if f in ("row_ptr", "row_ptrT"):
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_array_equal(got, want[:, :w], err_msg=f)
        tail = want[:, w:]
        sentinel = {"item_r": nb, "perm": -1, "permT": -1}.get(f, 0)
        assert (tail == sentinel).all(), f
    for got, want in ((w_pad, ref_w), (w_padT, ref_wT)):
        np.testing.assert_array_equal(got, want[:, :w])
        assert not want[:, w:].any()


@pytest.mark.parametrize("spmm_impl,assembly", [("auto", "device"), ("pallas", "device"),
                                                ("onehot", "host")])
def test_coo_cv_run_writes_reference_artifacts(tmp_path, spmm_impl, assembly):
    gs = synthesize_tu_dataset("DD", num_graphs=24, seed=3)
    res = cv.run_cross_validation(
        _cfg(tmp_path, spmm_impl=spmm_impl, coo_assembly=assembly), dataset=gs,
        device="cpu")
    assert len(res["test_accuracies"]) == 2
    stats = tmp_path / "statistics"
    for fold in (1, 2):
        lines = (stats / f"DD_results_{fold}.csv").read_text().splitlines()
        assert lines[0] == "epoch," + ",".join(JFoldMetrics.COLUMNS)
        rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
        assert rows.shape == (2, 5) and np.isfinite(rows).all()
        assert set(load_checkpoint(str(tmp_path / "epochs" / f"DD_{fold}"))) == {
            "params", "opt_state"}
    events = [json.loads(ln) for ln in (stats / "DD_events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["run_start"] + ["epoch"] * 4 + ["run_end"]
    assert events[0]["layout"] == "coo"
    assert events[0]["spmm_impl"] == Config(spmm_impl=spmm_impl).resolved_spmm_impl()


def test_cli_cpu_coo_run(tmp_path):
    res = cli.main(["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
                    "--num_folds", "2", "--num_epochs", "1", "--layout", "coo",
                    "--spmm", "pallas",
                    "--data_root", str(tmp_path / "data"), "--out_root", str(tmp_path)])
    assert len(res["train_accuracies"]) == 2
    events = [json.loads(ln) for ln in
              (tmp_path / "statistics" / "MUTAG_events.jsonl").read_text().splitlines()]
    assert events[0]["layout"] == "coo" and events[0]["spmm_impl"] == "pallas"
    assert (tmp_path / "epochs" / "MUTAG_2.npz").exists()
