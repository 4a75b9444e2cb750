"""The port's DGCNN on the block-sparse layout (apply_block,
models/dgcnn.py) against JAX `apply_block` (block_impl xla): weights
carried across with `params_from_jax`, activations and parameter
gradients on synthetic DD and COLLAB batches, the global SortPooling
with its row-block prefilter on tie-heavy keys, a 5-step Adam trajectory,
and the block-layout CV driver and CLI on the CPU."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_block as jax_apply_block
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.ops.sort_pool import sort_pool as jax_sort_pool
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu.train.metrics import FoldMetrics as JFoldMetrics
from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, apply_block, leaves
from dgcnn_tpu_torch.ops.sort_pool import sort_pool
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import make_optimizer, nll_loss_and_correct, train_step
from dgcnn_tpu_torch.utils.checkpoint import load_checkpoint

ACTS = ("gcn1", "gcn2", "gcn3", "gcn4", "sort_pool", "log_probs")


@functools.lru_cache(maxsize=None)
def _data(name, n_graphs=20, seed=4):
    gs = synthesize_tu_dataset(name, num_graphs=n_graphs, seed=seed)
    jset = jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(gs))
    tset = tbs.block_graphset_to_device(tbs.build_block_graphset(gs), "cpu")
    return gs, jset, tset


def _batches(name, idx, headroom=(3, 11)):
    gs, jset, tset = _data(name)
    idx = np.asarray(idx, np.int32)
    nb, w = tbs.block_batch_extents(np.asarray(jset.nb), np.asarray(jset.block_count),
                                    idx[None])
    nb, w = nb + headroom[0], w + headroom[1]
    jb = jbs.gather_block_batch(jset, jnp.asarray(idx), nb, w)
    tb = tbs.gather_block_batch(tset, torch.from_numpy(idx), nb, w)
    return gs, jset, tset, jb, tb


def _models(gs, key=0, k=30):
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0, sort_pool_k=k)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0, sort_pool_k=k)
    jp = jax_init(jax.random.PRNGKey(key), jm)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, tm, jp, state


CASES = {
    "DD": [0, 3, 5, -1, 8, 11, -1, 2],
    "COLLAB": [1, 4, -1, 6, 9, 12, 13, -1],
}


@functools.lru_cache(maxsize=None)
def _jax_acts(name):
    gs, jset, _, jb, _ = _batches(name, CASES[name])
    jm, _, jp, _ = _models(gs)
    return jax.jit(lambda p, b, pool: jax_apply_block(
        p, jm, b, pool, return_activations=True, block_impl="xla"))(jp, jb, jset.pool)[1]


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(name):
    gs, jset, _, jb, _ = _batches(name, CASES[name])
    jm, _, jp, _ = _models(gs, key=2)

    def jloss(p):
        lp = jax_apply_block(p, jm, jb, jset.pool, block_impl="xla")
        return jax_nll(lp, jb.y, jb.graph_mask)[0]

    return jax.jit(jax.value_and_grad(jloss))(jp)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(CASES))
def test_activations_match_jax_apply_block(name, impl):
    gs, jset, tset, jb, tb = _batches(name, CASES[name])
    jm, tm, jp, state = _models(gs)
    want = _jax_acts(name)
    _, got = apply_block(state_to_params(state), tm, tb, tset.pool,
                         return_activations=True, block_impl=impl)
    for key in ACTS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{name} {key}")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", list(CASES))
def test_nll_gradients_match_jax(name, impl):
    gs, jset, tset, jb, tb = _batches(name, CASES[name])
    jm, tm, jp, state = _models(gs, key=2)
    jloss_v, jgrads = _jax_loss_grads(name)
    net = DGCNNNet(tm, state_to_params(state))
    lp = net(tb, pool=tset.pool, block_impl=impl)
    loss, _ = nll_loss_and_correct(lp, tb.y, tb.graph_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=1e-5)
    got = [p.grad for p in leaves(net.params())]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_block_forward_needs_the_pool():
    gs, _, tset, _, tb = _batches("DD", CASES["DD"])
    _, tm, _, state = _models(gs)
    net = DGCNNNet(tm, state_to_params(state))
    with pytest.raises(ValueError, match="pool"):
        net(tb)
    with pytest.raises(ValueError, match="block_impl"):
        net(tb, pool=tset.pool, block_impl="other")


@pytest.mark.parametrize("row_block", [0, 8])
@pytest.mark.parametrize("k", [3, 6])
def test_sort_pool_matches_jax_on_ties(k, row_block):
    """Keys drawn from {−1, 0, 1} with ±0 mixed in, graphs laid out in
    runs of 8 nodes (block-row aligned, as the block layout packs them),
    padded runs and a graph smaller than k: the pooled rows must be JAX's
    exactly, and the gradient must reach each kept row once."""
    rng = np.random.default_rng(k + row_block)
    slots, runs = 5, [0, 0, 1, 2, 2, 2, 5, 3, 5, 4]  # 5 = padding
    node_graph = np.repeat(np.asarray(runs, np.int32), 8)
    x = rng.standard_normal((len(node_graph), 4)).astype(np.float32)
    x[:, -1] = rng.integers(-1, 2, len(node_graph)).astype(np.float32)
    x[::7, -1] = -0.0
    node_graph[24:28] = slots  # a partly padded run: graph 2 has 4 nodes here
    want = jax_sort_pool(jnp.asarray(x), jnp.asarray(node_graph), slots, k,
                         row_block=row_block)
    xt = torch.from_numpy(x).requires_grad_()
    got = sort_pool(xt, torch.from_numpy(node_graph), slots, k, row_block=row_block)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(g))
    jg = jax.grad(lambda a: (jax_sort_pool(a, jnp.asarray(node_graph), slots, k,
                                           row_block=row_block) * g).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def test_signed_zero_keys_follow_top_k_order():
    """`lax.top_k` puts +0.0 before −0.0 where a stable sort holds them
    equal; both sort-pools of the port follow top_k (dense: the whole
    selection; packed: the row-block prefilter)."""
    from dgcnn_tpu.ops.sort_pool import sort_pool_dense as jax_dense
    from dgcnn_tpu_torch.ops.sort_pool import sort_pool_dense, top_k_order

    key = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -1.0, -0.0, 0.0]], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(key), 8)
    got_v, got_i = top_k_order(torch.from_numpy(key), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(np.signbit(got_v.numpy()), np.signbit(np.asarray(vals)))

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, 4)).astype(np.float32)
    x[..., -1] = rng.choice(np.array([0.0, -0.0, 1.0], np.float32), (3, 12))
    mask = np.ones((3, 12), np.float32)
    want = jax_dense(jnp.asarray(x), jnp.asarray(mask), 5)
    got = sort_pool_dense(torch.from_numpy(x), torch.from_numpy(mask), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_five_adam_steps_match_jax_block_step():
    gs, jset, tset = _data("DD")
    order = np.random.default_rng(0).permutation(gs.num_graphs)
    rows = [np.concatenate([order[i * 3 : i * 3 + 3], [-1]]).astype(np.int32)
            for i in range(5)]
    nb, w = tbs.block_batch_extents(np.asarray(jset.nb), np.asarray(jset.block_count),
                                    np.stack(rows))
    nb, w = cv._geom_round(nb, 8), cv._geom_round(w, 64)
    jm, tm, jp, state = _models(gs, key=5)
    net = DGCNNNet(tm, state_to_params(state))
    opt = optax.adam(1e-3)
    opt_state = opt.init(jp)

    @jax.jit
    def jstep(p, s, idx, key):
        b = jbs.gather_block_batch(jset, idx, nb, w)

        def loss_fn(p):
            lp = jax_apply_block(p, jm, b, jset.pool, deterministic=False,
                                 dropout_rng=key, block_impl="xla")
            return jax_nll(lp, b.y, b.graph_mask)[0]

        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    optimizer = make_optimizer(net)
    gen = torch.Generator().manual_seed(0)
    for i, idx in enumerate(rows):
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.asarray(idx), jax.random.PRNGKey(i))
        tb = tbs.gather_block_batch(tset, torch.from_numpy(idx), nb, w)
        loss, _ = train_step(net, optimizer, tb, gen, pool=tset.pool, block_impl="pallas")
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, err_msg=f"step {i}")
    for a, b in zip(leaves(net.params()), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def _cfg(tmp_path, **kw):
    base = dict(
        data_type="DD", layout="block", num_folds=2, num_epochs=2, batch_size=10,
        data_root=str(tmp_path / "data"),
        statistics_dir=str(tmp_path / "statistics"),
        epochs_dir=str(tmp_path / "epochs"),
    )
    return Config(**{**base, **kw})


def test_block_cv_run_writes_reference_artifacts(tmp_path):
    gs = synthesize_tu_dataset("DD", num_graphs=36, seed=3)
    res = cv.run_cross_validation(_cfg(tmp_path), dataset=gs, device="cpu")
    assert len(res["test_accuracies"]) == 2
    stats = tmp_path / "statistics"
    for fold in (1, 2):
        lines = (stats / f"DD_results_{fold}.csv").read_text().splitlines()
        assert lines[0] == "epoch," + ",".join(JFoldMetrics.COLUMNS)
        rows = np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])
        assert rows.shape == (2, 5) and np.isfinite(rows).all()
        bundle = load_checkpoint(str(tmp_path / "epochs" / f"DD_{fold}"))
        assert set(bundle) == {"params", "opt_state"}
    overall = (stats / "DD_results_overall.csv").read_text().splitlines()
    assert overall[0] == "fold,train_accuracy,test_accuracy" and len(overall) == 3
    events = [json.loads(ln) for ln in (stats / "DD_events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in events] == ["run_start"] + ["epoch"] * 4 + ["run_end"]
    assert events[0]["layout"] == "block"
    assert events[0]["block_impl"] == Config().resolved_block_impl()

    # the other kernel's plain version is the same function: the same run
    again = cv.run_cross_validation(
        _cfg(tmp_path, block_impl="xla", statistics_dir=str(tmp_path / "s2"),
             epochs_dir=str(tmp_path / "e2")),
        dataset=gs, device="cpu",
    )
    assert again["test_accuracies"] == res["test_accuracies"]
    assert (tmp_path / "s2" / "DD_results_1.csv").read_text() == (
        stats / "DD_results_1.csv").read_text()


def test_block_impl_resolution():
    assert Config().resolved_block_impl() in ("pallas", "xla")
    assert Config(block_impl="xla").resolved_block_impl() == "xla"
    assert Config(block_impl="pallas").resolved_block_impl() == "pallas"
    with pytest.raises(ValueError):
        Config(block_impl="other")


def test_cli_cpu_block_run(tmp_path):
    res = cli.main(["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
                    "--num_folds", "2", "--num_epochs", "1", "--layout", "block",
                    "--block_impl", "xla", "--data_root", str(tmp_path / "data"),
                    "--out_root", str(tmp_path)])
    assert len(res["train_accuracies"]) == 2
    events = [json.loads(ln) for ln in
              (tmp_path / "statistics" / "MUTAG_events.jsonl").read_text().splitlines()]
    assert events[0]["layout"] == "block" and events[0]["block_impl"] == "xla"
    assert (tmp_path / "epochs" / "MUTAG_2.npz").exists()
