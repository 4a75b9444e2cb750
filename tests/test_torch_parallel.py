"""The port's (data, graph) process grid (dgcnn_tpu_torch/parallel)
against the JAX package's mesh (dgcnn_tpu/parallel) on conftest's
8-device virtual CPU mesh: the re-layout functions field by field, and
the sharded losses, gradients and one DP epoch of ranks that run as
`gloo` subprocesses (tests/torch_mesh_worker.py), held against JAX at the
same mesh and against the port's own single-process path. Mirrors
tests/test_parallel.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import device_coo as jdc
from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.batching.block_sparse import build_block_graphset as jbuild_block
from dgcnn_tpu.batching.dense import build_dense_dataset as jbuild_dense
from dgcnn_tpu.batching.dense import order_matrix_dp as jorder_matrix_dp
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jinit
from dgcnn_tpu.parallel import make_mesh as jmake_mesh
from dgcnn_tpu.parallel import make_sharded_loss as jsharded_loss
from dgcnn_tpu.parallel import shard as jshard
from dgcnn_tpu.parallel import train_dp as jtrain_dp
from dgcnn_tpu_torch.batching import device_coo as tdc
from dgcnn_tpu_torch.batching import packer as tpk
from dgcnn_tpu_torch.batching.block_sparse import block_batch_extents, build_block_graphset
from dgcnn_tpu_torch.batching.dense import dense_tile, order_matrix_dp
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet
from dgcnn_tpu_torch.parallel import mesh, shard
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train.loop import make_optimizer, nll_loss_and_correct, train_step
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

MESHES = [(2, 1), (1, 2), (2, 2)]
LOSS = dict(data="MUTAG", graphs=48, seed=0)  # the reference's _setup
EPOCH = dict(data="MUTAG", graphs=32, seed=4, batch=16)
DENSE = dict(data="MUTAG", graphs=40, seed=3)
COO = dict(data="MUTAG", graphs=24, seed=3)
BLOCK = dict(data="DD", graphs=14, seed=3)


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


@functools.lru_cache(maxsize=None)
def _gs(data, graphs, seed):
    return synthesize_tu_dataset(data, num_graphs=graphs, seed=seed)


@functools.lru_cache(maxsize=None)
def _jparams(data, graphs, seed, key=5):
    gs = _gs(data, graphs, seed)
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    return jm, jinit(jax.random.PRNGKey(key), jm)


def _state(spec):
    _, jp = _jparams(spec["data"], spec["graphs"], spec["seed"])
    return {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                            jp)).items()}


def _net(spec, dropout=0.5):
    gs = _gs(spec["data"], spec["graphs"], spec["seed"])
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                  dropout_rate=dropout)
    return DGCNNNet(model, state_to_params({k: torch.from_numpy(v)
                                            for k, v in _state(spec).items()}))


def _lpt_rows(weights, idx, n_data):
    slots = -(-len(idx) // n_data)
    return shard.balanced_rows(weights, np.asarray(idx), n_data, slots)


def _coo_bucket(gs, rows, n_graph):
    nc, ec = gs.node_counts(), gs.edge_counts()
    bn = int(nc[np.maximum(rows, 0)].sum(1).max())
    be = int(ec[np.maximum(rows, 0)].sum(1).max())
    return (-(-bn // 64) * 64, -(-be // (64 * n_graph)) * (64 * n_graph), rows.shape[1])


def _block_budget(gs, rows):
    host = build_block_graphset(gs)
    nb, w = block_batch_extents(host.nb.astype(np.int64),
                                host.block_count.astype(np.int64), rows)
    return max(nb, 8), max(w, 8)


def _jobs(mesh_shape, tmp):
    d, g = mesh_shape
    params = {}
    for name, spec in (("loss", LOSS), ("epoch", EPOCH), ("dense", DENSE), ("coo", COO),
                       ("block", BLOCK)):
        params[name] = str(tmp / f"{name}.npz")
        np.savez(params[name], **_state(spec))
    coo_rows = _lpt_rows(_gs(**COO).node_counts(), np.arange(20), d)
    block_gs = _gs(**BLOCK)
    block_rows = _lpt_rows(build_block_graphset(block_gs).block_count.astype(np.int64),
                           np.arange(12), d)
    spec = {"mesh": list(mesh_shape)}
    jobs = [
        {"name": "loss", "kind": "coo_loss", **LOSS, **spec, "params": params["loss"],
         "idx": list(range(20)), "grads": True},
        {"name": "epoch", "kind": "epoch", **EPOCH, **spec, "params": params["epoch"],
         "order": list(range(32))},
        {"name": "dense", "kind": "engine_loss", "layout": "dense", **DENSE, **spec,
         "params": params["dense"],
         "rows": order_matrix_dp(np.arange(16), 16, d, -(-16 // d))[0].tolist()},
        {"name": "coo", "kind": "engine_loss", "layout": "coo", **COO, **spec,
         "params": params["coo"], "rows": coo_rows.tolist(),
         "bucket": list(_coo_bucket(_gs(**COO), coo_rows, g))},
        {"name": "block", "kind": "engine_loss", "layout": "block", **BLOCK, **spec,
         "params": params["block"], "rows": block_rows.tolist(),
         "budget": list(_block_budget(block_gs, block_rows))},
    ]
    if mesh_shape == (2, 1):
        jobs.append({"name": "mismatch", "kind": "mismatch", "mesh": [2, 2]})
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh's ranks' results: {mesh: [rank 0's, rank 1's, ...]}."""
    out = {}
    for m in MESHES:
        tmp = tmp_path_factory.mktemp(f"mesh{m[0]}x{m[1]}")
        out[m] = torch_mesh_worker.spawn(tmp, m[0] * m[1], _jobs(m, tmp))
    return out


# -- the re-layout, in process ------------------------------------------------


@pytest.mark.parametrize("seed,n_shards,cap", [(0, 4, 2), (1, 3, 4), (2, 2, 9), (3, 5, 3)])
def test_lpt_assign_equals_reference(seed, n_shards, cap):
    counts = np.random.default_rng(seed).integers(1, 60, size=min(n_shards * cap, 17))
    got = shard.lpt_assign(counts, n_shards, cap)
    want = jshard.lpt_assign(counts, n_shards, cap)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert sorted(np.concatenate(got).tolist()) == list(range(len(counts)))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_pack_epoch_dp_equals_jax_field_by_field(mesh_shape):
    d, g = mesh_shape
    gs = _gs("MUTAG", 40, 1)
    order = np.random.default_rng(2).permutation(40)
    bucket = shard.shard_bucket(gs, 16, d, n_graph=g)
    jbucket = jshard.shard_bucket(_jset(gs), 16, d, n_graph=g)
    assert (bucket.num_nodes, bucket.num_edges, bucket.num_graphs) == (
        jbucket.num_nodes, jbucket.num_edges, jbucket.num_graphs)
    got = shard.pack_epoch_dp(gs, order, 16, bucket, d, g)
    want = jshard.pack_epoch_dp(_jset(gs), order, 16, jbucket, d, g)
    for name in tpk.ARRAY_FIELDS:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_local_view_is_the_ranks_selection_and_checks_the_grid():
    gs = _gs("MUTAG", 40, 1)
    bucket = shard.shard_bucket(gs, 16, 2, n_graph=2)
    epoch = shard.pack_epoch_dp(gs, np.arange(40), 16, bucket, 2, 2)
    step = tpk.batch_step(epoch, 1)
    for d in range(2):
        for g in range(2):
            one = shard.local_view(step, d, g, 2, 2)
            many = shard.local_view(epoch, d, g, 2, 2, steps=True)
            np.testing.assert_array_equal(one.x, epoch.x[1, d])
            np.testing.assert_array_equal(one.edge_dst, epoch.edge_dst[1, d, g])
            np.testing.assert_array_equal(many.edge_src, epoch.edge_src[:, d, g])
    with pytest.raises(ValueError, match="different mesh shape"):
        shard.local_view(step, 0, 0, 4, 2)
    with pytest.raises(ValueError, match="different mesh shape"):
        shard.local_view(step, 0, 0, 2, 1)


@pytest.mark.parametrize("n_data,slots", [(2, 8), (3, 6), (4, 4)])
def test_order_matrix_dp_equals_jax(n_data, slots):
    order = np.random.default_rng(n_data).permutation(37)
    np.testing.assert_array_equal(order_matrix_dp(order, 16, n_data, slots),
                                  jorder_matrix_dp(order, 16, n_data, slots))


@pytest.mark.parametrize("n_graph", [1, 2, 4])
def test_windowed_gather_coo_batch_equals_jax(n_graph):
    """Each graph rank's window of the device-assembled batch equals JAX's
    windowed assembly, and the windows laid end to end are the whole
    batch's stream."""
    gs = _gs("MUTAG", 24, 3)
    idx = np.array([3, 0, 7, 11, 5, -1], dtype=np.int32)
    bucket = tpk.BucketSpec(256, 128 * 4, 6)
    chunk = bucket.num_edges // n_graph
    dev = tdc.device_graphset_to(tdc.build_device_graphset(gs), "cpu")
    jdev = jax.device_put(jdc.build_device_graphset(_jset(gs)))
    whole = tdc.gather_coo_batch(dev, torch.from_numpy(idx), bucket)
    parts = []
    for g in range(n_graph):
        win = (g * chunk, chunk)
        got = tdc.gather_coo_batch(dev, torch.from_numpy(idx), bucket, edge_window=win)
        want = jdc.gather_coo_batch(jdev, jnp.asarray(idx),
                                    jpk.BucketSpec(256, 512, 6), edge_window=win)
        for name in tpk.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        parts.append(got)
    for name in shard.EDGE_FIELDS:
        np.testing.assert_array_equal(
            torch.cat([getattr(p, name) for p in parts]).numpy(),
            getattr(whole, name).numpy(), err_msg=name)


def test_device_grid_is_row_major_and_refuses_another_world_size():
    np.testing.assert_array_equal(mesh.device_grid((2, 3), 6),
                                  np.arange(6).reshape(2, 3))
    with pytest.raises(ValueError, match="needs exactly 4 ranks.*has 2"):
        mesh.device_grid((2, 2), 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh((2, 1), "cpu")
    one = mesh.make_mesh((1, 1), "cpu")
    assert (one.d, one.g, one.data_group, one.graph_group) == (0, 0, None, None)


# -- the ranks, as gloo subprocesses ------------------------------------------


def _single_coo_loss(spec, idx, grads=False):
    """The port's single-process loss (and gradients) of the global batch."""
    gs = _gs(spec["data"], spec["graphs"], spec["seed"])
    b = tpk.batch_to_device(tpk.pack_batch(gs, idx, tpk.compute_bucket(gs, len(idx))),
                            "cpu")
    net = _net(spec)
    loss, correct = nll_loss_and_correct(net(b), b.y, b.graph_mask)
    if grads:
        loss.backward()
        return loss, correct, {n: p.grad.numpy() for n, p in net.named_parameters()}
    return loss, correct


@functools.lru_cache(maxsize=None)
def _jax_sharded(mesh_shape, grads=False):
    d, g = mesh_shape
    gs = _gs(**LOSS)
    jm, jp = _jparams(**LOSS)
    m = jmake_mesh(mesh_shape)
    bucket = jshard.shard_bucket(_jset(gs), 20, d, n_graph=g)
    sb = jax.tree_util.tree_map(
        jnp.asarray, jshard.shard_batch_for_dp(_jset(gs), np.arange(20), bucket, d, g))
    loss_fn = jsharded_loss(jm, m, deterministic=True)
    if grads:
        return jax.jit(jax.grad(lambda p: loss_fn(p, sb, jax.random.PRNGKey(0))[0]))(jp)
    return jax.device_get(jax.jit(loss_fn)(jp, sb, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_loss_matches_jax_and_single_process(ranks, mesh_shape):
    want_loss, want_correct = _jax_sharded(mesh_shape)
    single, single_correct = _single_coo_loss(LOSS, np.arange(20))
    for r, res in enumerate(ranks[mesh_shape]):
        np.testing.assert_allclose(res["loss/loss"], want_loss, rtol=1e-5,
                                   err_msg=f"{mesh_shape} rank {r}")
        assert float(res["loss/correct"]) == float(want_correct)
        np.testing.assert_allclose(res["loss/loss"], single.item(), rtol=1e-5)
        assert float(res["loss/correct"]) == single_correct.item()


def test_sharded_gradients_match_jax_at_2x2(ranks):
    want = _jax_sharded((2, 2), grads=True)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    for r, res in enumerate(ranks[(2, 2)]):
        for name, w in state.items():
            np.testing.assert_allclose(res[f"loss/grad/{name}"], w.numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_gradients_match_single_process_and_agree_across_ranks(ranks, mesh_shape):
    _, _, want = _single_coo_loss(LOSS, np.arange(20), grads=True)
    first = ranks[mesh_shape][0]
    for r, res in enumerate(ranks[mesh_shape]):
        for name, w in want.items():
            np.testing.assert_allclose(res[f"loss/grad/{name}"], w, rtol=2e-4, atol=1e-6,
                                       err_msg=f"{mesh_shape} rank {r} {name}")
            np.testing.assert_array_equal(res[f"loss/grad/{name}"],
                                          first[f"loss/grad/{name}"])


def _single_epoch():
    gs = _gs(EPOCH["data"], EPOCH["graphs"], EPOCH["seed"])
    net = _net(EPOCH, dropout=0.0)
    opt = make_optimizer(net)
    bucket = tpk.compute_bucket(gs, 16)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i in (0, 16):
        b = tpk.batch_to_device(tpk.pack_batch(gs, np.arange(i, i + 16), bucket), "cpu")
        losses.append(train_step(net, opt, b, gen)[0])
    return torch.stack(losses).mean().item(), {n: p.detach().numpy()
                                               for n, p in net.named_parameters()}


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_dp_epoch_matches_the_single_process_epoch(ranks, mesh_shape):
    """One DP training epoch (dropout 0, two steps of 16 graphs) against the
    port's single-process epoch; the replicas bitwise equal."""
    want_loss, want = _single_epoch()
    first = ranks[mesh_shape][0]
    for r, res in enumerate(ranks[mesh_shape]):
        np.testing.assert_allclose(res["epoch/loss"], want_loss, rtol=3e-4, atol=2e-6)
        for name, w in want.items():
            np.testing.assert_allclose(res[f"epoch/param/{name}"], w, rtol=3e-4,
                                       atol=2e-6, err_msg=f"{mesh_shape} rank {r} {name}")
            np.testing.assert_array_equal(res[f"epoch/param/{name}"],
                                          first[f"epoch/param/{name}"])


def _jax_engine_loss(layout, mesh_shape):
    d, g = mesh_shape
    m = jmake_mesh(mesh_shape)
    if layout == "dense":
        gs = _gs(**DENSE)
        jm, jp = _jparams(**DENSE)
        data = jax.device_put(jbuild_dense(_jset(gs), dense_tile(gs)))
        rows = jorder_matrix_dp(np.arange(16), 16, d, -(-16 // d))[0]
        fn = jtrain_dp._make_dense_dp_loss(jm, m, True)
    elif layout == "coo":
        gs = _gs(**COO)
        jm, jp = _jparams(**COO)
        rows = _lpt_rows(gs.node_counts(), np.arange(20), d)
        data = jax.device_put(jdc.build_device_graphset(_jset(gs)))
        fn = jtrain_dp._make_device_coo_dp_loss(
            jm, m, jpk.BucketSpec(*_coo_bucket(gs, rows, g)), "xla", True)
    else:
        gs = _gs(**BLOCK)
        jm, jp = _jparams(**BLOCK)
        host = jbuild_block(_jset(gs))
        rows = _lpt_rows(host.block_count.astype(np.int64), np.arange(12), d)
        data = jax.device_put(host)
        fn = jtrain_dp._make_block_dp_loss(jm, m, *_block_budget(gs, rows), True)
    return jax.device_get(jax.jit(fn)(jp, data, rows, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("layout,mesh_shape", [("dense", (2, 1)), ("coo", (2, 2)),
                                               ("block", (2, 1))])
def test_engine_dp_losses_match_jax(ranks, layout, mesh_shape):
    """The engines' DP losses (each rank gathering its own sub-batch; the
    device COO one only its edge window) against the reference's."""
    want_loss, want_correct = _jax_engine_loss(layout, mesh_shape)
    for r, res in enumerate(ranks[mesh_shape]):
        np.testing.assert_allclose(res[f"{layout}/loss"], want_loss, rtol=1e-5,
                                   err_msg=f"{layout} {mesh_shape} rank {r}")
        assert float(res[f"{layout}/correct"]) == float(want_correct)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("layout", ["dense", "coo", "block"])
def test_engine_dp_losses_agree_across_meshes_and_ranks(ranks, layout, mesh_shape):
    base = ranks[(2, 1)][0]
    for res in ranks[mesh_shape]:
        if mesh_shape[0] == 2:  # the same sub-batches as (2, 1)
            np.testing.assert_allclose(res[f"{layout}/loss"], base[f"{layout}/loss"],
                                       rtol=1e-5)
        np.testing.assert_array_equal(res[f"{layout}/loss"],
                                      ranks[mesh_shape][0][f"{layout}/loss"])


def test_a_grid_of_another_size_than_the_world_raises(ranks):
    for res in ranks[(2, 1)]:
        assert "needs exactly 4 ranks" in str(res["mismatch/error"])


def test_a_one_rank_dp_run_is_the_single_device_runner_and_an_empty_test_gives_0():
    """The DP runner on a one-rank grid (no process group: nothing to sum) gives
    the single-device fused runner's rows and parameters over the same
    orders, and 0 in both test columns for an empty test stream (the
    reference's `has_eval`)."""
    from dgcnn_tpu_torch.batching.dense import build_dense_dataset, order_matrix
    from dgcnn_tpu_torch.parallel.train_dp import make_dense_dp_run
    from dgcnn_tpu_torch.train.loop import make_dense_gather_run

    gs = _gs(**DENSE)
    data = build_dense_dataset(gs, dense_tile(gs), "cpu")
    grid = mesh.ProcessGrid((1, 1), 0, torch.device("cpu"))
    order = np.random.default_rng(0).permutation(gs.num_graphs)
    test = np.arange(8)
    nets = [_net(DENSE, dropout=0.0) for _ in range(3)]
    gens = [torch.Generator().manual_seed(1) for _ in range(3)]
    dp = make_dense_dp_run(nets[0], make_optimizer(nets[0]), data, grid,
                           order_matrix_dp(test, 16, 1, 16), gens[0], steps=3)
    got = dp.run_epochs(order_matrix_dp(order, 16, 1, 16)[None])
    single = make_dense_gather_run(nets[1], make_optimizer(nets[1]), data,
                                   order_matrix(test, 16, 16), 3, gens[1])
    want = single.run_epochs(order_matrix(order, 16, 16)[None])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-7)
    empty = make_dense_dp_run(nets[2], make_optimizer(nets[2]), data, grid,
                              np.zeros((0, 1, 16), np.int32), gens[2], steps=3)
    rows = empty.run_epochs(order_matrix_dp(order, 16, 1, 16)[None])
    assert rows[0, 1] == 0 and rows[0, 3] == 0 and np.isfinite(rows).all()
