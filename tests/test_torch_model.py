"""The port's DGCNN (dgcnn_tpu_torch/models/dgcnn.py) against JAX
`apply_dense`: weights carried across with `params_from_jax`, activations
on all eight profiles' feature shapes, gradients of the masked NLL, the
sort-pool / MaxPool tie contracts, and the init bounds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching.dense import dense_tile, pack_dense_batch as jax_pack
from dgcnn_tpu.data.synthetic import PROFILES
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_dense as jax_apply_dense
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.models.dgcnn import num_params as jax_num_params
from dgcnn_tpu.ops.readout import conv1d_readout as jax_readout
from dgcnn_tpu.ops.sort_pool import sort_pool_dense as jax_sort_pool
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu_torch.batching.dense import batch_to_device, pack_dense_batch
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN,
    DGCNNNet,
    apply_dense,
    init_params,
    leaves,
    num_params,
)
from dgcnn_tpu_torch.ops.readout import conv1d_readout
from dgcnn_tpu_torch.ops.sort_pool import sort_pool_dense
from dgcnn_tpu_torch.parity.convert import params_from_jax, params_to_jax, state_to_params
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct

ACTS = ("gcn1", "gcn2", "gcn3", "gcn4", "sort_pool", "readout", "log_probs")


def _setup(name, num_graphs=12, slots=8, seed=7, key=0):
    gs = synthesize_tu_dataset(name, num_graphs=num_graphs, seed=seed)
    idx = np.arange(min(slots, num_graphs) - 1)  # one padded slot
    n_tile = dense_tile(gs)
    jb = jax.device_put(jax_pack(gs, idx, n_tile, slots))
    tb = batch_to_device(pack_dense_batch(gs, idx, n_tile, slots), "cpu")
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=0.0)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=0.0)
    jp = jax_init(jax.random.PRNGKey(key), jm)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return gs, jb, tb, jm, tm, jp, state


@pytest.mark.parametrize("name", list(PROFILES))
def test_activations_match_jax_all_feature_shapes(name):
    _, jb, tb, jm, tm, jp, state = _setup(name)
    _, want = jax_apply_dense(jp, jm, jb, return_activations=True)
    _, got = apply_dense(state_to_params(state), tm, tb, return_activations=True)
    for key in ACTS:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6,
            err_msg=f"{name} {key}",
        )


@pytest.mark.parametrize("name", ["MUTAG", "PROTEINS", "IMDB-BINARY"])
def test_nll_gradients_match_jax_grad(name):
    _, jb, tb, jm, tm, jp, state = _setup(name, key=3)

    def jloss(p):
        lp = jax_apply_dense(p, jm, jb)
        return jax_nll(lp, jb.y, jb.graph_mask)[0]

    jloss_v, jgrads = jax.value_and_grad(jloss)(jp)
    net = DGCNNNet(tm, state_to_params(state))
    lp = net(tb)
    loss, _ = nll_loss_and_correct(lp, tb.y, tb.graph_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss_v), rtol=1e-5)
    got = [p.grad for p in leaves(net.params())]
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_degree_only_ties_pin_sort_order_and_maxpool_grad():
    """IMDB features are degree-only, so keys tie: the pooled rows must be
    the reference's (lower node index first) and the MaxPool gradient must
    go to the first of each tied pair, as the reference's does."""
    rng = np.random.default_rng(0)
    x = np.round(rng.random((3, 12, 5)) * 2).astype(np.float32)  # many ties
    mask = (rng.random((3, 12)) > 0.2).astype(np.float32)
    for k in (5, 16):
        want = np.asarray(jax_sort_pool(jnp.asarray(x), jnp.asarray(mask), k))
        got = sort_pool_dense(torch.from_numpy(x), torch.from_numpy(mask), k)
        np.testing.assert_array_equal(got.numpy(), want)

    pooled = np.repeat(rng.random((2, 1, 6)).astype(np.float32), 30, axis=1)
    w5 = rng.normal(size=(6, 4)).astype(np.float32)
    b5 = np.abs(rng.normal(size=4)).astype(np.float32)
    w6 = rng.normal(size=(5, 4, 3)).astype(np.float32)
    b6 = rng.normal(size=3).astype(np.float32)
    g = rng.normal(size=(2, 11 * 3)).astype(np.float32)
    want = jax.grad(
        lambda p, w: (jax_readout(p, w, jnp.asarray(b5), jnp.asarray(w6),
                                  jnp.asarray(b6)) * g).sum(), argnums=(0, 1)
    )(jnp.asarray(pooled), jnp.asarray(w5))
    p_t = torch.from_numpy(pooled).requires_grad_()
    w_t = torch.from_numpy(w5).requires_grad_()
    out = conv1d_readout(p_t, w_t, torch.from_numpy(b5), torch.from_numpy(w6),
                         torch.from_numpy(b6))
    (out * torch.from_numpy(g)).sum().backward()
    # select-first: every odd row of the tied pooled sequence gets nothing
    assert torch.count_nonzero(p_t.grad[:, 1:30:2]) == 0
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)

    # the reference's own trunk output on a degree-only batch: same cat in,
    # the same pooled rows out, bit for bit
    _, jb, tb, jm, tm, jp, state = _setup("IMDB-BINARY", num_graphs=10)
    _, want = jax_apply_dense(jp, jm, jb, return_activations=True)
    cat = np.concatenate([np.asarray(want[f"gcn{i}"]) for i in range(1, 5)], -1)
    assert len(np.unique(cat[..., -1])) < cat[..., -1].size // 2  # ties
    got = sort_pool_dense(torch.from_numpy(cat), tb.node_mask, jm.sort_pool_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["sort_pool"]))


@pytest.mark.parametrize("feats,classes", [(8, 2), (38, 2), (1, 3), (90, 2)])
def test_init_bounds_and_counts_match_reference(feats, classes):
    tm = DGCNN(num_features=feats, num_classes=classes)
    jm = JDGCNN(num_features=feats, num_classes=classes)
    params = init_params(torch.Generator().manual_seed(0), tm)
    jp = jax_init(jax.random.PRNGKey(0), jm)
    assert num_params(params) == jax_num_params(jp)
    for a, b in zip(leaves(params), jax.tree_util.tree_leaves(jp)):
        assert tuple(a.shape) == tuple(b.shape)
    # models/dgcnn.py:75-127: glorot for GCN weights, zero GCN biases,
    # kaiming-uniform(√5) = U(±1/√fan_in) elsewhere
    c5, c6 = tm.conv1d_channels
    bounds = [("conv5", tm.concat_dim), ("conv6", c5 * tm.conv1d_kernel),
              ("lin1", tm.flat_dim), ("lin2", tm.dense_dim)]
    dims = (feats, *tm.hidden_dims)
    for i, layer in enumerate(params["gcn"]):
        a = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        assert float(layer["w"].abs().max()) <= a
        assert float(layer["w"].abs().max()) > 0.5 * a
        assert torch.count_nonzero(layer["b"]) == 0
    for name, fan_in in bounds:
        bound = 1.0 / math.sqrt(fan_in)
        for t in params[name].values():
            assert float(t.abs().max()) <= bound
    assert float(params["lin1"]["w"].abs().max()) > 0.9 / math.sqrt(tm.flat_dim)


def test_weight_transfer_round_trips():
    jp = jax_init(jax.random.PRNGKey(1), JDGCNN(num_features=5, num_classes=2))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    state = params_from_jax(tree)
    net = DGCNNNet(DGCNN(num_features=5, num_classes=2),
                   init_params(torch.Generator().manual_seed(0),
                               DGCNN(num_features=5, num_classes=2)))
    net.load_state_dict(state)
    back = params_to_jax(net.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
