"""Mixed precision in the port (compute_dtype and adj_dtype "bfloat16") on
the dense, multi-tile and block layouts, against the reference:

  * storage, bitwise: the dense dataset, the multi-tile classes and the
    block pool at the reference's dtypes (its device builds and
    `pool.astype(bf16)`: round to nearest even from the fp32 build);
  * SortPooling on bf16 keys full of ties: `sort_pool_dense`, `sort_pool`
    and `sort_pool_folds` bitwise JAX's, and `top_k_order`'s indices
    `lax.top_k`'s;
  * the whole model, `apply_dense`, `apply_multi_dense`, `apply_block` and
    the `*_folds` forwards, with JAX's weights and dropout 0, against the
    JAX functions at bf16 compute and at a bf16 adjacency. Log-probs
    within 5e-3: both round each layer's output (bf16 compute) or the
    propagation's operands (bf16 adjacency) to bf16 at the same points,
    from fp32 sums taken in other orders, so a value can cross a rounding
    boundary (one bf16 ulp, 2^-8 relative) and carry it to the log-probs.
    Gradients within 1e-2 of the largest gradient, element by element, and
    1e-2 of the whole gradient's norm: besides that noise, the two
    backward passes round at different points (the port's trunk rounds
    d_pre before each adjacency product, as the TPU kernel does; JAX's
    autodiff of its einsum chain rounds d_hw after it and the chain's
    cotangents between layers; XLA's bf16 convolution transposes its own
    way), each an error of a few 2^-8 relative, which averages down over
    the sums;
  * training: one short `run_cross_validation` on the CPU per layout and
    driver under bf16 trains with finite losses;
  * the COO layout: bf16 compute raises naming its ROADMAP item, and a
    bf16 `adj_dtype` runs it bit for bit as fp32 (no COO engine reads
    it); the dense lockstep gate and the layout choice answer as the
    reference's at every dtype.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import SMALL

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.batching import multi_dense as jmd
from dgcnn_tpu.batching.dense import build_dense_dataset_on_device
from dgcnn_tpu.batching.dense import gather_dense_batch as jax_gather
from dgcnn_tpu.config import Config as JConfig
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_block as jax_apply_block
from dgcnn_tpu.models.dgcnn import apply_block_folds as jax_apply_block_folds
from dgcnn_tpu.models.dgcnn import apply_dense as jax_apply_dense
from dgcnn_tpu.models.dgcnn import apply_multi_dense as jax_apply_multi
from dgcnn_tpu.models.dgcnn import apply_multi_dense_folds as jax_apply_multi_folds
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.ops.sort_pool import sort_pool as jax_sort_pool
from dgcnn_tpu.ops.sort_pool import sort_pool_dense as jax_sort_pool_dense
from dgcnn_tpu.ops.sort_pool import sort_pool_folds as jax_sort_pool_folds
from dgcnn_tpu.train import cv as jcv
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.batching import multi_dense as md
from dgcnn_tpu_torch.batching.dense import build_dense_dataset, dense_tile, gather_dense_batch
from dgcnn_tpu_torch.batching.multi_dense import MultiDenseBatch
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import (
    DGCNN, DGCNNFoldsNet, DGCNNNet, apply_block, apply_dense, leaves,
)
from dgcnn_tpu_torch.ops.sort_pool import sort_pool, sort_pool_dense, sort_pool_folds, top_k_order
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train import cv
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct
import torch_threads  # noqa: F401  (torch on one CPU thread)

BF16 = torch.bfloat16
DTYPES = [("bfloat16", "float32"), ("float32", "bfloat16")]  # (compute, adj)
DTYPE_IDS = ["compute_bf16", "adj_bf16"]


def _bits(t):
    """(dtype name, raw values) of a torch tensor or a JAX/NumPy array, bf16
    as its 16-bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.dtype == BF16:
            return "bfloat16", t.view(torch.int16).numpy()
        return str(t.dtype).removeprefix("torch."), t.numpy()
    a = np.asarray(t)
    return (("bfloat16", a.view(np.int16)) if a.dtype.name == "bfloat16"
            else (a.dtype.name, a))


def _same_bits(got, want, what):
    (gd, g), (wd, w) = _bits(got), _bits(want)
    assert gd == wd, f"{what}: {gd} != {wd}"
    np.testing.assert_array_equal(g, w, err_msg=what)


def _jax_store(data, compute):
    """The reference's engines' cast under bf16 compute (every float32
    array of the dataset to bf16)."""
    if compute == "float32":
        return data
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, data)


# -- storage -----------------------------------------------------------------

STORE = [("float32", "bfloat16"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("compute,adj", STORE, ids=["adj", "compute", "both"])
def test_dense_dataset_bits_are_the_references_device_build(compute, adj):
    """`build_dense_dataset` at (adj_dtype, compute_dtype) against the
    reference's `build_dense_dataset_on_device(..., adj_dtype)` and its
    engine's compute cast: x, adj, node_mask and y bitwise, dtypes
    included."""
    gs, jgs = (synthesize_tu_dataset("PROTEINS", num_graphs=20, seed=3),
               jax_synth("PROTEINS", num_graphs=20, seed=3))
    t = dense_tile(gs)
    got = build_dense_dataset(gs, t, "cpu", adj, compute)
    want = _jax_store(build_dense_dataset_on_device(jgs, t, adj_dtype=adj), compute)
    for f in ("x", "adj", "node_mask", "y"):
        _same_bits(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("compute,adj", STORE, ids=["adj", "compute", "both"])
def test_multi_classes_bits_are_the_references_device_build(compute, adj):
    """`build_multi_dense_on_device` (fp32 densify, then each class rounded)
    and the host builder against the reference's device build at the same
    adj_dtype and its engine's compute cast, class by class."""
    gs, jgs = (synthesize_tu_dataset("COLLAB", num_graphs=30, seed=3),
               jax_synth("COLLAB", num_graphs=30, seed=3))
    tiles = md.plan_tiles(gs.node_counts(), 32)
    dev, _ = md.build_multi_dense_on_device(gs, tiles, "cpu", adj, compute)
    host, _ = md.build_multi_dense(gs, tiles, "cpu", adj, compute)
    ref, _ = jmd.build_multi_dense_on_device(jgs, tiles, adj_dtype=adj)
    assert len(tiles) >= 3
    for c, (a, b, w) in enumerate(zip(dev, host, _jax_store(ref, compute))):
        for f in ("x", "adj", "node_mask", "y"):
            _same_bits(getattr(a, f), getattr(w, f), f"class {c} {f} device")
            _same_bits(getattr(b, f), getattr(w, f), f"class {c} {f} host")


@pytest.mark.parametrize("compute,adj,want", [
    ("float32", "auto", "float32"), ("float32", "bfloat16", "bfloat16"),
    ("bfloat16", "float32", "bfloat16"), ("bfloat16", "auto", "bfloat16")])
def test_block_pool_is_stored_at_the_propagation_dtype(compute, adj, want):
    """The block engine's pool dtype is the reference's rule (the compute
    dtype when bf16, else the resolved adjacency dtype; `auto` is float32
    here), and a bf16 pool is the reference's `pool.astype(bf16)` bitwise;
    the features stay fp32."""
    gs = synthesize_tu_dataset("DD", num_graphs=8, seed=2)
    cfg = Config(data_type="DD", compute_dtype=compute, adj_dtype=adj, batch_size=4)
    eng = cv.BlockSparseEngine(cfg, gs, torch.device("cpu"))
    assert str(eng.dev.pool.dtype) == f"torch.{want}"
    assert eng.dev.x_blocks.dtype == torch.float32
    ref = jbs.build_block_graphset(gs).pool
    _same_bits(eng.dev.pool, jnp.asarray(ref).astype(jnp.dtype(want)), "pool")


@pytest.mark.parametrize("layout", ["dense", "multi"])
def test_dense_engines_store_the_references_dtypes(layout):
    """The dense and multi-tile engines hold their data at
    `store_dtypes(resolved adj_dtype, compute_dtype)`."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=30, seed=2)
    for compute, adj, want in (("float32", "auto", ("float32",) * 3),
                               ("float32", "bfloat16", ("float32", "bfloat16", "float32")),
                               ("bfloat16", "auto", ("bfloat16",) * 3)):
        cfg = Config(data_type="MUTAG", compute_dtype=compute, adj_dtype=adj,
                     multi_dense_min_tile=16)
        eng = cv.make_engine(cfg, gs, torch.device("cpu"), layout)
        for data in (eng.classes if layout == "multi" else [eng.data]):
            got = tuple(str(getattr(data, f).dtype).removeprefix("torch.")
                        for f in ("x", "adj", "node_mask"))
            assert got == want and data.y.dtype == torch.int32


# -- SortPooling on bf16 keys ------------------------------------------------


def _tie_rows(rng, shape, c):
    """bf16 rows [..., c] whose last channel takes few values (ties
    everywhere, ±0 among them) and whose other channels tell the rows
    apart."""
    x = rng.standard_normal((*shape, c)).astype(np.float32)
    x[..., -1] = np.tanh(rng.integers(-2, 3, shape) * 0.37)
    x[..., -1].flat[::7] = -0.0
    return torch.from_numpy(x).to(BF16)


def test_top_k_order_is_lax_top_k_on_bf16_keys():
    rng = np.random.default_rng(0)
    key = _tie_rows(rng, (6, 40), 1)[..., 0]
    vals, idx = top_k_order(key.float(), 12)
    jv, ji = jax.lax.top_k(jnp.asarray(key.float().numpy()).astype(jnp.bfloat16), 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _same_bits(vals.to(BF16), jv, "values")


def test_sort_pool_dense_on_bf16_ties_is_the_references():
    """The pooled rows and the gradient equal the reference's, value for
    value, in bf16: the port gathers each kept row, the reference takes a
    one-hot product, which turns a −0 key of a kept row into +0 (the
    values are equal; the rows differ in their other channels, so equal
    rows are the same rows)."""
    rng = np.random.default_rng(1)
    x = _tie_rows(rng, (5, 24), 6)
    mask = (rng.random((5, 24)) < 0.8).astype(np.float32)
    mask[3, 4:] = 0  # fewer real nodes than k
    xt = x.clone().requires_grad_()
    got = sort_pool_dense(xt, torch.from_numpy(mask), 10)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = jax_sort_pool_dense(jx, jnp.asarray(mask), 10)
    assert got.dtype == BF16 and np.asarray(want).dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want).astype(np.float32))
    gr = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(torch.from_numpy(gr).to(BF16))
    jg = jax.grad(lambda a: (jax_sort_pool_dense(a, jnp.asarray(mask), 10).astype(
        jnp.float32) * gr).sum())(jx)
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(jg).astype(np.float32))


@pytest.mark.parametrize("row_block", [0, 8])
def test_sort_pool_and_folds_on_bf16_ties_are_the_references(row_block):
    rng = np.random.default_rng(2 + row_block)
    slots, k = 4, 5
    runs = np.array([[0, 0, 1, 4, 2, 3, 3, 4], [1, 1, 1, 0, 2, 4, 4, 4]], np.int32)
    node_graph = np.repeat(runs, 8, axis=1)
    x = _tie_rows(rng, node_graph.shape, 4)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    got = sort_pool_folds(x, torch.from_numpy(node_graph), slots, k, row_block=row_block)
    want = jax_sort_pool_folds(jx, jnp.asarray(node_graph), slots, k, row_block=row_block)
    _same_bits(got, want, "sort_pool_folds")
    got1 = sort_pool(x[0], torch.from_numpy(node_graph[0]), slots, k, row_block=row_block)
    want1 = jax_sort_pool(jx[0], jnp.asarray(node_graph[0]), slots, k, row_block=row_block)
    _same_bits(got1, want1, "sort_pool")


# -- the whole model ----------------------------------------------------------


def _models(gs, compute, folds=0, key=3):
    kw = dict(num_features=gs.num_features, num_classes=gs.num_classes,
              dropout_rate=0.0, compute_dtype=compute, **SMALL)
    jm, tm = JDGCNN(**kw), DGCNN(**kw)
    if folds:
        keys = jnp.stack([jax.random.PRNGKey(key + f) for f in range(folds)])
        jp = jax.jit(jax.vmap(lambda k: jax_init(k, jm)))(keys)
    else:
        jp = jax.jit(lambda k: jax_init(k, jm))(jax.random.PRNGKey(key))
    return jm, tm, jp, state_to_params(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)))


def _check_lp(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), rtol=0,
                               atol=5e-3)


def _check_grads(got, want):
    g = np.concatenate([a.numpy().ravel() for a in got])
    w = np.concatenate([np.asarray(b).ravel() for b in want])
    scale = np.abs(w).max()
    assert scale > 0
    assert np.abs(g - w).max() <= 1e-2 * scale, np.abs(g - w).max() / scale
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


def _dense_pair(name, n, compute, adj, idx_rows, slots=8):
    """The port's and the reference's dense datasets of `name` at the
    dtypes, and the batches of each index row."""
    gs, jgs = synthesize_tu_dataset(name, num_graphs=n, seed=5), jax_synth(name, num_graphs=n, seed=5)
    t = dense_tile(gs)
    data = build_dense_dataset(gs, t, "cpu", adj, compute)
    jdata = _jax_store(build_dense_dataset_on_device(jgs, t, adj_dtype=adj), compute)
    tb = [gather_dense_batch(data, torch.from_numpy(np.asarray(r, np.int32))) for r in idx_rows]
    jb = [jax_gather(jdata, jnp.asarray(np.asarray(r, np.int32))) for r in idx_rows]
    return gs, tb, jb


@pytest.mark.parametrize("compute,adj", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", ["MUTAG", "NCI1"])
def test_apply_dense_matches_jax(name, compute, adj):
    gs, (tb,), (jb,) = _dense_pair(name, 16, compute, adj, [[0, 2, 3, 5, 7, 9, 11, -1]])
    jm, tm, jp, params = _models(gs, compute)

    def jloss(p):
        lp = jax_apply_dense(p, jm, jb)
        return jax_nll(lp, jb.y, jb.graph_mask)[0], lp

    (_, jlp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    net = DGCNNNet(tm, params)
    lp = net(tb)
    assert lp.dtype == torch.float32
    _check_lp(lp, jlp)
    nll_loss_and_correct(lp, tb.y, tb.graph_mask)[0].backward()
    _check_grads([p.grad for p in leaves(net.params())], jax.tree_util.tree_leaves(jg))


@pytest.mark.parametrize("compute,adj", DTYPES, ids=DTYPE_IDS)
def test_apply_dense_folds_matches_jax_per_fold(compute, adj):
    """Two folds on one batch of 2 × 8 slots (the lockstep step) against
    JAX's `apply_dense` of each fold's weights on its own batch, vmapped
    over the folds as the reference's lockstep runs it."""
    rows = [[0, 2, 3, 5, 7, 9, 11, -1], [1, 4, 6, 8, -1, -1, -1, -1]]
    gs, (tb,), _ = _dense_pair("MUTAG", 16, compute, adj, [sum(rows, [])])
    _, _, jbs_ = _dense_pair("MUTAG", 16, compute, adj, rows)
    jm, tm, jp, params = _models(gs, compute, folds=2)

    jb_f = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jbs_)

    def jloss(p):  # the reference's lockstep: `apply_dense` vmapped over the folds
        lp = jax.vmap(lambda q, b: jax_apply_dense(q, jm, b))(p, jb_f)
        return jax.vmap(lambda a, y, m: jax_nll(a, y, m)[0])(
            lp, jb_f.y, jb_f.graph_mask).sum(), lp

    (_, jlp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    net = DGCNNFoldsNet(tm, params)
    lp = net(tb)
    _check_lp(lp, jlp)
    nll_loss_and_correct(lp, tb.y.view(2, -1), tb.graph_mask.view(2, -1))[0].sum().backward()
    _check_grads([p.grad for p in leaves(net.params())], jax.tree_util.tree_leaves(jg))


def _multi_pair(compute, adj, folds=1):
    """COLLAB's classes in both packages at the dtypes, and one step: a
    batch of 8 graphs per fold routed into the classes (slots rounded up
    to 4, at least 4 a class, as the engine's floors), flattened
    fold-major."""
    gs, jgs = synthesize_tu_dataset("COLLAB", num_graphs=30, seed=3), jax_synth(
        "COLLAB", num_graphs=30, seed=3)
    tiles = md.plan_tiles(gs.node_counts(), 32)
    classes, routing = md.build_multi_dense(gs, tiles, "cpu", adj, compute)
    jclasses = _jax_store(jmd.build_multi_dense_on_device(jgs, tiles, adj_dtype=adj)[0],
                          compute)
    rng = np.random.default_rng(folds)
    ids = [rng.permutation(30)[:8] for _ in range(folds)]
    counts = np.stack([np.bincount(routing.class_of[i], minlength=len(tiles)) for i in ids])
    slots = tuple(max(4, int(s)) for s in -(-counts.max(0) // 4) * 4)
    rows = [md.route_order_rows(routing, i, slots) for i in ids]
    flat = [np.concatenate([r[c] for r in rows]) for c in range(len(slots))]
    tb = MultiDenseBatch(tuple(gather_dense_batch(d, torch.from_numpy(r))
                               for d, r in zip(classes, flat)), num_folds=folds)
    jb = tuple(jax_gather(d, jnp.asarray(r)) for d, r in zip(jclasses, flat))
    return gs, tb, jb


@pytest.mark.parametrize("compute,adj", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("folds", [1, 2], ids=["apply_multi_dense", "folds"])
def test_apply_multi_dense_matches_jax(compute, adj, folds):
    gs, tb, jb = _multi_pair(compute, adj, folds)
    jm, tm, jp, params = _models(gs, compute, folds=folds if folds > 1 else 0)

    def jloss(p):
        if folds == 1:
            lp, y, gm = jax_apply_multi(p, jm, jb)
            return jax_nll(lp, y, gm)[0], lp
        lp, y, gm = jax_apply_multi_folds(p, jm, jb, folds)
        return jax.vmap(lambda a, b, c: jax_nll(a, b, c)[0])(lp, y, gm).sum(), lp

    (_, jlp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    net = (DGCNNNet if folds == 1 else DGCNNFoldsNet)(tm, params)
    lp = net(tb)
    _check_lp(lp, jlp)
    y, gm = (tb.y, tb.graph_mask) if folds == 1 else (tb.y.view(folds, -1),
                                                     tb.graph_mask.view(folds, -1))
    nll_loss_and_correct(lp, y, gm)[0].sum().backward()
    _check_grads([p.grad for p in leaves(net.params())], jax.tree_util.tree_leaves(jg))


@functools.lru_cache(maxsize=None)
def _block_sets(pool_dtype):
    gs = synthesize_tu_dataset("DD", num_graphs=16, seed=4)
    jset = jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(gs))
    jset = dataclasses.replace(jset, pool=jset.pool.astype(jnp.dtype(pool_dtype)))
    tset = tbs.block_graphset_to_device(tbs.build_block_graphset(gs), "cpu", pool_dtype)
    return gs, jset, tset


@pytest.mark.parametrize("compute,adj", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("folds", [1, 2], ids=["apply_block", "folds"])
def test_apply_block_matches_jax(compute, adj, folds):
    """The pool at the propagation dtype (bf16 in both cases, as the
    engines store it); JAX's xla block formulation (the same function as
    its Pallas kernel); the port's on the CPU, the kernels' plain
    version."""
    gs, jset, tset = _block_sets(cv.pool_dtype(Config(compute_dtype=compute, adj_dtype=adj)))
    rows = np.array([[0, 3, 5, -1, 8, 11, 2, -1], [1, 4, -1, 6, 9, -1, -1, -1]],
                    np.int32)[:folds]
    if folds == 1:
        nb, w = tbs.block_batch_extents(tset.nb.numpy(), tset.block_count.numpy(), rows)
        jb = jbs.gather_block_batch(jset, jnp.asarray(rows[0]), nb + 2, w + 9)
        tb = tbs.gather_block_batch(tset, torch.from_numpy(rows[0]), nb + 2, w + 9)
    else:
        nb, w = tbs.block_fold_extents(tset.nb.numpy(), tset.block_count.numpy(), rows[None])
        jb = jax.jit(functools.partial(jbs.gather_block_batch_folds, nb_budget=nb + 2,
                                       w_budget=w + 9))(jset, jnp.asarray(rows))
        tb = tbs.gather_block_batch_folds(tset, torch.from_numpy(rows), nb + 2, w + 9)
    jm, tm, jp, params = _models(gs, compute, folds=folds if folds > 1 else 0)

    def jloss(p):
        if folds == 1:
            lp = jax_apply_block(p, jm, jb, jset.pool, block_impl="xla")
            return jax_nll(lp, jb.y, jb.graph_mask)[0], lp
        lp = jax_apply_block_folds(p, jm, jb, jset.pool)
        return jax.vmap(lambda a, b, c: jax_nll(a, b, c)[0])(lp, jb.y, jb.graph_mask).sum(), lp

    (_, jlp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    net = (DGCNNNet if folds == 1 else DGCNNFoldsNet)(tm, params)
    lp = net(tb, pool=tset.pool, block_impl="pallas")
    _check_lp(lp, jlp)
    nll_loss_and_correct(lp, tb.y, tb.graph_mask)[0].sum().backward()
    _check_grads([p.grad for p in leaves(net.params())], jax.tree_util.tree_leaves(jg))


def test_apply_block_refuses_a_pool_off_the_propagation_dtype():
    gs, _, tset = _block_sets("float32")
    tb = tbs.gather_block_batch(tset, torch.tensor([0, 1, -1], dtype=torch.int32), 16, 256)
    _, tm, _, params = _models(gs, "bfloat16")
    with pytest.raises(TypeError, match="propagation dtype"):
        apply_block(params, tm, tb, tset.pool)


# -- training on the CPU ------------------------------------------------------


def _cfg(tmp_path, sub, data_type, **kw):
    return Config(data_type=data_type, batch_size=8, num_epochs=2, num_folds=2,
                  max_fused_epochs=2, data_root=str(tmp_path / "data"),
                  epochs_dir=str(tmp_path / sub / "epochs"),
                  statistics_dir=str(tmp_path / sub / "statistics"), **SMALL, **kw)


def _epoch_events(cfg):
    path = f"{cfg.statistics_dir}/{cfg.data_type}_events.jsonl"
    with open(path) as f:
        return [e for e in map(json.loads, f) if e["kind"] == "epoch"]


RUNS = {  # id → (dataset, graphs, layout, config)
    "dense-sequential": ("MUTAG", 30, "dense", dict(cv_parallel="sequential")),
    "dense-lockstep": ("MUTAG", 30, "dense", dict(cv_parallel="folds")),
    "multi-sequential": ("MUTAG", 30, "multi", dict(multi_dense_min_tile=16)),
    "multi-folds": ("MUTAG", 30, "multi", dict(multi_dense_min_tile=16,
                                               cv_parallel="folds")),
    "block-sequential-pallas": ("DD", 16, "block", dict(cv_parallel="sequential",
                                                        block_impl="pallas")),
    "block-lockstep-pallas": ("DD", 16, "block", dict(block_impl="pallas")),
    "block-lockstep-xla": ("DD", 16, "block", dict(block_impl="xla")),
}


@pytest.mark.parametrize("dtypes", [("bfloat16", "auto"), ("float32", "bfloat16")],
                         ids=["compute_bf16", "adj_bf16"])
@pytest.mark.parametrize("run", list(RUNS))
def test_cross_validation_trains_under_bf16(tmp_path, run, dtypes):
    """Two folds × two epochs through `run_cross_validation` on the CPU:
    every epoch's losses finite, every fold's `epochs/` bundle written, the
    layout and the lockstep choice as configured."""
    name, n, layout, kw = RUNS[run]
    compute, adj = dtypes
    gs = synthesize_tu_dataset(name, num_graphs=n, seed=6)
    cfg = _cfg(tmp_path, run, name, layout=layout, compute_dtype=compute, adj_dtype=adj,
               **kw)
    res = cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    events = _epoch_events(cfg)
    assert len(events) == 4 and np.isfinite(res["train_accuracy_mean"])
    for e in events:
        assert np.isfinite(e["train_loss"]) and np.isfinite(e["test_loss"])
        assert ("folds_in_lockstep" in e) == ("lockstep" in run or "folds" in run)
    for f in (1, 2):
        assert (tmp_path / run / "epochs" / f"{name}_{f}.npz").exists()


# -- the COO layout, the lockstep gate, the layout choice ---------------------


@pytest.mark.parametrize("adj", ["auto", "bfloat16"])
def test_coo_refuses_bf16_compute_naming_its_item(tmp_path, adj):
    gs = synthesize_tu_dataset("MUTAG", num_graphs=20, seed=1)
    cfg = _cfg(tmp_path, "coo", "MUTAG", layout="coo", compute_dtype="bfloat16",
               adj_dtype=adj)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 20"):
        cv.run_cross_validation(cfg, dataset=gs, device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        cv.make_engine(cfg, gs, torch.device("cpu"), "coo")


def test_coo_runs_a_bf16_adj_dtype_as_fp32(tmp_path):
    """No COO engine reads adj_dtype, in the reference or here: the run
    under `adj_dtype="bfloat16"` writes the fp32 run's bytes."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=20, seed=1)
    out = {}
    for adj in ("auto", "bfloat16"):
        cfg = _cfg(tmp_path, adj, "MUTAG", layout="coo", adj_dtype=adj)
        cv.run_cross_validation(cfg, dataset=gs, device="cpu")
        with open(f"{cfg.statistics_dir}/MUTAG_results_1.csv") as f:
            out[adj] = f.read()
    assert out["auto"] == out["bfloat16"]


@pytest.mark.parametrize("compute,adj", [("float32", "float32"), ("float32", "bfloat16"),
                                         ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_lockstep_gate_and_layout_choice_are_the_references(compute, adj):
    """The dense lockstep gate counts 4 bytes an adjacency element whatever
    the dtypes, as the reference's does (dgcnn_tpu/train/cv.py:114-121),
    at budgets just under and at each dataset's stacked step; the layout
    choice, which charges 2 bytes under bf16, answers as the reference's."""
    for name, n in (("PROTEINS", 60), ("COLLAB", 40), ("DD", 20)):
        gs, jgs = synthesize_tu_dataset(name, num_graphs=n, seed=2), jax_synth(
            name, num_graphs=n, seed=2)
        t = dense_tile(gs)
        step = 10 * 56 * t * (t + gs.num_features) * 4
        for budget in (step - 1, step):
            kw = dict(data_type=name, compute_dtype=compute, adj_dtype=adj,
                      lockstep_max_step_bytes=budget, dense_max_device_bytes=8_000_000)
            got = cv._lockstep_would_engage(Config(**kw), gs, t)
            assert got == jcv._lockstep_would_engage(JConfig(**kw), jgs, t) == (budget == step)
            assert cv.choose_layout(Config(**kw), gs) == jcv.choose_layout(JConfig(**kw), jgs)
