"""The multi-tile dense layout's batching and forward
(dgcnn_tpu_torch/batching/multi_dense.py, batching/device_coo.py
`densify_on_device`, models/dgcnn.py `apply_multi_dense`) against the
reference's (dgcnn_tpu/batching/multi_dense.py, models/dgcnn.py:367):
routing field by field, the two ValueErrors, the host and device-style
builders bitwise equal to each other and to JAX's host builder (an empty
tile class included), and the forward and its gradients on batches with
a class that holds no graph."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused import SMALL

from dgcnn_tpu.batching import multi_dense as jmd
from dgcnn_tpu.batching.dense import gather_dense_batch as jax_gather
from dgcnn_tpu.data.synthetic import synthesize_tu_dataset as jax_synth
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import apply_multi_dense as jax_apply_multi
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.train.loop import nll_loss_and_correct as jax_nll
from dgcnn_tpu_torch.batching import multi_dense as md
from dgcnn_tpu_torch.batching.dense import DenseDataset, gather_dense_batch
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, apply_multi_dense, leaves
from dgcnn_tpu_torch.parity.convert import params_from_jax, state_to_params
from dgcnn_tpu_torch.train.loop import nll_loss_and_correct
import torch_threads  # noqa: F401  (torch on one CPU thread)

# (synthetic profile, graphs, multi_dense_min_tile): 4 classes each
SETS = {"COLLAB": ("COLLAB", 40, 32), "DD": ("DD", 24, 256),
        "PROTEINS": ("PROTEINS", 40, 16)}


def _pair(which, seed=3):
    name, n, min_tile = SETS[which]
    gs = synthesize_tu_dataset(name, num_graphs=n, seed=seed)
    return gs, jax_synth(name, num_graphs=n, seed=seed), md.plan_tiles(
        gs.node_counts(), min_tile)


@pytest.mark.parametrize("which", list(SETS))
def test_routing_equals_jax_field_by_field(which):
    """`plan_tiles`, `build_routing` (every field), `multi_dense_bytes`,
    `route_order_rows` of every batch of a shuffle and `class_batch_counts`
    of it, against the reference's functions on the same graphs."""
    gs, jgs, tiles = _pair(which)
    nc = gs.node_counts()
    assert tiles == jmd.plan_tiles(jgs.node_counts(), SETS[which][2])
    r, jr = md.build_routing(nc, tiles), jmd.build_routing(jgs.node_counts(), tiles)
    assert r.tiles == jr.tiles and len(r.tiles) >= 3
    for f in ("class_of", "index_in_class"):
        got, want = getattr(r, f), getattr(jr, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert md.multi_dense_bytes(gs, tiles) == jmd.multi_dense_bytes(jgs, tiles)
    order = np.random.default_rng(1).permutation(gs.num_graphs)
    counts = md.class_batch_counts(r, order, 8)
    np.testing.assert_array_equal(counts, jmd.class_batch_counts(jr, order, 8))
    slots = tuple(int(s) for s in -(-counts.max(axis=0) // 4) * 4)
    for i in range(0, len(order), 8):
        for a, b in zip(md.route_order_rows(r, order[i:i + 8], slots),
                        jmd.route_order_rows(jr, order[i:i + 8], slots)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("error", ["uncovered graph", "slot overflow"])
def test_routing_raises_as_the_reference(error):
    """A top tile below the largest graph, and a batch with more of a
    class's graphs than its slots: both packages raise the same
    ValueError."""
    gs, jgs, tiles = _pair("COLLAB")
    if error == "uncovered graph":
        short = (*tiles[:-1], tiles[-1] - 8)
        calls = [lambda m, g: m.build_routing(g.node_counts(), short),
                 lambda m, g: m.multi_dense_bytes(g, short)]
        match = "tiles must cover every graph"
    else:
        calls = [lambda m, g: m.route_order_rows(
            m.build_routing(g.node_counts(), tiles), np.arange(g.num_graphs),
            (4,) * len(tiles))]
        match = r"class \d+ has \d+ graphs > 4 slots"
    for call in calls:
        msgs = []
        for mod, data in ((md, gs), (jmd, jgs)):
            with pytest.raises(ValueError, match=match) as e:
                call(mod, data)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _empty_class_tiles(gs):
    """A caller-chosen ladder whose middle bracket holds no graph."""
    nc = gs.node_counts()
    lo = int(nc.min())
    assert not ((nc > lo) & (nc <= lo + 1)).any()
    return (lo, lo + 1, int(nc.max()))


@pytest.mark.parametrize("which", ["COLLAB", "DD", "empty class"])
def test_builders_are_bitwise_each_other_and_jax(which):
    """The host builder (`build_multi_dense`), the device-style builder
    (`build_multi_dense_on_device`, `densify_many_on_device` on CPU
    tensors) and the reference's host `build_multi_dense`: every class's
    x, adj, node_mask and y bitwise equal, dtypes included; the routing
    the same."""
    gs, jgs, tiles = _pair("COLLAB" if which == "empty class" else which)
    if which == "empty class":
        tiles = _empty_class_tiles(gs)
    host, r = md.build_multi_dense(gs, tiles)
    dev, r2 = md.build_multi_dense_on_device(gs, tiles, "cpu")
    ref, jr = jmd.build_multi_dense(jgs, tiles)
    np.testing.assert_array_equal(r.class_of, jr.class_of)
    np.testing.assert_array_equal(r2.index_in_class, jr.index_in_class)
    sizes = [int((r.class_of == c).sum()) for c in range(len(tiles))]
    assert (0 in sizes) == (which == "empty class")
    for c, (a, b, want) in enumerate(zip(host, dev, ref)):
        for f in ("x", "adj", "node_mask", "y"):
            w = np.asarray(getattr(want, f))
            for name, got in (("host", getattr(a, f)), ("device", getattr(b, f))):
                got = got.numpy()
                assert got.dtype == w.dtype and got.shape == w.shape, (c, f, name)
                np.testing.assert_array_equal(got, w, err_msg=f"class {c} {f} {name}")
        assert b.adj.shape == (sizes[c], tiles[c], tiles[c])


def _batches(gs, tiles, ids_rows, slots):
    """Each batch of graph ids as the port's per-class batches (on the
    CPU) and the reference's."""
    r = md.build_routing(gs.node_counts(), tiles)
    classes, _ = md.build_multi_dense(gs, tiles)
    jclasses = [jax.tree_util.tree_map(jnp.asarray, c)
                for c in jmd.build_multi_dense(gs, tiles)[0]]
    out = []
    for ids in ids_rows:
        rows = md.route_order_rows(r, ids, slots)
        out.append((
            md.MultiDenseBatch(tuple(gather_dense_batch(d, torch.from_numpy(row))
                                     for d, row in zip(classes, rows))),
            tuple(jax_gather(d, jnp.asarray(row)) for d, row in zip(jclasses, rows))))
    return out


def _models(gs, key=5, dropout=0.0):
    jm = JDGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
                dropout_rate=dropout, **SMALL)
    tm = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes,
               dropout_rate=dropout, **SMALL)
    jp = jax_init(jax.random.PRNGKey(key), jm)
    return jm, tm, jp, state_to_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))


def _class_rows(gs, tiles, first_empty):
    """Two batches of 8 graph ids: one whose smallest class holds no graph
    when `first_empty`, else one holding graphs of every class; and the
    slot counts that fit both."""
    r = md.build_routing(gs.node_counts(), tiles)
    by_class = [np.flatnonzero(r.class_of == c) for c in range(len(tiles))]
    pick = [m[:2] for m in by_class]
    full = np.concatenate(pick)[:8]
    skip = np.concatenate([m[2:4] for m in by_class[1:]] + pick[1:])[:8]
    return [skip if first_empty else full, full], (4,) * len(tiles)


@pytest.mark.parametrize("which", ["COLLAB", "DD"])
def test_apply_multi_dense_matches_jax_forward_and_gradients(which):
    """Same weights (`params_from_jax`), dropout off: the log-probs, the
    batch's concatenated y and graph mask, the per-class activations, the masked
    NLL and every parameter gradient against JAX `apply_multi_dense`, on a
    batch whose smallest class holds no graph and on one holding every
    class."""
    gs, _, tiles = _pair(which)
    rows, slots = _class_rows(gs, tiles, first_empty=True)
    jm, tm, jp, params = _models(gs)

    @jax.jit
    def jforward(p, jb):
        lp_, y_, gm_ = jax_apply_multi(p, jm, jb)
        return (lp_, y_, gm_), jax_nll(lp_, y_, gm_)[0]

    jgrad = jax.jit(jax.value_and_grad(lambda p, jb: jforward(p, jb)[1]))
    for tb, jb in _batches(gs, tiles, rows, slots):
        assert float(tb.classes[0].graph_mask.sum()) in (0.0, 2.0)
        (jlp, jy, jgm), _ = jforward(jp, jb)
        lp, acts = apply_multi_dense(params, tm, tb.classes, return_activations=True)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tb.graph_mask.numpy(), np.asarray(jgm))
        assert set(acts) >= {f"gcn1_c{c}" for c in range(len(tiles))}

        jl, jgrads = jgrad(jp, jb)
        net = DGCNNNet(tm, {k: v for k, v in params.items()})
        loss, _ = nll_loss_and_correct(net(tb), tb.y, tb.graph_mask)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        got = [p.grad for p in leaves(net.params())]
        want = jax.tree_util.tree_leaves(jgrads)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_forward_dispatch_and_one_dropout_mask():
    """`DGCNNNet` takes a `MultiDenseBatch` and gives `apply_multi_dense`'s
    log-probs, bitwise; with dropout on, one [ΣS_c, dense_dim] mask is
    drawn from the generator, as one `torch.rand` of that shape draws
    it."""
    gs, _, tiles = _pair("COLLAB")
    rows, slots = _class_rows(gs, tiles, first_empty=False)
    _, tm, _, params = _models(gs, dropout=0.5)
    (tb, _), = _batches(gs, tiles, rows[:1], slots)
    net = DGCNNNet(tm, params)
    want = apply_multi_dense(params, tm, tb.classes)
    assert torch.equal(net(tb), want)
    gen = torch.Generator().manual_seed(9)
    lp, acts = net(tb, deterministic=False, dropout_gen=gen, return_activations=True)
    total = sum(slots)
    assert lp.shape == (total, gs.num_classes)
    u = torch.rand((total, tm.dense_dim), generator=torch.Generator().manual_seed(9))
    assert torch.equal(acts["dropout_keep"], u < 0.5)


def test_densify_counts_duplicate_edges_and_strips_self_loops():
    """A graph listing its edges twice and a self-loop densifies to the
    host builder's adjacency, bitwise: the raw counts are exact integers
    (2 where an edge is listed twice) before the normalization, and the
    input self-loop is replaced by the one re-added self-loop."""
    from dgcnn_tpu_torch.batching.dense import build_dense_dataset
    from dgcnn_tpu_torch.batching.device_coo import (build_device_graphset,
                                                     densify_on_device,
                                                     device_graphset_to)
    from dgcnn_tpu_torch.data.graphset import GraphSet

    gs, _, _ = _pair("PROTEINS")
    one = gs.subset(np.arange(1))
    src = np.concatenate([one.edge_src, one.edge_src, [0]]).astype(one.edge_src.dtype)
    dst = np.concatenate([one.edge_dst, one.edge_dst, [0]]).astype(one.edge_dst.dtype)
    ptr = np.array([0, len(src)], dtype=one.edge_ptr.dtype)
    dup = GraphSet(x=one.x, node_ptr=one.node_ptr, edge_src=src, edge_dst=dst,
                   edge_ptr=ptr, y=one.y, num_classes=one.num_classes)
    t = md.plan_tiles(one.node_counts(), 8)[-1]
    want = build_dense_dataset(dup, t, "cpu")
    got = densify_on_device(device_graphset_to(build_device_graphset(dup), "cpu"), t)
    assert isinstance(got, DenseDataset)
    for f in ("x", "adj", "node_mask", "y"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    single = build_dense_dataset(one, t, "cpu").adj
    assert not torch.equal(got.adj, single)


def test_densify_in_small_chunks_changes_nothing(monkeypatch):
    """The scatter in chunks of 7 edges and the normalization one graph at
    a time (chunk boundaries inside a graph's edges, and every graph its
    own normalize chunk) give the host builder's bits."""
    from dgcnn_tpu_torch.batching import device_coo

    monkeypatch.setattr(device_coo, "_SCATTER_CHUNK_EDGES", 7)
    monkeypatch.setattr(device_coo, "_NORMALIZE_CHUNK_BYTES", 1)
    gs, _, tiles = _pair("COLLAB")
    host, _ = md.build_multi_dense(gs, tiles)
    dev, _ = md.build_multi_dense_on_device(gs, tiles, "cpu")
    for c, (a, b) in enumerate(zip(host, dev)):
        for f in ("x", "adj", "node_mask", "y"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (c, f)
