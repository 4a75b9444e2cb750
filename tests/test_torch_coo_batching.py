"""The port's COO batching (dgcnn_tpu_torch/batching/packer.py,
device_coo.py and the block-pair builders of kernels/spmm_block_coo.py)
against the JAX package's NumPy code, byte for byte: buckets, packed
batches and epochs, the device graphset, on-device assembly (run on the
CPU), block-pair structures and their weights, stacked and unstacked."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import device_coo as jdc
from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.kernels import spmm_block_coo as jbc
from dgcnn_tpu_torch.batching import device_coo as tdc
from dgcnn_tpu_torch.batching import packer as tpk
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import spmm_block_coo as tbc
import torch_threads  # noqa: F401  (torch on one CPU thread)


def _jset(gs):
    """The same graphs as the reference's GraphSet."""
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


def _assert_batch_equal(got, want, msg=""):
    for name in tpk.ARRAY_FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, f"{msg} {name}: {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


@pytest.mark.parametrize("name", ["MUTAG", "DD", "IMDB-BINARY"])
def test_bucket_and_pack_batch_equal_reference(name):
    gs = synthesize_tu_dataset(name, num_graphs=20, seed=11)
    jgs = _jset(gs)
    for args in ((6,), (6, 128, 128, 2), (50,)):
        got, want = tpk.compute_bucket(gs, *args), jpk.compute_bucket(jgs, *args)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    bucket = tpk.compute_bucket(gs, 6, 128, 128, 2)
    jbucket = jpk.compute_bucket(jgs, 6, 128, 128, 2)
    for idx in ([3, 11, 7], [0], list(range(6))):
        _assert_batch_equal(tpk.pack_batch(gs, idx, bucket),
                            jpk.pack_batch(jgs, idx, jbucket), f"{name} {idx}")


def test_pack_batch_overflow_raises_like_reference():
    gs = synthesize_tu_dataset("MUTAG", num_graphs=10, seed=2)
    small = tpk.BucketSpec(num_nodes=8, num_edges=1024, num_graphs=8)
    with pytest.raises(ValueError, match="nodes"):
        tpk.pack_batch(gs, [0, 1, 2], small)
    with pytest.raises(ValueError, match="graphs"):
        tpk.pack_batch(gs, list(range(9)), small)


def test_pack_epoch_equals_reference_numpy_packer():
    gs = synthesize_tu_dataset("PROTEINS", num_graphs=23, seed=3)
    jgs = _jset(gs)
    order = np.random.default_rng(0).permutation(23)
    bucket = tpk.compute_bucket(gs, 5)
    got = tpk.pack_epoch(gs, order, 5, bucket)
    want = jpk.pack_epoch(jgs, order, 5, jpk.compute_bucket(jgs, 5), backend="numpy")
    assert got.x.shape[0] == 5
    _assert_batch_equal(got, want)
    step = tpk.batch_step(got, 4)
    _assert_batch_equal(step, tpk.pack_batch(gs, order[20:], bucket))


def test_device_graphset_build_and_sizes_equal_reference():
    gs = synthesize_tu_dataset("DD", num_graphs=40, seed=2)
    got, want = tdc.build_device_graphset(gs), jdc.build_device_graphset(_jset(gs))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert tdc.device_graphset_bytes(gs) == jdc.device_graphset_bytes(_jset(gs))
    order = np.array([[0, 5, 9, -1], [39, 1, -1, -1]], np.int32)
    n_c, e_c = gs.node_counts(), gs.edge_counts()
    assert tdc.batch_extents(n_c, e_c, order) == jdc.batch_extents(n_c, e_c, order)
    tight = tpk.BucketSpec(*tdc.batch_extents(n_c, e_c, order), 4)
    tdc.assert_bucket_fits(n_c, e_c, order, tight)
    with pytest.raises(ValueError, match="overflows"):
        tdc.assert_bucket_fits(n_c, e_c, order, dataclasses.replace(
            tight, num_nodes=tight.num_nodes - 1))


@pytest.mark.parametrize("name", ["MUTAG", "DD", "IMDB-BINARY"])
def test_gather_coo_batch_equals_packer_and_reference(name):
    gs = synthesize_tu_dataset(name, num_graphs=20, seed=11)
    jgs = _jset(gs)
    bucket = tpk.compute_bucket(gs, 6, 128, 128, 2)
    jbucket = jpk.compute_bucket(jgs, 6, 128, 128, 2)
    tdev = tdc.device_graphset_to(tdc.build_device_graphset(gs), "cpu")
    jdev = jax.device_put(jdc.build_device_graphset(jgs))
    for idx in ([3, 11, 7], [0], list(range(6))):
        row = np.full(bucket.num_graphs, -1, np.int32)
        row[: len(idx)] = idx
        got = tdc.gather_coo_batch(tdev, torch.from_numpy(row), bucket)
        _assert_batch_equal(got, tpk.pack_batch(gs, idx, bucket), f"{name} {idx}")
        _assert_batch_equal(got, jdc.gather_coo_batch(jdev, jnp.asarray(row), jbucket),
                            f"{name} {idx} jax")


def test_gather_strips_self_loops():
    gs = GraphSet(np.ones((3, 2), np.float32), np.array([0, 3], np.int64),
                  np.array([0, 1, 1], np.int32), np.array([1, 0, 1], np.int32),
                  np.array([0, 3], np.int64), np.array([0], np.int32), 2)
    bucket = tpk.BucketSpec(128, 128, 2)
    dev = tdc.device_graphset_to(tdc.build_device_graphset(gs), "cpu")
    got = tdc.gather_coo_batch(dev, torch.tensor([0, -1], dtype=torch.int32), bucket)
    assert int(got.edge_mask.sum()) == 2
    _assert_batch_equal(got, tpk.pack_batch(gs, [0], bucket))


def _batchlike(rng, n, graphs, avg):
    """Contiguous graphs with random intra-graph edges (repeats included),
    destination-sorted: the structure packed batches have."""
    src_l, dst_l, base = [], [], 0
    for _ in range(graphs):
        gn = min(max(2, int(rng.normal(avg, avg * 0.3))), n - base)
        if gn < 2:
            break
        src_l.append(rng.integers(0, gn, gn * 3) + base)
        dst_l.append(rng.integers(0, gn, gn * 3) + base)
        base += gn
    src, dst = np.concatenate(src_l), np.concatenate(dst_l)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def _structure_equal(got, want):
    assert dataclasses.astuple(got.meta) == dataclasses.astuple(want.meta)
    for f in tbc.BlockCOO.ARRAYS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("eb,pad", [(256, 0), (128, 0), (128, 50)])
@pytest.mark.parametrize("kind", ["random", "batch", "single", "empty"])
def test_build_block_coo_equals_reference(kind, eb, pad):
    rng = np.random.default_rng(7)
    n = 512
    if kind == "random":
        src = rng.integers(0, n, 2048).astype(np.int32)
        dst = np.sort(rng.integers(0, n, 2048)).astype(np.int32)
    elif kind == "batch":
        src, dst = _batchlike(rng, n, 12, 30)
    elif kind == "single":
        src, dst = np.array([3], np.int32), np.array([200], np.int32)
    else:
        src = dst = np.zeros(0, np.int32)
    if pad and kind == "random":
        pad = 200
    got = tbc.build_block_coo(src, dst, n, eb=eb, pad_items_to=pad)
    want = jbc.build_block_coo(src, dst, n, eb=eb, pad_items_to=pad)
    _structure_equal(got, want)
    w = rng.random(len(src)).astype(np.float32)
    np.testing.assert_array_equal(tbc.pad_weights(got, w), jbc.pad_weights(want, w))
    np.testing.assert_array_equal(tbc.pad_weights_t(got, w), jbc.pad_weights_t(want, w))
    w_t = max(np.asarray(got.ls).shape[0], np.asarray(got.lsT).shape[0]) + 3
    _structure_equal(tbc.pad_structure(got, w_t), jbc.pad_structure(want, w_t))


def test_build_block_coo_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple"):
        tbc.build_block_coo(np.zeros(1), np.zeros(1), 200)
    with pytest.raises(ValueError, match="eb"):
        tbc.build_block_coo(np.zeros(1), np.zeros(1), 256, eb=100)
    s = tbc.build_block_coo(np.arange(300) % 256, np.arange(300) % 256, 256, eb=128)
    with pytest.raises(ValueError, match="pad_items_to"):
        tbc.pad_structure(s, 1)


@pytest.mark.parametrize("stacked", [False, True])
def test_add_blockcoo_equals_reference(stacked):
    gs = synthesize_tu_dataset("MUTAG", num_graphs=12, seed=7)
    jgs = _jset(gs)
    bucket = tpk.compute_bucket(gs, 4)
    if stacked:
        t_b = tpk.pack_epoch(gs, np.arange(12), 4, bucket)
        j_b = jpk.pack_epoch(jgs, np.arange(12), 4, jpk.compute_bucket(jgs, 4),
                             backend="numpy")
    else:
        t_b = tpk.pack_batch(gs, [1, 5, 9], bucket)
        j_b = jpk.pack_batch(jgs, [1, 5, 9], jpk.compute_bucket(jgs, 4))
    for pad in (0, 37):
        got = tpk.add_blockcoo(t_b, eb=128, pad_items_to=pad).blockcoo
        want = jpk.add_blockcoo(j_b, eb=128, pad_items_to=pad).blockcoo
        _structure_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, np.asarray(b))
    bound = tpk.blockcoo_item_bound(gs, 4)
    assert bound == jpk.blockcoo_item_bound(jgs, 4)


def test_stacked_structure_steps_and_device_transfer():
    """A stacked epoch's step i (structure included) equals the structure
    built for that batch alone, padded alike; batch_to_device keeps every
    array, int32 structure included."""
    gs = synthesize_tu_dataset("MUTAG", num_graphs=12, seed=7)
    bucket = tpk.compute_bucket(gs, 4)
    epoch = tpk.add_blockcoo(tpk.pack_epoch(gs, np.arange(12), 4, bucket), pad_items_to=9)
    dev = tpk.batch_to_device(epoch, "cpu")
    assert dev.blockcoo[0].ls.dtype == torch.int32
    for i in range(3):
        step = tpk.batch_step(dev, i)
        alone = tpk.add_blockcoo(tpk.pack_batch(gs, range(4 * i, 4 * i + 4), bucket),
                                 pad_items_to=dev.blockcoo[0].ls.shape[1])
        _assert_batch_equal(step, alone)
        _structure_equal(step.blockcoo[0].map(lambda t: t.numpy()), alone.blockcoo[0])
        np.testing.assert_array_equal(step.blockcoo[1].numpy(), alone.blockcoo[1])
