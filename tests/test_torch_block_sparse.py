"""The port's block-sparse layout (dgcnn_tpu_torch/batching/block_sparse.py)
against the JAX reference: the host build field by field (x_blocks after
the port's node-axis-first transpose), the on-device batch assembly
against JAX's jitted `gather_block_batch` (empty slots, budgets with
headroom, an empty batch), the budget helpers, and the engine's
grow-only budgets."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.train.cv import DeviceCooEngine
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.train import cv


@functools.lru_cache(maxsize=None)
def _sets(name, n_graphs=24, seed=0):
    gs = synthesize_tu_dataset(name, num_graphs=n_graphs, seed=seed)
    return gs, jbs.build_block_graphset(gs), tbs.build_block_graphset(gs)


@pytest.mark.parametrize("name", ["DD", "COLLAB", "MUTAG"])
def test_build_equals_jax_field_by_field(name):
    _, want, got = _sets(name)
    for f in dataclasses.fields(tbs.BlockGraphSet):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "x_blocks":  # JAX keeps [ΣNb+1, F, bs] for the TPU's lanes
            b = b.transpose(0, 2, 1)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def _idx_rows():
    return {
        "full": np.arange(8, dtype=np.int32),
        "empty_slots": np.array([3, 5, -1, 7, 11, -1, 2, -1], np.int32),
        "one_graph": np.array([-1, -1, 9, -1], np.int32),
        "no_graph": np.full(6, -1, np.int32),
    }


@pytest.mark.parametrize("name", ["DD", "COLLAB"])
@pytest.mark.parametrize("case", list(_idx_rows()))
def test_gather_block_batch_equals_jax(name, case):
    _, jset, tset = _sets(name)
    idx = _idx_rows()[case]
    nb, w = tbs.block_batch_extents(tset.nb, tset.block_count, idx[None])
    nb_budget, w_budget = nb + 5, w + 17  # padded items, unvisited rows
    jdev = jax.tree_util.tree_map(jnp.asarray, jset)
    gather = jax.jit(functools.partial(
        jbs.gather_block_batch, nb_budget=nb_budget, w_budget=w_budget))
    want = gather(jdev, jnp.asarray(idx))
    got = tbs.gather_block_batch(
        tbs.block_graphset_to_device(tset, "cpu"), torch.from_numpy(idx),
        nb_budget, w_budget,
    )
    for f in dataclasses.fields(tbs.BlockBatch):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    n = int(got.num_items)
    assert n == w
    # the sentinels of the contract
    assert (got.item_pool[n:] == tset.pool.shape[0] - 1).all()
    assert (got.item_row[n:] == nb_budget).all()
    assert (got.item_col[n:] == 0).all()
    assert (got.item_colT[n:] == nb_budget).all()
    assert torch.equal(got.item_permT[n:], torch.arange(n, w_budget, dtype=torch.int32))
    assert (got.node_graph[got.node_mask == 0] == len(idx)).all()
    for seg in (got.item_row, got.item_colT):
        assert (seg[1:] >= seg[:-1]).all()


def test_block_batch_extents_and_geom_round_equal_jax():
    _, _, tset = _sets("DD")
    rng = np.random.default_rng(1)
    mats = rng.integers(-1, 24, size=(3, 5, 8)).astype(np.int32)
    for m in (mats, mats[0], mats[:, :1]):
        assert tbs.block_batch_extents(tset.nb, tset.block_count, m) == \
            jbs.block_batch_extents(tset.nb, tset.block_count, m)
    for x in (0, 1, 7, 8, 9, 63, 64, 65, 166, 590, 1016, 1212, 5000):
        for mult in (8, 64):
            assert cv._geom_round(x, mult) == DeviceCooEngine._geom_round(x, mult)
    assert (cv._geom_round(166, 8), cv._geom_round(1212, 64)) == (216, 1280)


@pytest.mark.parametrize("name", ["DD", "PROTEINS"])
def test_graphset_bytes_and_device_copy(name):
    gs, _, tset = _sets(name)
    assert tbs.block_graphset_bytes(gs) == jbs.block_graphset_bytes(gs)
    dev = tbs.block_graphset_to_device(tset, "cpu")
    for f in dataclasses.fields(tbs.BlockGraphSet):
        t, a = getattr(dev, f.name), getattr(tset, f.name)
        assert t.dtype == (torch.float32 if a.dtype == np.float32 else torch.int64)
        np.testing.assert_array_equal(t.numpy(), a)


def test_segment_of_is_searchsorted_right():
    ends = torch.tensor([0, 3, 3, 7, 12])
    pos = torch.arange(15)
    want = np.searchsorted(ends.numpy(), pos.numpy(), side="right")
    np.testing.assert_array_equal(tbs.segment_of(ends, pos).numpy(), want)


def test_engine_budgets_grow_only():
    gs, _, tset = _sets("DD", n_graphs=40, seed=3)
    cfg = Config(data_type="DD", layout="block", batch_size=10)
    engine = cv.BlockSparseEngine(cfg, gs, torch.device("cpu"))
    assert engine.slots == 16 and engine.block_impl == cfg.resolved_block_impl()
    small = np.full((1, 16), -1, np.int32)
    small[0, 0] = 0
    assert engine.budget_for(small) == (8, 64)  # the floors
    big = np.arange(16, dtype=np.int32)[None]
    nb, w = engine.budget_for(big)
    want = tbs.block_batch_extents(tset.nb, tset.block_count, big)
    assert (nb, w) == (cv._geom_round(max(want[0], 1), 8),
                       cv._geom_round(max(want[1], 1), 64))
    assert engine.budget_for(small) == (nb, w)  # never shrinks
