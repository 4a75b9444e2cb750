"""The port's own copies of the data and batching layers produce the JAX
package's bytes: synthetic graphsets of all eight profiles, folds, dense
packs, order matrices, on-device gathers, the bundled folds asset, the
dataset loader, and the layout choice."""

import dataclasses
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgcnn_tpu
import dgcnn_tpu_torch
from dgcnn_tpu.batching import dense as jdense
from dgcnn_tpu.config import Config as JConfig
from dgcnn_tpu.data import folds as jfolds
from dgcnn_tpu.data import synthetic as jsynth
from dgcnn_tpu.data import tu_parser as jtu
from dgcnn_tpu.train.cv import choose_layout as jax_choose_layout
from dgcnn_tpu_torch.batching import dense as tdense
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data import datasets as tdatasets
from dgcnn_tpu_torch.data import folds as tfolds
from dgcnn_tpu_torch.data import synthetic as tsynth
from dgcnn_tpu_torch.data import tu_parser as ttu
from dgcnn_tpu_torch.train.cv import choose_layout

GS_FIELDS = ("x", "node_ptr", "edge_src", "edge_dst", "edge_ptr", "y")


def _same_graphset(a, b):
    assert a.num_classes == b.num_classes
    for f in GS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("name", list(jsynth.PROFILES))
def test_synthetic_graphsets_byte_equal(name):
    assert tsynth.SYNTHETIC_VERSION == jsynth.SYNTHETIC_VERSION
    assert tsynth.PROFILES[name] == jsynth.PROFILES[name]
    for attr in (True, False):
        _same_graphset(
            tsynth.synthesize_tu_dataset(name, num_graphs=16, seed=4, use_node_attr=attr),
            jsynth.synthesize_tu_dataset(name, num_graphs=16, seed=4, use_node_attr=attr),
        )


def test_folds_bundled_and_stratified_equal():
    y = jsynth.synthesize_tu_dataset("MUTAG", seed=1).y  # 188: bundled folds apply
    for data_type, yy in (("MUTAG", y), ("NCI1", y[:50])):  # NCI1: stratified
        want = jfolds.get_folds(yy, "", 10, 324, data_type=data_type)
        got = tfolds.get_folds(yy, "", 10, 324, data_type=data_type)
        assert len(got) == len(want) == 10
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_folds_asset_is_a_byte_copy():
    def sha(pkg):
        path = os.path.join(os.path.dirname(pkg.__file__), "assets", "folds.npz")
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert sha(dgcnn_tpu_torch) == sha(dgcnn_tpu)


def test_dense_pack_order_and_gather_equal():
    gs = tsynth.synthesize_tu_dataset("PTC_MR", num_graphs=30, seed=2)
    n_tile = tdense.dense_tile(gs)
    assert n_tile == jdense.dense_tile(gs)
    idx = [4, 0, 17, 29, 9]
    a = tdense.pack_dense_batch(gs, idx, n_tile, 8)
    b = jdense.pack_dense_batch(gs, idx, n_tile, 8)
    for f in dataclasses.fields(tdense.DenseGraphBatch):
        x, y = np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
    np.testing.assert_array_equal(a.adj, a.adj.transpose(0, 2, 1))  # symmetric

    order = np.random.default_rng(0).permutation(30)
    om = tdense.order_matrix(order, 7, 8)
    np.testing.assert_array_equal(om, jdense.order_matrix(order, 7, 8))
    assert (om == -1).any()

    data_t = tdense.build_dense_dataset(gs, n_tile, "cpu")
    data_j = jdense.build_dense_dataset(gs, n_tile)
    for row in om:
        got = tdense.gather_dense_batch(data_t, torch.from_numpy(row))
        want = jdense.gather_dense_batch(
            jax.tree_util.tree_map(jnp.asarray, data_j), jnp.asarray(row)
        )
        for f in dataclasses.fields(tdense.DenseGraphBatch):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f.name)), np.asarray(getattr(want, f.name)),
                err_msg=f.name,
            )


def test_tu_roundtrip_and_loader_paths_equal(tmp_path):
    gs = tsynth.synthesize_tu_dataset("IMDB-MULTI", num_graphs=12, seed=5)
    raw = tmp_path / "IMDB-MULTI" / "raw"
    ttu.write_tu_format(str(raw), "IMDB-MULTI", gs.node_ptr, gs.edge_src,
                        gs.edge_dst, gs.edge_ptr, gs.y)
    want = jtu.parse_tu_dir(str(raw), "IMDB-MULTI")
    _same_graphset(ttu.parse_tu_dir(str(raw), "IMDB-MULTI"), want)
    got, meta = tdatasets.load_dataset("IMDB-MULTI", root=str(tmp_path))
    assert meta.source == "raw"
    _same_graphset(got, want)
    got, meta = tdatasets.load_dataset("IMDB-MULTI", root=str(tmp_path))
    assert meta.source == "cache"
    _same_graphset(got, want)
    got, meta = tdatasets.load_dataset("MUTAG", root=str(tmp_path),
                                       allow_synthetic=True)
    assert meta.source == "synthetic"
    _same_graphset(got, jsynth.synthesize_tu_dataset("MUTAG"))
    with pytest.raises(FileNotFoundError):
        tdatasets.load_dataset("PTC_MR", root=str(tmp_path))


LAYOUT_CFGS = [
    {},
    {"cv_parallel": "sequential"},
    {"cv_parallel": "sequential", "multi_dense_min_tile": 16},
    {"dense_max_nodes": 40},
    {"dense_max_nodes": 40, "dense_max_device_bytes": 1000},
    {"lockstep_max_step_bytes": 1, "multi_dense_min_tile": 8},
    {"layout": "dense"},
]


@pytest.mark.parametrize("name", list(jsynth.PROFILES))
def test_choose_layout_matches_reference(name):
    gs = tsynth.synthesize_tu_dataset(name, num_graphs=40, seed=3)
    seen = set()
    for kw in LAYOUT_CFGS:
        want = jax_choose_layout(JConfig(data_type=name, **kw), gs)
        assert choose_layout(Config(data_type=name, **kw), gs) == want, kw
        seen.add(want)
    assert {"dense", "coo"} <= seen


def test_config_fields_and_defaults_match_reference():
    t = {f.name: f.default for f in dataclasses.fields(Config)}
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert t == j
    assert Config().resolved_adj_dtype() == "float32"
    with pytest.raises(ValueError):
        Config(dense_trunk="other")
