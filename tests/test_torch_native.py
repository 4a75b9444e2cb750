"""The port's C++ epoch packer (dgcnn_tpu_torch/native): byte-for-byte
equal to the port's NumPy packer and to the reference's NumPy
`pack_epoch`, its error paths, the backend choice, a concurrent first
build, and `CooEngine` packing through it."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import packer as jpk
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu_torch import native
from dgcnn_tpu_torch.batching.packer import (
    ARRAY_FIELDS, BucketSpec, compute_bucket, pack_epoch, resolve_backend,
)
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.train import cv
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


def _same_bytes(got, want, label):
    for name in ARRAY_FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        assert a.tobytes() == b.tobytes(), (label, name)


@pytest.mark.parametrize("name", ["MUTAG", "DD", "IMDB-BINARY"])
def test_native_matches_numpy_and_the_reference(name):
    gs = synthesize_tu_dataset(name, num_graphs=30, seed=9)
    bucket = compute_bucket(gs, 8)
    order = np.random.default_rng(0).permutation(30)
    got = pack_epoch(gs, order, 8, bucket, backend="native")
    _same_bytes(got, pack_epoch(gs, order, 8, bucket, backend="numpy"), "numpy")
    jb = jpk.BucketSpec(bucket.num_nodes, bucket.num_edges, bucket.num_graphs)
    _same_bytes(got, jpk.pack_epoch(_jset(gs), order, 8, jb, backend="numpy"), "reference")
    _same_bytes(got, pack_epoch(gs, order, 8, bucket), "auto")


def test_native_with_self_loops():
    gs = GraphSet(
        np.ones((3, 2), np.float32), np.array([0, 3], np.int64),
        np.array([0, 1, 1, 2], np.int32), np.array([1, 0, 1, 2], np.int32),  # 2 loops
        np.array([0, 4], np.int64), np.array([0], np.int32), 2,
    )
    bucket = BucketSpec(8, 1024, 2)
    got = pack_epoch(gs, np.array([0]), 1, bucket, backend="native")
    assert int(got.edge_mask.sum()) == 2
    _same_bytes(got, pack_epoch(gs, np.array([0]), 1, bucket, backend="numpy"), "numpy")


def test_native_bucket_overflow_raises():
    gs = synthesize_tu_dataset("MUTAG", num_graphs=20, seed=1)
    tiny = BucketSpec(num_nodes=8, num_edges=1024, num_graphs=8)
    with pytest.raises(ValueError, match="native packer failed"):
        pack_epoch(gs, np.arange(8), 8, tiny, backend="native")


def test_a_failed_build_makes_native_raise_and_auto_take_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_STATE", native._State())
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    assert not native.native_available()
    assert "no-such-compiler" in native.build_error()
    with pytest.raises(RuntimeError, match="native packer requested but unavailable"):
        resolve_backend("native")
    gs = synthesize_tu_dataset("MUTAG", num_graphs=10, seed=1)
    with pytest.raises(RuntimeError, match="unavailable"):
        pack_epoch(gs, np.arange(10), 4, compute_bucket(gs, 4), backend="native")
    assert resolve_backend("auto") == "numpy"
    assert native.pack_epoch_native(gs, np.arange(10), 4, compute_bucket(gs, 4)) is None
    with pytest.raises(ValueError, match="unknown packer backend"):
        resolve_backend("cpp")


def test_six_processes_build_on_an_empty_build_dir_at_once(tmp_path):
    """Six fresh processes call `native_available()` at the same instant on
    an empty build directory: every one gets the library (a process that
    loaded another's half-written file would fail or skip), and one file
    is left, with no temporary beside it."""
    build = tmp_path / "_build"
    go = time.time() + 3.0
    code = (
        "import sys, time\n"
        "from dgcnn_tpu_torch import native\n"
        f"native.BUILD_DIR = {str(build)!r}\n"
        f"time.sleep(max(0.0, {go!r} - time.time()))\n"
        "ok = native.native_available()\n"
        "print(ok, native.build_error())\n"
        "sys.exit(0 if ok else 1)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    assert sorted(f for f in os.listdir(build) if f.endswith(".so")) == [
        os.path.basename(native.lib_path())]
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_coo_engine_packs_through_native_under_auto():
    gs = synthesize_tu_dataset("MUTAG", num_graphs=20, seed=2)
    cfg = Config(data_type="MUTAG", batch_size=8, layout="coo", spmm_impl="pallas")
    engine = cv.make_engine(cfg, gs, torch.device("cpu"), "coo")
    assert isinstance(engine, cv.CooEngine)
    engine.begin_fold(np.arange(14), np.arange(14, 20))
    epoch = engine.pack_host(engine._train_set, np.arange(14)[::-1])
    assert engine.packed == {"native": 2, "numpy": 0}
    assert engine.pack_seconds["pack"] > 0 and engine.pack_seconds["blockcoo"] > 0
    want = pack_epoch(engine._train_set, np.arange(14)[::-1], 8, engine.bucket, "numpy")
    _same_bytes(epoch, want, "engine")
    assert epoch.blockcoo is not None
