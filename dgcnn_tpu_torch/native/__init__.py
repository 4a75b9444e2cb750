"""The C++ epoch packer, loaded with ctypes — the port of
dgcnn_tpu/native/__init__.py.

`pack_epoch_native` is the native backend of `batching.packer.pack_epoch`
(the COO layout's host packing, the whole of `CooEngine`'s epoch on the
host): `packer.cc` here is the reference's source, byte for byte, and its
output is byte-identical to the NumPy packer's.

The library is built with g++ at first use into `dgcnn_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source and the flags, so an
edited source rebuilds. Concurrent builds (pytest workers, processes of
one run) take an `fcntl` lock on a file in the build directory, compile to
a file of their own and `os.replace` it into place, so none loads a
half-written library. `native_available()` is False when no compiler or
no library can be had; `pack_epoch_native` then returns None.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "packer.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class _State:
    """The loaded library, or the failure that stopped it loading."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.error: Optional[str] = None
        self.lock = threading.Lock()


_STATE = _State()


def lib_path() -> str:
    """The library's path, keyed by the source, the compiler and its flags."""
    digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libdgcnn_native_{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile `SRC` into `out` under the build directory's lock (no-op
    when another process built it first). Raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                subprocess.run([CXX, *CXX_FLAGS, SRC, "-o", tmp], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f32 = (
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    )
    lib.dgcnn_pack_epoch_coo.restype = ctypes.c_int
    lib.dgcnn_pack_epoch_coo.argtypes = [
        f32, ctypes.c_int64,  # x, num_features
        i64, i32, i32, i64,  # node_ptr, edge_src, edge_dst, edge_ptr
        i32,  # y
        i64, ctypes.c_int64, ctypes.c_int64,  # order, num_order, batch
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # bucket
        f32, i32, i32, f32, i32, f32, i32, f32, i32,  # outputs
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    with _STATE.lock:
        if _STATE.lib is None and _STATE.error is None:
            out = lib_path()
            try:
                if not os.path.exists(out):
                    _build(out)
                _STATE.lib = _bind(ctypes.CDLL(out))
            except (OSError, subprocess.SubprocessError) as e:
                _STATE.error = f"{type(e).__name__}: {e}"
        return _STATE.lib


def native_available() -> bool:
    """True when the library is built (building it on first call) and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable, or None."""
    _load()
    return _STATE.error


def pack_epoch_native(dataset, order: np.ndarray, batch_size: int, bucket):
    """The C++ epoch packer: `batching.packer.pack_epoch`'s output, or None
    when the library is unavailable. Raises ValueError when a batch
    overflows the bucket."""
    lib = _load()
    if lib is None:
        return None
    from dgcnn_tpu_torch.batching.packer import GraphBatch

    order = np.ascontiguousarray(order, dtype=np.int64)
    steps = -(-len(order) // batch_size)
    n_pad, e_pad, b_pad = bucket.num_nodes, bucket.num_edges, bucket.num_graphs
    F = dataset.num_features

    out = GraphBatch(
        x=np.empty((steps, n_pad, F), np.float32),
        edge_src=np.empty((steps, e_pad), np.int32),
        edge_dst=np.empty((steps, e_pad), np.int32),
        edge_mask=np.empty((steps, e_pad), np.float32),
        node_graph=np.empty((steps, n_pad), np.int32),
        node_mask=np.empty((steps, n_pad), np.float32),
        y=np.empty((steps, b_pad), np.int32),
        graph_mask=np.empty((steps, b_pad), np.float32),
        num_graphs=np.empty((steps,), np.int32),
    )
    rc = lib.dgcnn_pack_epoch_coo(
        np.ascontiguousarray(dataset.x, np.float32), F,
        np.ascontiguousarray(dataset.node_ptr, np.int64),
        np.ascontiguousarray(dataset.edge_src, np.int32),
        np.ascontiguousarray(dataset.edge_dst, np.int32),
        np.ascontiguousarray(dataset.edge_ptr, np.int64),
        np.ascontiguousarray(dataset.y, np.int32),
        order, len(order), batch_size,
        n_pad, e_pad, b_pad,
        out.x, out.edge_src, out.edge_dst, out.edge_mask,
        out.node_graph, out.node_mask, out.y, out.graph_mask, out.num_graphs,
    )
    if rc != 0:
        raise ValueError(
            f"native packer failed with code {rc} "
            f"(bucket too small for a batch: {bucket})"
        )
    return out
