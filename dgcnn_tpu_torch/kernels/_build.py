"""Build the package's CUDA sources into shared libraries at first use.

Every `dgcnn_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into
its own shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so a build takes seconds). Libraries land in
`dgcnn_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads at once. All sources compile in parallel, one `nvcc` each.

Nothing here runs at import time: `load(name)` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildState:
    """Loaded libraries and the compiler's report for each source."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.ptxas: Dict[str, str] = {}
        self.seconds = 0.0
        self.lock = threading.Lock()


_STATE = BuildState()


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "dgcnn_tpu_torch are built from source at first use on the GPU host"
    )


def _lib_path(name: str) -> str:
    """Library path keyed by the source, every shared header in csrc/
    (`*.cuh`) and the flags, so an edited header rebuilds its users."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no current library (all in parallel),
    then load them all. Raises with the compiler's output on failure."""
    with _STATE.lock:
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = [n for n in sources() if n not in _STATE.libs]
        procs = []
        for name in todo:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            # write under a per-process name, rename when done: concurrent
            # builders never load a half-written library
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            _STATE.ptxas[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            _STATE.libs[name] = ctypes.CDLL(_lib_path(name))
        _STATE.seconds += time.perf_counter() - t0
        return dict(_STATE.libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (builds on first use)."""
    lib = _STATE.libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def build_report() -> Dict[str, object]:
    """Seconds spent building and loading, and nvcc's -Xptxas -v report per
    source built in this process."""
    return {"seconds": _STATE.seconds, "ptxas": dict(_STATE.ptxas)}
