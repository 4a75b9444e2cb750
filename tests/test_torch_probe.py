"""The port's block-COO cost-split probe (dgcnn_tpu_torch/tools/
probe_kernel_anatomy.py) and its edge stream (dgcnn_tpu_torch/utils/
profiling.py) against the JAX reference: `_batch_edges` byte for byte, the
block-pair structure built from it field for field, and `block_coo_plain`
on the probe's shapes against the reference kernel in Pallas interpret
mode (as tests/test_spmm_block_coo.py runs it). The probe itself times
CUDA kernels and runs only on the card (chip_smoke.py phase 7); here it
must refuse to run without CUDA."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels import spmm_block_coo as jbc
from dgcnn_tpu.utils.profiling import _batch_edges as j_batch_edges
from dgcnn_tpu_torch.kernels import spmm_block_coo as tbc
from dgcnn_tpu_torch.tools import probe_kernel_anatomy as probe
from dgcnn_tpu_torch.utils.profiling import _batch_edges
import torch_threads  # noqa: F401  (torch on one CPU thread)

RTOL, ATOL = 1e-5, 1e-5  # test_torch_spmm.py's, the reference's own
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STREAMS = [(0, 2048, 8192), (0, 2048, probe.LONG_ROW_EDGES), (1, 512, 2048),
           (7, 300, 1000), (3, 1024, 5000)]


@pytest.mark.parametrize("seed,n,e", STREAMS)
def test_batch_edges_equals_reference_bytes(seed, n, e):
    got = _batch_edges(np.random.default_rng(seed), n, e)
    want = j_batch_edges(np.random.default_rng(seed), n, e)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,n,e", [s for s in STREAMS if s[1] % 128 == 0])
def test_structure_of_the_stream_equals_reference(seed, n, e):
    src, dst, _ = _batch_edges(np.random.default_rng(seed), n, e)
    got, want = tbc.build_block_coo(src, dst, n), jbc.build_block_coo(src, dst, n)
    for field in tbc.BlockCOO.ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_the_probe_shapes_as_described():
    """The standard shape draws exactly 8,192 edges (no padding); the
    long-row shape pads 1,022 w=0 edges into node 2,047, and they stay in
    the slot order the kernel walks."""
    std = probe.standard_shape("cpu")
    d = std.describe()
    assert (d["nodes"], d["edges"], d["slots"], d["item_axis"]) == (2048, 8192, 8192, 56)
    lr = probe.standard_shape("cpu", probe.LONG_ROW_EDGES)
    d = lr.describe()
    assert (d["edges"], d["slots"]) == (8194, 9216)
    rp = lr.order.row_ptr
    assert int(rp[2048] - rp[2047]) == d["longest_row"] >= 1022


@pytest.mark.parametrize("num_edges", [8192, probe.LONG_ROW_EDGES])
def test_block_coo_plain_on_the_probe_shape_matches_jax_kernel(num_edges):
    """Forward and dh at F=32 on the probe's shapes (w=0 padding slots in
    the structure), the reference kernel in interpret mode."""
    src, dst, w = _batch_edges(np.random.default_rng(0), 2048, num_edges)
    h = np.random.default_rng(1).normal(size=(2048, 32)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(2048, 32)).astype(np.float32)
    js = jbc.build_block_coo(src, dst, 2048)
    ts = tbc.build_block_coo(src, dst, 2048)
    wp, wpT = tbc.pad_weights(ts, w), tbc.pad_weights_t(ts, w)
    out, vjp = jax.vjp(lambda hh: jbc.spmm_block_coo(js, jnp.asarray(wp), jnp.asarray(wpT),
                                                     hh, True), jnp.asarray(h))
    dh, = vjp(jnp.asarray(g))
    st = ts.map(torch.from_numpy)
    got = tbc.block_coo_plain(st.row_ptr, st.item_c, st.ls, st.ld, torch.from_numpy(wp),
                              torch.from_numpy(h))
    got_dh = tbc.block_coo_plain(st.row_ptrT, st.item_cT, st.lsT, st.ldT,
                                 torch.from_numpy(wpT), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_dh.numpy(), np.asarray(dh), rtol=RTOL, atol=ATOL)


def test_probe_without_cuda_exits_1_with_an_error_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.tools.probe_kernel_anatomy"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and "error" in json.loads(lines[0])


@pytest.mark.parametrize("launch", ["abuild", "direct"])
def test_probe_kernels_refuse_cpu_tensors(launch):
    """No plain fallback: the probe's launchers take CUDA tensors only."""
    s = probe.standard_shape("cpu")
    st = s.structure
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "abuild":
            probe.abuild(st.row_ptr, st.item_c, st.ls, st.ld, s.w_pad, s.h)
        else:
            probe.direct(s.order.row_ptr, s.order.perm, st.item_c, st.ls, s.w_pad, s.h)
    assert probe.launches.fwd_launches == 0
