"""The port's COO SpMM (dgcnn_tpu_torch/ops/spmm.py,
kernels/spmm_pallas.py, kernels/spmm_block_coo.py) against the JAX
reference: each kernel's autograd Function on CPU tensors (which runs the
plain version forward and transposed) against `spmm_pallas`,
`spmm_pallas_mxu` and `spmm_block_coo` in Pallas interpret mode (as the JAX
package's own tests run them), forward, dh and dw at the reference's
tolerances; `spmm_plain`/`sddmm_plain` against `spmm_xla`/`sddmm_xla`; the
edge orders the CUDA kernels walk; the dispatcher's names; the wrappers'
input checks; the row and edge-block kernels' designs walked on the CPU
(order of operations, block ownership of every row). The CUDA kernels are
held against the plain version on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels import spmm_block_coo as jbc
from dgcnn_tpu.kernels.spmm_pallas import spmm_pallas as j_pallas
from dgcnn_tpu.kernels.spmm_pallas import spmm_pallas_mxu as j_mxu
from dgcnn_tpu.ops.spmm import sddmm_xla, spmm_xla
from dgcnn_tpu_torch.config import Config
from dgcnn_tpu_torch.kernels import spmm_block_coo as tbc
from dgcnn_tpu_torch.kernels import spmm_pallas as tsp
from dgcnn_tpu_torch.ops import spmm as tspmm
import torch_threads  # noqa: F401  (torch on one CPU thread)

RTOL, ATOL = 1e-5, 1e-5  # the reference's own (tests/test_spmm_block_coo.py)
N, E = 256, 1024  # E a multiple of the reference kernels' edge blocks


def _pad(src, dst, w, n, e=E):
    """Pad a stream to `e` edges as the packer does: src 0 → dst n−1, w 0."""
    k = e - len(src)
    return (np.r_[src, np.zeros(k)].astype(np.int32),
            np.r_[dst, np.full(k, n - 1)].astype(np.int32),
            np.r_[w, np.zeros(k)].astype(np.float32))


def _filled_stream(rng):
    """A stream whose last node is real: edges into and out of node N−1,
    then the packer's padding, which also points at N−1 (weight 0)."""
    src = np.r_[rng.integers(0, N, 700), [N - 1] * 20]
    dst = np.r_[np.sort(rng.integers(0, N - 1, 700)), [N - 1] * 20]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    src[-5:] = rng.integers(0, N, 5)  # in-edges of N−1 from elsewhere
    return src, dst


KINDS = ("random", "unsorted", "duplicates", "filled", "single", "empty")
# the edge-block walks' streams: also one row over at least 3 blocks of 256
WALK_KINDS = KINDS + ("long_row",)


@functools.lru_cache(maxsize=None)
def _stream(kind):
    rng = np.random.default_rng(WALK_KINDS.index(kind))
    if kind == "long_row":  # 600 edges from node 7 into node 100, among others
        src = np.r_[rng.integers(0, N, 300), np.full(600, 7)]
        dst = np.r_[rng.integers(0, N, 300), np.full(600, 100)]
        shuffle = rng.permutation(900)
        src, dst = src[shuffle], dst[shuffle]
    elif kind == "random":
        src, dst = rng.integers(0, N, 900), np.sort(rng.integers(0, N, 900))
    elif kind == "unsorted":
        src, dst = rng.integers(0, N, 900), rng.integers(0, N, 900)
    elif kind == "duplicates":  # few distinct pairs, each many times
        pairs = rng.integers(0, N, (40, 2))
        pick = np.sort(rng.integers(0, 40, 1000))
        src, dst = pairs[pick, 0], pairs[pick, 1]
    elif kind == "filled":
        src, dst = _filled_stream(rng)
    elif kind == "single":
        src, dst = np.array([3]), np.array([200])
    else:  # "empty": padding only
        src = dst = np.zeros(0, np.int64)
    w = (rng.random(len(src)) + 0.5).astype(np.float32)
    return _pad(src, dst, w, N)


CASES = [("random", 1), ("random", 32), ("random", 97), ("unsorted", 32),
         ("duplicates", 32), ("duplicates", 1), ("filled", 32), ("filled", 1),
         ("single", 32), ("empty", 32)]


def _hg(f, seed=0):
    rng = np.random.default_rng(100 + f + seed)
    return (rng.standard_normal((N, f)).astype(np.float32),
            rng.standard_normal((N, f)).astype(np.float32))


def _jax_vjp(fn, w, h, g):
    out, vjp = jax.vjp(fn, jnp.asarray(w), jnp.asarray(h))
    dw, dh = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dh), np.asarray(dw)


def _torch_vjp(fn, w, h, g):
    wt = torch.from_numpy(w).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    out = fn(wt, ht)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), ht.grad.numpy(), wt.grad.numpy()


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind,f", CASES)
@pytest.mark.parametrize("kernel", ["rows", "edge_block"])
def test_edge_stream_function_matches_jax_kernel(kernel, kind, f):
    """SpmmRowsFn vs spmm_pallas and SpmmEdgeBlockFn vs spmm_pallas_mxu:
    forward, dh (src and dst swapped) and dw (the SDDMM)."""
    src, dst, w = _stream(kind)
    h, g = _hg(f)
    jfn = j_pallas if kernel == "rows" else j_mxu
    tfn = tsp.spmm_pallas if kernel == "rows" else tsp.spmm_pallas_mxu
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    want = _jax_vjp(lambda ww, hh: jfn(src, dst, ww, hh, True), w, h, g)
    got = _torch_vjp(lambda ww, hh: tfn(s_t, d_t, ww, hh), w, h, g)
    _close(got, want)
    assert tsp.rows_launches.fwd_launches == tsp.edge_block_launches.fwd_launches == 0


@pytest.mark.parametrize("kind,f", CASES)
def test_block_coo_function_matches_jax_kernel(kind, f):
    """SpmmBlockCooFn vs spmm_block_coo on structures built by each
    package's builder (equal field for field): forward, dh over the
    transpose orientation, and dw per slot (null slots exactly 0)."""
    src, dst, w = _stream(kind)
    real = w > 0
    src, dst, w = src[real], dst[real], w[real]
    h, g = _hg(f, seed=1)
    js = jbc.build_block_coo(src, dst, N)
    ts = tbc.build_block_coo(src, dst, N)
    wp, wpT = tbc.pad_weights(ts, w), tbc.pad_weights_t(ts, w)
    np.testing.assert_array_equal(wp, jbc.pad_weights(js, w))
    want = _jax_vjp(lambda ww, hh: jbc.spmm_block_coo(js, ww, jnp.asarray(wpT), hh, True),
                    wp, h, g)
    st = ts.map(torch.from_numpy)
    got = _torch_vjp(lambda ww, hh: tbc.spmm_block_coo(st, ww, torch.from_numpy(wpT), hh),
                     wp, h, g)
    _close(got, want)
    assert (got[2][np.asarray(ts.perm) < 0] == 0).all()
    assert tbc.launches.fwd_launches == tbc.launches.bwd_launches == 0


@pytest.mark.parametrize("f", [1, 32, 97])
def test_plain_versions_match_xla(f):
    src, dst, w = _stream("unsorted")
    h, g = _hg(f, seed=2)
    want = spmm_xla(jnp.asarray(src), jnp.asarray(np.sort(dst)), jnp.asarray(w),
                    jnp.asarray(h), N)
    got = tspmm.spmm_plain(torch.from_numpy(src), torch.from_numpy(np.sort(dst)),
                           torch.from_numpy(w), torch.from_numpy(h), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    want = sddmm_xla(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(h), jnp.asarray(g))
    got = tspmm.sddmm_plain(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(h), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plain_on_an_empty_stream():
    h = torch.ones(N, 4)
    z = torch.zeros(0, dtype=torch.int32)
    for fn in (tsp.spmm_pallas, tsp.spmm_pallas_mxu):
        out = fn(z, z, torch.zeros(0), h)
        assert out.shape == (N, 4) and (out == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_edge_order_ranges_and_permutations(masked):
    """The orders the CUDA kernels walk: positions of each destination
    (source) row contiguous and in stable edge order; masked-out edges
    past row_ptr[N]."""
    src, dst, w = _stream("unsorted")
    mask = (w > 0).astype(np.float32)
    o = tspmm.edge_order(torch.from_numpy(src), torch.from_numpy(dst), N,
                         edge_mask=torch.from_numpy(mask) if masked else None)
    keep = mask > 0 if masked else np.ones(len(src), bool)
    m = keep.sum()
    for key, other, perm, rp, col in ((dst, src, o.perm, o.row_ptr, o.col),
                                      (src, dst, o.permT, o.row_ptrT, o.colT)):
        want = np.flatnonzero(keep)[np.argsort(key[keep], kind="stable")]
        assert perm.dtype == rp.dtype == col.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy()[:m], want)
        np.testing.assert_array_equal(rp.numpy(), np.searchsorted(
            np.sort(key[keep]), np.arange(N + 1)))
        # the column of each position: src (dst) of the edge there
        np.testing.assert_array_equal(col.numpy()[:m], other[want])


def test_edge_order_of_a_sorted_stream_skips_the_sort():
    src, dst, w = _stream("random")
    src_t = torch.from_numpy(src)
    o = tspmm.edge_order(src_t, torch.from_numpy(dst), N,
                         edge_mask=torch.from_numpy((w > 0).astype(np.float32)),
                         dst_sorted=True)
    assert o.perm is None
    assert int(o.row_ptr[-1]) == int((w > 0).sum())  # padding left out
    assert o.col is src_t  # the stream's own sources, no copy
    m = int(o.row_ptrT[-1])
    np.testing.assert_array_equal(o.colT.numpy()[:m], dst[o.permT.numpy()[:m]])


@pytest.mark.parametrize("dst_sorted", [False, True])
def test_position_columns_fill_an_order_without_them(dst_sorted):
    """An order built without col / colT (the fields default to None) gets
    the same columns as `edge_order` gives; one that has them is kept."""
    src, dst, w = _stream("random" if dst_sorted else "unsorted")
    s_t, d_t = torch.from_numpy(src), torch.from_numpy(dst)
    o = tspmm.edge_order(s_t, d_t, N, dst_sorted=dst_sorted)
    bare = tspmm.EdgeOrder(perm=o.perm, row_ptr=o.row_ptr, permT=o.permT,
                           row_ptrT=o.row_ptrT)
    assert bare.col is None and bare.colT is None
    full = tspmm.position_columns(bare, s_t, d_t)
    assert torch.equal(full.col, o.col) and torch.equal(full.colT, o.colT)
    assert tspmm.position_columns(o, s_t, d_t) is o


def test_dispatcher_names():
    """Every name computes the same function on the CPU; "auto" is not a
    dispatcher name (Config resolves it to one that is); "pallas" takes the
    structure when one is given."""
    src, dst, w = _stream("duplicates")
    h, _ = _hg(8)
    args = [torch.from_numpy(a) for a in (src, dst, w, h)]
    want = tspmm.spmm_plain(*args, N)
    assert Config().resolved_spmm_impl() in tspmm.IMPLS
    with pytest.raises(ValueError, match="unknown"):
        tspmm.spmm(*args, N, impl="auto")
    for impl in tspmm.IMPLS:
        torch.testing.assert_close(tspmm.spmm(*args, N, impl=impl), want)
    real = w > 0
    s = tbc.build_block_coo(src[real], dst[real], N)
    kw = dict(structure=s.map(torch.from_numpy),
              w_pad=torch.from_numpy(tbc.pad_weights(s, w[real])),
              w_padT=torch.from_numpy(tbc.pad_weights_t(s, w[real])))
    torch.testing.assert_close(tspmm.spmm(*args, N, impl="pallas", **kw), want,
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="w_pad"):
        tspmm.spmm(*args, N, impl="pallas", structure=kw["structure"])
    with pytest.raises(ValueError, match="unknown"):
        tspmm.spmm(*args, N, impl="other")
    with pytest.raises(ValueError, match="rows"):
        tspmm.spmm(*args, N + 1, impl="xla")


def test_block_coo_wide_features_and_plain_function():
    """block_coo_plain (the kernel's function, read off the structure)
    equals the plain SpMM over the edges; F past 128 works on the CPU."""
    src, dst, w = _stream("random")
    real = w > 0
    s = tbc.build_block_coo(src[real], dst[real], N, pad_items_to=40)
    st = s.map(torch.from_numpy)
    h = torch.randn(N, 130)
    got = tbc.block_coo_plain(st.row_ptr, st.item_c, st.ls, st.ld,
                              torch.from_numpy(tbc.pad_weights(s, w[real])), h)
    want = tspmm.spmm_plain(torch.from_numpy(src), torch.from_numpy(dst),
                            torch.from_numpy(w), h, N)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    rows = tbc._item_rows(st.row_ptr, st.ls.shape[0])
    np.testing.assert_array_equal(rows.numpy(), np.asarray(s.item_r))


def _slot_order_reference(row_ptr, ld, perm, n):
    """The slot order from its definition, item by item: each output row's
    items in run order, each item's slots stably argsorted by ld, null
    slots left out; returns (flat slot order, row pointers [n + 1])."""
    row_ptr, ld, perm = (np.asarray(a) for a in (row_ptr, ld, perm))
    eb = ld.shape[1]
    per_row = [[] for _ in range(n)]
    for r in range(len(row_ptr) - 1):
        for j in range(row_ptr[r], row_ptr[r + 1]):
            for q in np.argsort(ld[j], kind="stable"):
                if perm[j, q] >= 0:
                    per_row[r * tbc.BS + ld[j, q]].append(j * eb + q)
    order = [q for row in per_row for q in row]
    return np.array(order, np.int64), np.r_[0, np.cumsum([len(r) for r in per_row])]


def _walk(order, row_ptr, item_c, ls, w, h):
    """The kernel's walk over a slot order, in plain PyTorch: row i adds
    w[q]·h[item_c[q // EB]·BS + ls[q]] for the q at its positions."""
    eb = ls.shape[1]
    m = int(row_ptr[-1])
    q = order[:m].long()
    rows = torch.repeat_interleave(torch.arange(len(row_ptr) - 1),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    src = item_c.long()[q // eb] * tbc.BS + ls.reshape(-1).long()[q]
    return torch.zeros_like(h).index_add_(0, rows, w.reshape(-1)[q, None] * h[src])


@pytest.mark.parametrize("kind", KINDS)
def test_block_coo_order_equals_its_definition(kind):
    """Both orientations of `block_coo_order` against the item-by-item
    reference, on a structure with sentinel items past the real ones; two
    calls give the same tensors."""
    src, dst, w = _stream(kind)
    real = w > 0
    s = tbc.build_block_coo(src[real], dst[real], N)
    s = tbc.pad_structure(s, max(s.ls.shape[0], s.lsT.shape[0]) + 3)
    st = s.map(torch.from_numpy)
    o = tbc.block_coo_order(st, N)
    again = tbc.block_coo_order(st, N)
    for perm, rp, (row_ptr, ld, sp) in (
            (o.perm, o.row_ptr, (s.row_ptr, s.ld, s.perm)),
            (o.permT, o.row_ptrT, (s.row_ptrT, s.ldT, s.permT))):
        want, want_rp = _slot_order_reference(row_ptr, ld, sp, N)
        assert perm.dtype == rp.dtype == torch.int32
        assert perm.shape == (np.asarray(ld).size,) and rp.shape == (N + 1,)
        np.testing.assert_array_equal(rp.numpy(), want_rp)
        np.testing.assert_array_equal(perm.numpy()[: len(want)], want)
    for a, b in ((o.perm, again.perm), (o.row_ptr, again.row_ptr),
                 (o.permT, again.permT), (o.row_ptrT, again.row_ptrT)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,f", [("random", 32), ("duplicates", 1), ("filled", 97),
                                    ("unsorted", 160), ("empty", 4)])
def test_block_coo_walk_through_the_order_equals_plain(kind, f):
    """The kernel's function taken through the slot order equals
    `block_coo_plain`, forward and over the transpose orientation."""
    src, dst, w = _stream(kind)
    real = w > 0
    s = tbc.build_block_coo(src[real], dst[real], N, pad_items_to=48)
    st = s.map(torch.from_numpy)
    wp = torch.from_numpy(tbc.pad_weights(s, w[real]))
    wpT = torch.from_numpy(tbc.pad_weights_t(s, w[real]))
    o = tbc.block_coo_order(st, N)
    h, g = (torch.from_numpy(a) for a in _hg(f, seed=3))
    torch.testing.assert_close(
        _walk(o.perm, o.row_ptr, st.item_c, st.ls, wp, h),
        tbc.block_coo_plain(st.row_ptr, st.item_c, st.ls, st.ld, wp, h),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        _walk(o.permT, o.row_ptrT, st.item_cT, st.lsT, wpT, g),
        tbc.block_coo_plain(st.row_ptrT, st.item_cT, st.lsT, st.ldT, wpT, g),
        rtol=RTOL, atol=ATOL)


def _good_stream():
    src, dst, w = _stream("random")
    h, _ = _hg(4)
    return [torch.from_numpy(a) for a in (src, dst, w, h)]


def _bad_stream_cases():
    def with_(i, fn):
        def make():
            a = _good_stream()
            a[i] = fn(a[i])
            return a
        return make

    return {
        "src_i64": (with_(0, lambda t: t.long()), TypeError),
        "w_f64": (with_(2, lambda t: t.double()), TypeError),
        "h_bf16": (with_(3, lambda t: t.bfloat16()), TypeError),
        "h_1d": (with_(3, lambda t: t[:, 0].contiguous()), ValueError),
        "dst_len": (with_(1, lambda t: t[:-1]), ValueError),
        "h_noncontig": (with_(3, lambda t: torch.zeros(N, 8)[:, ::2]), ValueError),
        "device_meta": (lambda: [a.to("meta") for a in _good_stream()], ValueError),
        "device_mixed": (with_(2, lambda t: t.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_stream_cases()))
@pytest.mark.parametrize("kernel", ["rows", "edge_block"])
def test_edge_stream_wrappers_reject_bad_inputs(kernel, case):
    make, exc = _bad_stream_cases()[case]
    fn = tsp.spmm_pallas if kernel == "rows" else tsp.spmm_pallas_mxu
    with pytest.raises(exc):
        fn(*make())


def test_edge_order_inputs_are_checked():
    src, dst, w, h = _good_stream()
    o = tspmm.edge_order(src, dst, N)
    bad = tspmm.EdgeOrder(perm=o.perm, row_ptr=o.row_ptr[:-1], permT=o.permT,
                          row_ptrT=o.row_ptrT)
    with pytest.raises(ValueError, match="row_ptr"):
        tsp.spmm_pallas(src, dst, w, h, bad)
    bad = tspmm.EdgeOrder(perm=o.perm.long(), row_ptr=o.row_ptr, permT=o.permT,
                          row_ptrT=o.row_ptrT)
    with pytest.raises(TypeError, match="perm"):
        tsp.spmm_pallas_mxu(src, dst, w, h, bad)


def _bad_column_cases():
    import dataclasses

    return {
        "col_i64": (lambda o: dataclasses.replace(o, col=o.col.long()), TypeError),
        "colT_i64": (lambda o: dataclasses.replace(o, colT=o.colT.long()), TypeError),
        "col_short": (lambda o: dataclasses.replace(o, col=o.col[:-1]), ValueError),
        "colT_2d": (lambda o: dataclasses.replace(o, colT=o.colT[:, None]), ValueError),
        "col_device": (lambda o: dataclasses.replace(o, col=o.col.to("meta")), ValueError),
        "colT_noncontig": (lambda o: dataclasses.replace(
            o, colT=torch.stack([o.colT, o.colT], 1)[:, 0]), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_column_cases()))
@pytest.mark.parametrize("kernel", ["rows", "edge_block"])
def test_edge_order_columns_are_checked(kernel, case):
    """`check_inputs` refuses a bad position column like the order's other
    fields."""
    src, dst, w, h = _good_stream()
    spoil, exc = _bad_column_cases()[case]
    fn = tsp.spmm_pallas if kernel == "rows" else tsp.spmm_pallas_mxu
    with pytest.raises(exc, match="col"):
        fn(src, dst, w, h, spoil(tspmm.edge_order(src, dst, N)))


@pytest.mark.parametrize("name", list(tsp.ENTRY_ARGS))
def test_ctypes_signatures_match_the_c_entries(name):
    """`<name>_f32` of csrc/<name>.cu against the argument types the
    wrapper binds: pointers, then ints, then the stream pointer."""
    import os
    import re

    path = os.path.join(os.path.dirname(tspmm.__file__), "..", "csrc", f"{name}.cu")
    with open(path) as f:
        entries = dict(re.findall(r'extern "C" [\w\s*]+?\b(\w+)\(([^)]*)\)', f.read()))
    assert set(entries) == {f"{name}_f32", f"{name}_error_string"}
    n_ptr, n_int = tsp.ENTRY_ARGS[name]
    kinds = ["ptr" if "*" in p else "int" for p in entries[f"{name}_f32"].split(",")]
    assert kinds == ["ptr"] * n_ptr + ["int"] * n_int + ["ptr"]


# -- the CUDA kernels' designs, walked on the CPU ----------------------------


def _fmaf(a, b, c):
    """fmaf in float32, taken in float64 (the product of two float32 values
    is exact there) and rounded to float32: both walks below use it, so
    their bits differ only where their order of operations does."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _direction(o, src, dst, transpose):
    """(row_ptr, perm, row by edge, col by edge, col by position) of one
    direction of an order, as numpy arrays."""
    if transpose:
        return o.row_ptrT.numpy(), o.permT.numpy(), src, dst, o.colT.numpy()
    perm = None if o.perm is None else o.perm.numpy()
    return o.row_ptr.numpy(), perm, dst, src, o.col.numpy()


def _edge_block_walk(row_ptr, perm, row, colp, w, h, block_order):
    """csrc/spmm_edge_block.cu's current design, block by block in
    `block_order(grid)`: 256-position blocks; each run summed in position
    order; a straddling row's partials (the first block's tail, later
    blocks' heads) summed in block order by the block that arrives last on
    its counter; rows with no edge zeroed by the block whose slice of the
    rows holds them. Returns (out, writes per row, counters after the
    launch)."""
    eb = tsp.EDGE_BLOCK
    n, f, n_pos = len(row_ptr) - 1, h.shape[1], len(row)
    e_real = int(row_ptr[n])
    grid = max(1, -(-n_pos // eb))
    edge = (lambda p: p) if perm is None else (lambda p: int(perm[p]))
    out = np.full((n, f), np.nan, np.float32)
    partial = np.full((2 * grid, f), np.nan, np.float32)
    writes, counters = np.zeros(n, int), np.zeros(n, int)

    def write(r, v):
        out[r] = v
        writes[r] += 1

    slice_ = -(-n // grid)
    for b in block_order(grid):
        base = b * eb
        for r in range(b * slice_, min(n, (b + 1) * slice_)):
            if row_ptr[r] == row_ptr[r + 1]:
                write(r, 0)
        cnt = max(0, min(eb, e_real - base))
        if cnt == 0:
            continue
        rows = [int(row[edge(base + t)]) for t in range(cnt)]
        prev = int(row[edge(base - 1)]) if base > 0 else -1
        nxt = int(row[edge(base + eb)]) if base + eb < e_real else -1
        starts = [t for t in range(cnt) if t == 0 or rows[t - 1] != rows[t]] + [cnt]
        runs = [rows[t] for t in starts[:-1]]
        head, tail = prev == rows[0], nxt == rows[-1]
        for k, r in enumerate(runs):
            acc = np.zeros(f, np.float32)
            for q in range(starts[k], starts[k + 1]):
                acc = _fmaf(w[edge(base + q)], h[colp[base + q]], acc)
            if k == 0 and head:
                partial[2 * b] = acc
            elif k == len(runs) - 1 and tail:
                partial[2 * b + 1] = acc
            else:
                write(r, acc)
        for s, flag, r in ((0, head, rows[0]), (1, tail, rows[-1])):
            if not flag or (s == 1 and head and len(runs) == 1):
                continue
            b0, b1 = row_ptr[r] // eb, (row_ptr[r + 1] - 1) // eb
            counters[r] += 1
            if counters[r] == b1 - b0 + 1:  # the last arrival finishes the row
                counters[r] = 0
                acc = partial[2 * b0 + 1]
                for bb in range(b0 + 1, b1 + 1):
                    acc = acc + partial[2 * bb]
                write(r, acc)
    return out, writes, counters


def _edge_block_walk_earlier(row_ptr, perm, row, col, w, h):
    """The earlier design: pass 1 sums each block's runs through
    perm -> col, straddling rows into the partial slots; pass 2 writes
    empty rows as zeros and sums straddling rows in block order."""
    eb = tsp.EDGE_BLOCK
    n, f = len(row_ptr) - 1, h.shape[1]
    e_real = int(row_ptr[n])
    edge = (lambda p: p) if perm is None else (lambda p: int(perm[p]))
    out = np.full((n, f), np.nan, np.float32)
    partial = np.full((2 * max(1, -(-len(row) // eb)), f), np.nan, np.float32)
    for b in range(-(-e_real // eb)):
        base = b * eb
        cnt = min(eb, e_real - base)
        rows = [int(row[edge(base + t)]) for t in range(cnt)]
        starts = [t for t in range(cnt) if t == 0 or rows[t - 1] != rows[t]] + [cnt]
        for t0, t1 in zip(starts[:-1], starts[1:]):
            i = rows[t0]
            b0, b1 = row_ptr[i] // eb, (row_ptr[i + 1] - 1) // eb
            acc = np.zeros(f, np.float32)
            for p in range(base + t0, base + t1):
                acc = _fmaf(w[edge(p)], h[col[edge(p)]], acc)
            if b0 == b1:
                out[i] = acc
            else:
                partial[2 * b + (1 if b == b0 else 0)] = acc
    for i in range(n):
        p0, p1 = row_ptr[i], row_ptr[i + 1]
        if p0 == p1:
            out[i] = 0
            continue
        b0, b1 = p0 // eb, (p1 - 1) // eb
        if b0 != b1:
            acc = partial[2 * b0 + 1]
            for b in range(b0 + 1, b1 + 1):
                acc = acc + partial[2 * b]
            out[i] = acc
    return out


def _rows_walk_sequential(row_ptr, perm, col, w, h):
    """The earlier row design (spmm_seq.cuh run_sum): each row's edges one
    at a time, perm -> col -> h, acc = fmaf(w, h, acc) from 0."""
    n, f = len(row_ptr) - 1, h.shape[1]
    out = np.zeros((n, f), np.float32)
    for i in range(n):
        acc = np.zeros(f, np.float32)
        for p in range(row_ptr[i], row_ptr[i + 1]):
            e = p if perm is None else perm[p]
            acc = _fmaf(w[e], h[col[e]], acc)
        out[i] = acc
    return out


def _rows_walk_lanes(row_ptr, perm, colp, w, h, k=8):
    """csrc/spmm_rows.cu's current design: G lanes per row (8 with V = 4
    columns a lane where f % 4 == 0, else 32 lanes of one column; at f = 1
    eight lanes of one edge each); per G positions the lanes load one
    (column, weight) pair each, then the group issues K = 8 h loads and
    adds them in order, the values broadcast from the lane that loaded
    them. A lane's columns are independent, so they are walked together."""
    n, f = len(row_ptr) - 1, h.shape[1]
    g, v = (8, 1) if f == 1 else (8, 4) if f % 4 == 0 else (32, 1)
    edge = (lambda p: p) if perm is None else (lambda p: int(perm[p]))
    out = np.full((n, f), np.nan, np.float32)
    for i in range(n):
        p0, p1 = row_ptr[i], row_ptr[i + 1]
        if f == 1:
            acc = np.zeros(1, np.float32)
            for pb in range(p0, p1, g):
                lanes = [(w[edge(p)], h[colp[p]]) for p in range(pb, min(pb + g, p1))]
                for wl, hl in lanes:  # shuffled from lane 0, 1, ...
                    acc = _fmaf(wl, hl, acc)
            out[i] = acc
            continue
        for c0 in range(0, f, g * v):
            cols = np.arange(c0, min(c0 + g * v, f))
            acc = np.zeros(len(cols), np.float32)
            for pb in range(p0, p1, g):
                m = min(g, p1 - pb)
                src = [colp[pb + lane] for lane in range(m)]
                ws = [w[edge(pb + lane)] for lane in range(m)]
                for k0 in range(0, m, k):
                    hv = [h[src[j], cols] for j in range(k0, min(k0 + k, m))]
                    for j, x in enumerate(hv, start=k0):
                        acc = _fmaf(ws[j], x, acc)
            out[i, cols] = acc
    return out


def _walk_inputs(kind, f):
    src, dst, w = _stream(kind)
    o = tspmm.edge_order(torch.from_numpy(src), torch.from_numpy(dst), N,
                         edge_mask=torch.from_numpy((w > 0).astype(np.float32)))
    h, g = _hg(f, seed=4)
    return src, dst, w, o, h, g


@pytest.mark.parametrize("f", [1, 32, 97])
@pytest.mark.parametrize("kind", WALK_KINDS)
def test_edge_block_walk_matches_plain_and_jax(kind, f):
    """The edge-block kernel's current design, walked on the CPU with its
    blocks in a shuffled order, forward and over the source order (dh):
    every row written exactly once, the counters left at 0, the bits of
    the earlier two-pass design, and the values of `spmm_plain` and of
    JAX's `spmm_pallas_mxu` in interpret mode. "long_row" has a row over
    at least 3 blocks both ways; "empty" has no real edge."""
    src, dst, w, o, h, g = _walk_inputs(kind, f)
    want = _jax_vjp(lambda ww, hh: j_mxu(src, dst, ww, hh, True), w, h, g)
    plain = (tspmm.spmm_plain(*map(torch.from_numpy, (src, dst, w, h)), N).numpy(),
             tspmm.spmm_plain(*map(torch.from_numpy, (dst, src, w, g)), N).numpy())
    shuffled = lambda grid: np.random.default_rng(grid).permutation(grid)  # noqa: E731
    for transpose, x, jax_out, plain_out in ((False, h, want[0], plain[0]),
                                            (True, g, want[1], plain[1])):
        row_ptr, perm, row, col, colp = _direction(o, src, dst, transpose)
        got, writes, counters = _edge_block_walk(row_ptr, perm, row, colp, w, x, shuffled)
        assert (writes == 1).all() and (counters == 0).all()
        np.testing.assert_array_equal(
            got, _edge_block_walk_earlier(row_ptr, perm, row, col, w, x))
        np.testing.assert_allclose(got, plain_out, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_out, rtol=RTOL, atol=ATOL)
        assert (got[row_ptr[1:] == row_ptr[:-1]] == 0).all()
        if kind == "long_row":
            spans = (row_ptr[1:] - 1) // tsp.EDGE_BLOCK - row_ptr[:-1] // tsp.EDGE_BLOCK + 1
            assert spans[row_ptr[1:] > row_ptr[:-1]].max() >= 3
        if kind == "empty":
            assert row_ptr[-1] == 0


@pytest.mark.parametrize("f", [1, 4, 32, 97])
@pytest.mark.parametrize("kind", WALK_KINDS)
def test_rows_lane_split_equals_sequential_walk(kind, f):
    """The row kernel's lane split (columns by position, K loads in flight,
    values broadcast from the loading lane) gives the bits of the earlier
    design's sequential walk (perm -> col -> h), forward and over the
    source order, and the plain version's values."""
    src, dst, w, o, h, g = _walk_inputs(kind, f)
    for transpose, x in ((False, h), (True, g)):
        row_ptr, perm, row, col, colp = _direction(o, src, dst, transpose)
        got = _rows_walk_lanes(row_ptr, perm, colp, w, x)
        np.testing.assert_array_equal(got, _rows_walk_sequential(row_ptr, perm, col, w, x))
        a, b = (src, dst) if not transpose else (dst, src)
        np.testing.assert_allclose(got, tspmm.spmm_plain(
            *map(torch.from_numpy, (a, b, w, x)), N).numpy(), rtol=RTOL, atol=ATOL)


def _good_block():
    src, dst, w = _stream("random")
    real = w > 0
    s = tbc.build_block_coo(src[real], dst[real], N)
    return [s.map(torch.from_numpy), torch.from_numpy(tbc.pad_weights(s, w[real])),
            torch.from_numpy(tbc.pad_weights_t(s, w[real])), torch.zeros(N, 4)]


def _bad_block_cases():
    def with_(i, fn):
        def make():
            a = _good_block()
            a[i] = fn(a[i])
            return a
        return make

    import dataclasses

    return {
        "h_rows": (with_(3, lambda t: torch.zeros(N - 1, 4)), ValueError),
        "h_nb": (with_(3, lambda t: torch.zeros(2 * N, 4)), ValueError),
        "h_f64": (with_(3, lambda t: t.double()), TypeError),
        "w_shape": (with_(1, lambda t: t[:-1].contiguous()), ValueError),
        "numpy_structure": (with_(0, lambda s: s.map(lambda a: a.numpy())), TypeError),
        "i64_structure": (with_(0, lambda s: s.map(lambda a: a.long())), TypeError),
        "ld_shape": (with_(0, lambda s: dataclasses.replace(s, ld=s.ld[:, :128].contiguous())),
                     ValueError),
        "device_meta": (lambda: [a.map(lambda t: t.to("meta")) if i == 0 else a.to("meta")
                                 for i, a in enumerate(_good_block())], ValueError),
        "order_perm_missing": (with_order(lambda o: dataclasses.replace(o, perm=None)),
                               TypeError),
        "order_perm_i64": (with_order(lambda o: dataclasses.replace(o, permT=o.permT.long())),
                           TypeError),
        "order_perm_shape": (with_order(lambda o: dataclasses.replace(o, perm=o.perm[:-1])),
                             ValueError),
        "order_row_ptr_shape": (
            with_order(lambda o: dataclasses.replace(o, row_ptrT=o.row_ptrT[:-1])), ValueError),
        "order_device": (with_order(lambda o: dataclasses.replace(o, perm=o.perm.to("meta"))),
                         ValueError),
    }


def with_order(fn):
    """A good block-COO call whose slot order `fn` spoils."""
    def make():
        a = _good_block()
        return a + [fn(tbc.block_coo_order(a[0], N))]
    return make


@pytest.mark.parametrize("case", list(_bad_block_cases()))
def test_block_coo_wrapper_rejects_bad_inputs(case):
    make, exc = _bad_block_cases()[case]
    with pytest.raises(exc):
        tbc.spmm_block_coo(*make())


def test_block_coo_wrapper_takes_a_good_order():
    a = _good_block()
    want = tbc.spmm_block_coo(*a)
    torch.testing.assert_close(tbc.spmm_block_coo(*a, tbc.block_coo_order(a[0], N)), want)
