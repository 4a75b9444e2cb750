"""The port's COO SpMM (dgcnn_tpu_torch/ops/spmm.py,
kernels/spmm_pallas.py, kernels/spmm_block_coo.py) against the JAX
reference: each kernel's autograd Function on CPU tensors (which runs the
plain version forward and transposed) against `spmm_pallas`,
`spmm_pallas_mxu` and `spmm_block_coo` in Pallas interpret mode (as the JAX
package's own tests run them), forward, dh and dw at the reference's
tolerances; `spmm_plain`/`sddmm_plain` against `spmm_xla`/`sddmm_xla`; the
edge orders the CUDA kernels walk; the dispatcher's names; the wrappers'
input checks. The CUDA kernels are held against the plain version on the
card by chip_smoke.py."""

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


@functools.lru_cache(maxsize=None)
def _stream(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "random":
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
    for key, perm, rp in ((dst, o.perm, o.row_ptr), (src, o.permT, o.row_ptrT)):
        want = np.flatnonzero(keep)[np.argsort(key[keep], kind="stable")]
        assert perm.dtype == rp.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy()[: keep.sum()], want)
        np.testing.assert_array_equal(rp.numpy(), np.searchsorted(
            np.sort(key[keep]), np.arange(N + 1)))


def test_edge_order_of_a_sorted_stream_skips_the_sort():
    src, dst, w = _stream("random")
    o = tspmm.edge_order(torch.from_numpy(src), torch.from_numpy(dst), N,
                         edge_mask=torch.from_numpy((w > 0).astype(np.float32)),
                         dst_sorted=True)
    assert o.perm is None
    assert int(o.row_ptr[-1]) == int((w > 0).sum())  # padding left out


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
