"""The port's GCN trunk (dgcnn_tpu_torch/kernels/dense_trunk.py) against the
JAX reference: the plain forward and the written-out backward vs
`gcn_trunk_fused` in Pallas interpret mode (as tests/test_dense_trunk.py
runs it) and the einsum chain; `GcnTrunkFn` on CPU tensors vs autograd of
the plain forward; and the wrapper's input checks. The CUDA kernels
themselves are held against the plain version on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.dense_trunk import gcn_trunk_fused
from dgcnn_tpu_torch.kernels import dense_trunk as dt
import torch_threads  # noqa: F401  (torch on one CPU thread)

CASES = [
    pytest.param(t, dims, id=f"T{t}-{'x'.join(map(str, dims))}")
    for t in (8, 40)
    for dims in ((32, 32, 32, 1), (16, 8, 1))
]


def _case(dims, t, seed=0, s=4, k=2):
    rng = np.random.default_rng(seed)
    adj = rng.normal(size=(s, t, t)).astype(np.float32) * 0.1
    adj = (adj + adj.transpose(0, 2, 1)) / 2  # symmetric, as GCN norm is
    hw1 = rng.normal(size=(s, t, dims[0])).astype(np.float32)
    mask = (rng.random((s, t)) > 0.25).astype(np.float32)
    wsel = rng.integers(0, k, s).astype(np.int32)
    ws = [rng.normal(size=(k, a, b)).astype(np.float32) * 0.3
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [rng.normal(size=(k, d)).astype(np.float32) * 0.1 for d in dims]
    g = rng.normal(size=(s, t, sum(dims))).astype(np.float32)
    return adj, hw1, mask, wsel, ws, bs, g


def _einsum_chain(dims, adj, hw1, mask, wsel, ws, bs):
    outs, hw = [], hw1
    for i in range(len(dims)):
        h = jnp.tanh(jnp.einsum("sij,sjf->sif", adj, hw) + bs[i][wsel][:, None, :])
        h = h * mask[:, :, None]
        outs.append(h)
        if i + 1 < len(dims):
            hw = jnp.einsum("snd,sdo->sno", h, ws[i][wsel])
    return jnp.concatenate(outs, axis=-1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("t,dims", CASES)
def test_plain_forward_and_backward_match_jax(t, dims):
    """Forward vs the Pallas kernel (interpret mode) and the einsum chain at
    the JAX test's rtol 1e-5 / atol 1e-6; the written-out backward plus the
    one-hot segment-sum vs jax's VJP of the kernel at rtol 2e-4 / atol 2e-5."""
    adj, hw1, mask, wsel, ws, bs, g = _case(dims, t)
    ja, jm, jw = map(jnp.asarray, (adj, mask, wsel))
    jws, jbs = tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))
    want_cat, vjp = jax.vjp(
        lambda h, w, b: gcn_trunk_fused(dims, True, ja, h, jm, jw, w, b),
        jnp.asarray(hw1), jws, jbs,
    )
    want_grads = jax.tree_util.tree_leaves(vjp(jnp.asarray(g)))
    want_chain = _einsum_chain(dims, ja, jnp.asarray(hw1), jm, jw, jws, jbs)

    cat = dt.gcn_trunk_plain(dims, _t(adj), _t(hw1), _t(mask), _t(wsel),
                             list(map(_t, ws)), list(map(_t, bs)))
    np.testing.assert_allclose(cat.numpy(), np.asarray(want_cat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cat.numpy(), np.asarray(want_chain), rtol=1e-5, atol=1e-6)

    d_hw1, dws_slot, dbs_slot = dt.gcn_trunk_plain_bwd(
        dims, _t(adj), _t(mask), _t(wsel), list(map(_t, ws)), cat, _t(g)
    )
    k = bs[0].shape[0]
    got = [d_hw1] + [
        dt._segment_sum(x.reshape(x.shape[0], -1), _t(wsel), k).reshape(k, *x.shape[1:])
        for x in (*dws_slot, *dbs_slot)
    ]
    assert len(got) == len(want_grads)
    for a, b in zip(got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("t,dims", CASES)
def test_trunk_fn_grad_matches_autograd_of_plain_forward(t, dims):
    adj, hw1, mask, wsel, ws, bs, g = _case(dims, t, seed=2, k=3)

    def grads(fn):
        leaves = [_t(a).requires_grad_() for a in (hw1, *ws, *bs)]
        n = len(dims)
        cat = fn(dims, _t(adj), leaves[0], _t(mask), _t(wsel),
                 leaves[1:n], leaves[n:])
        return torch.autograd.grad(cat, leaves, _t(g))

    for a, b in zip(grads(dt.gcn_trunk), grads(dt.gcn_trunk_plain)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


def test_cpu_trunk_launches_no_kernel():
    dims = (32, 32, 32, 1)
    adj, hw1, mask, wsel, ws, bs, g = _case(dims, 8)
    dt.launches.reset()
    leaves = [_t(a).requires_grad_() for a in (hw1, *ws, *bs)]
    cat = dt.gcn_trunk(dims, _t(adj), leaves[0], _t(mask), _t(wsel),
                       leaves[1:4], leaves[4:])
    cat.backward(_t(g))
    assert (dt.launches.fwd_launches, dt.launches.bwd_launches) == (0, 0)


def test_grad_layout_round_trips():
    dims = (16, 8, 1)
    woff, dboff, p = dt._grad_layout(dims)
    assert p == 16 * 8 + 8 * 1 + 16 + 8 + 1
    flat = torch.arange(2 * p, dtype=torch.float32).reshape(2, p)
    dws, dbs = dt._split_grads(flat, dims)
    assert [tuple(x.shape) for x in dws] == [(2, 16, 8), (2, 8, 1)]
    assert [tuple(x.shape) for x in dbs] == [(2, 16), (2, 8), (2, 1)]
    back = torch.cat([x.reshape(2, -1) for x in (*dws, *dbs)], dim=1)
    assert torch.equal(back, flat)


def _args(dims=(32, 32, 32, 1), t=8):
    adj, hw1, mask, wsel, ws, bs, _ = _case(dims, t)
    return [dims, _t(adj), _t(hw1), _t(mask), _t(wsel),
            list(map(_t, ws)), list(map(_t, bs))]


@pytest.mark.parametrize("mutate,exc", [
    (lambda a: a.__setitem__(0, (32,) * 9), ValueError),
    (lambda a: a.__setitem__(0, (129, 1)), ValueError),
    (lambda a: a.__setitem__(2, a[2].to(torch.bfloat16)), TypeError),
    (lambda a: a.__setitem__(2, a[2].double()), TypeError),
    (lambda a: a.__setitem__(4, a[4].long()), TypeError),
    (lambda a: a.__setitem__(1, a[1].transpose(1, 2)), ValueError),
    (lambda a: a.__setitem__(3, a[3][:, :4].contiguous()), ValueError),
    (lambda a: a[5].pop(), ValueError),
], ids=["layers", "width", "bf16", "dtype", "wsel", "strided", "mask", "nweights"])
def test_wrapper_rejects_what_the_kernel_does_not_take(mutate, exc):
    args = _args()
    mutate(args)
    with pytest.raises(exc):
        dt.gcn_trunk(*args)


# -- the kernels' plan and band decomposition (pure Python: the kernels
# themselves run on the card, under chip_smoke.py) -------------------------

DEFAULT = (32, 32, 32, 1)
WIDE = (128, 128, 128, 1)


@pytest.mark.parametrize("t,regime", [(32, "resident"), (88, "resident"),
                                      (112, "resident"), (176, "resident"),
                                      (624, "streamed"), (2048, "streamed")])
def test_plan_regime_at_the_main_paths_tiles(t, regime):
    plan = dt.trunk_plan(56, t, DEFAULT)
    assert plan.regime == regime
    assert dt.launches_per_call(plan, DEFAULT) == (
        (1, 1) if regime == "resident" else (4, 6))
    if regime == "resident":
        assert plan.c == 2  # 56 slots x 2 blocks reach half the 132 SMs
    else:
        assert plan.c == 0


def _cap(dims, s=56):
    t = 8
    while dt.trunk_plan(s, t + 8, dims).regime == "resident":
        t += 8
    return t


def test_wide_layers_lower_the_resident_cap():
    caps = [_cap(d) for d in (DEFAULT, (64, 64, 64, 1), WIDE)]
    assert caps[0] > caps[1] > caps[2] >= 32
    assert dt.trunk_plan(56, caps[0] + 8, DEFAULT).regime == "streamed"


@pytest.mark.parametrize("dims", [DEFAULT, (16, 8, 1), (64, 64, 64, 1), WIDE])
@pytest.mark.parametrize("s", [4, 56])
def test_every_resident_plan_fits_and_covers_the_tile(dims, s):
    for t in range(1, 420, 3):
        plan = dt.trunk_plan(s, t, dims)
        if plan.regime == "streamed":
            assert t > 16 and plan.fwd_smem <= dt.SMEM_MAX and plan.bwd_smem <= dt.SMEM_MAX
            continue
        assert plan.c in dt.CLUSTERS
        tb = dt.band_rows(t, plan.c)
        assert tb % 8 == 0 and plan.c * tb >= t > (plan.c - 1) * tb
        assert max(plan.fwd_smem, plan.bwd_smem) <= dt.SMEM_MAX
        assert (plan.fwd_smem, plan.bwd_smem) == dt.resident_smem(t, plan.c, dims)
        if 2 * s * plan.c < dt.NUM_SMS:  # C stops short only when a
            bigger = [c for c in dt.CLUSTERS if c > plan.c]  # larger one fails
            assert all(max(dt.resident_smem(t, c, dims)) > dt.SMEM_MAX
                       or (c - 1) * dt.band_rows(t, c) >= t for c in bigger)


def test_plan_reads_the_kernels_constants():
    assert (dt.SBM, dt.SBK, dt.SMEM_MAX) == (64, 32, 232448)
    forced = dt.trunk_plan(56, 88, DEFAULT, c=2)
    assert forced == ("resident", 2, *dt.resident_smem(88, 2, DEFAULT))
    assert dt.trunk_plan(56, 88, DEFAULT, regime="streamed").regime == "streamed"


def test_launch_counts_reset_every_regime():
    dt.launches.resident_fwd = dt.launches.streamed_bwd = dt.launches.fwd_launches = 3
    dt.launches.kernel_fwd = dt.launches.kernel_bwd = 3
    dt.launches.reset()
    assert set(vars(dt.launches).values()) == {0}
    assert set(vars(dt.launches)) == {"fwd_launches", "bwd_launches", "resident_fwd",
                                      "resident_bwd", "streamed_fwd", "streamed_bwd",
                                      "kernel_fwd", "kernel_bwd", "bf16_fwd", "bf16_bwd"}


def _bands(t, c):
    tb = dt.band_rows(t, c)
    return [(min(r * tb, t), min((r + 1) * tb, t)) for r in range(c)]


def _band_emulation(dims, adj, hw1, mask, wsel, ws, bs, g, c):
    """The resident kernels' decomposition in PyTorch: rank r of C owns a
    band of rows; per layer each band is aggregated against the gathered
    full hw (d_pre), and the per-band dW / db partials are summed in rank
    order. Returns (cat, d_hw1, flat [S, P])."""
    sel, m, n = wsel.long(), mask[..., None], len(dims)
    bands = _bands(adj.shape[1], c)
    hw, outs = hw1, []
    for i in range(n):
        hs = [torch.tanh(torch.bmm(adj[:, lo:hi], hw) + bs[i][sel][:, None, :])
              * m[:, lo:hi] for lo, hi in bands]
        outs.append(torch.cat(hs, 1))
        if i + 1 < n:  # every rank's band of the next hw, gathered
            hw = torch.cat([torch.bmm(h, ws[i][sel]) for h in hs], 1)
    cat = torch.cat(outs, -1)
    offs = dt._offsets(dims)
    woff, dboff, p = dt._grad_layout(dims)
    flat = torch.zeros((adj.shape[0], p))
    h_last = cat[..., offs[n - 1]:]
    d_pre = g[..., offs[n - 1]:] * m * (1 - h_last * h_last)
    d_hw1 = None
    for i in range(n - 1, -1, -1):
        d_hws = [torch.bmm(adj[:, lo:hi], d_pre) for lo, hi in bands]
        db = sum((d_pre[:, lo:hi].sum(1) for lo, hi in bands[1:]),
                 d_pre[:, bands[0][0]:bands[0][1]].sum(1))
        flat[:, dboff[i]:dboff[i] + dims[i]] = db
        if i == 0:
            d_hw1 = torch.cat(d_hws, 1)
            break
        hp = [cat[:, lo:hi, offs[i - 1]:offs[i]] for lo, hi in bands]
        dws = [torch.bmm(h.mT, x) for h, x in zip(hp, d_hws)]
        dw = sum(dws[1:], dws[0])
        flat[:, woff[i]:woff[i] + dims[i - 1] * dims[i]] = dw.reshape(dw.shape[0], -1)
        d_pre = torch.cat([
            (g[:, lo:hi, offs[i - 1]:offs[i]] + torch.bmm(x, ws[i - 1][sel].mT))
            * m[:, lo:hi] * (1 - h * h)
            for (lo, hi), x, h in zip(bands, d_hws, hp)], 1)
    return cat, d_hw1, flat


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("dims", [DEFAULT, (16, 8, 1)], ids=["32x32x32x1", "16x8x1"])
def test_band_decomposition_matches_plain_and_jax(dims, c):
    """T=40 at C=4: bands of 16, 16, 8 and an empty one."""
    t = 40
    adj, hw1, mask, wsel, ws, bs, g = _case(dims, t, seed=3, k=2)
    assert _bands(t, 4)[-2:] == [(32, 40), (40, 40)]
    tw, tb_ = list(map(_t, ws)), list(map(_t, bs))
    cat, d_hw1, flat = _band_emulation(dims, _t(adj), _t(hw1), _t(mask), _t(wsel),
                                       tw, tb_, _t(g), c)
    cat_p = dt.gcn_trunk_plain(dims, _t(adj), _t(hw1), _t(mask), _t(wsel), tw, tb_)
    torch.testing.assert_close(cat, cat_p, rtol=2e-4, atol=2e-5)
    want_hw1, dws_slot, dbs_slot = dt.gcn_trunk_plain_bwd(
        dims, _t(adj), _t(mask), _t(wsel), tw, cat_p, _t(g))
    want_flat = torch.cat([x.reshape(x.shape[0], -1) for x in (*dws_slot, *dbs_slot)], 1)
    torch.testing.assert_close(d_hw1, want_hw1, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(flat, want_flat, rtol=2e-4, atol=2e-5)

    ja, jm, jw = map(jnp.asarray, (adj, mask, wsel))
    _, vjp = jax.vjp(
        lambda h, w, b: gcn_trunk_fused(dims, True, ja, h, jm, jw, w, b),
        jnp.asarray(hw1), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    want = jax.tree_util.tree_leaves(vjp(jnp.asarray(g)))
    k = bs[0].shape[0]
    dws, dbs = dt._split_grads(dt._segment_sum(flat, _t(wsel), k), dims)
    got = [d_hw1] + [x.reshape(k, *x.shape[1:]) for x in (*dws, *dbs)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)


def test_ctypes_signatures_match_the_c_entries():
    """Each `extern "C"` entry of csrc/dense_trunk.cu against the argument
    types the wrapper binds: the count, and pointer or int at each place
    (a missing int would pass the stream pointer as a 32-bit int)."""
    import ctypes
    import re

    with open(dt._CU) as f:
        src = f.read()
    entries = dict(re.findall(r'extern "C" [\w\s*]+?\b(\w+)\(([^)]*)\)', src))
    assert set(entries) == set(dt._SIGNATURES)
    for name, params in entries.items():
        kinds = ["ptr" if "*" in p else "int" for p in params.split(",")]
        bound = ["int" if t is ctypes.c_int else "ptr" for t in dt._SIGNATURES[name]]
        assert kinds == bound, name
