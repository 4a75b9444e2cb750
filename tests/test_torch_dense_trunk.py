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
    (lambda a: a.__setitem__(1, a[1].to(torch.bfloat16)), NotImplementedError),
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
