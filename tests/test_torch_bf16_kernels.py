"""The bf16 modes of the port's three dense and block kernels, through their
plain PyTorch versions on the CPU (the CUDA kernels are held against these
on the card by chip_smoke.py phases 3a and 3b):

  * the block propagation at a bf16 pool and bf16 hb against JAX's
    `block_propagate_pallas` and `block_propagate_resident` in Pallas
    interpret mode, forward and gradient, within rtol 1e-5: both multiply
    the same bf16 values exactly and sum in fp32, only the order of the
    sums differs (the gradient comes back in bf16 in both, each rounded
    from such a sum);
  * the trunk at a bf16 adjacency against `gcn_trunk_fused` in interpret
    mode, forward and the written-out backward, within the reference's own
    bf16 tolerance for that kernel, rtol/atol 5e-3 (tests/
    test_dense_trunk.py:78: sums in another order can move a value across
    a bf16 rounding boundary, one ulp, and the later layers carry it);
  * what the wrappers refuse, the plan's shared-memory bytes at 2 bytes an
    adjacency element (the resident cap rises), and the bounds at 2 bytes
    an element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense_trunk import _case, _t

from dgcnn_tpu.batching import block_sparse as jbs
from dgcnn_tpu.kernels.block_pallas import block_propagate_pallas
from dgcnn_tpu.kernels.block_resident import block_propagate_resident as jax_resident
from dgcnn_tpu.kernels.dense_trunk import gcn_trunk_fused
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import block_csr, block_resident
from dgcnn_tpu_torch.kernels import dense_trunk as dt
from dgcnn_tpu_torch.kernels.block_prop import block_propagate_plain
from dgcnn_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (torch on one CPU thread)

BF16 = torch.bfloat16
ENTRIES = {"pallas": (block_propagate_pallas, block_csr.block_propagate_csr),
           "resident": (jax_resident, block_resident.block_propagate_resident)}


def _block_case(name, n_graphs, idx, f, seed):
    """One batch of `name` graphs in both packages (budgets with headroom:
    padded items and unvisited block-rows), the pool in bf16 in both, and
    hb [nb, 128, f] and a cotangent from a seed."""
    gs = synthesize_tu_dataset(name, num_graphs=n_graphs, seed=seed)
    host = tbs.build_block_graphset(gs)
    tset = tbs.block_graphset_to_device(host, "cpu", "bfloat16")
    jset = jax.tree_util.tree_map(jnp.asarray, jbs.build_block_graphset(gs))
    idx = np.asarray(idx, np.int32)
    nb, w = tbs.block_batch_extents(host.nb, host.block_count, idx[None])
    nb, w = nb + 3, w + 11
    jb = jbs.gather_block_batch(jset, jnp.asarray(idx), nb, w)
    tb = tbs.gather_block_batch(tset, torch.from_numpy(idx), nb, w)
    rng = np.random.default_rng(seed)
    hb = rng.standard_normal((nb, 128, f)).astype(np.float32)
    cot = rng.standard_normal((nb, 128, f)).astype(np.float32)
    return jset.pool.astype(jnp.bfloat16), jb, tset.pool, tb, hb, cot


@pytest.mark.parametrize("kernel", list(ENTRIES))
@pytest.mark.parametrize("name,n_graphs,idx,f", [
    ("DD", 16, [0, 3, -1, 5, 8], 32),
    ("MUTAG", 24, [1, 2, 4, 7, 9, -1, 11, 13], 1),
], ids=["DD-F32", "MUTAG-F1"])
def test_block_bf16_matches_jax_interpret(kernel, name, n_graphs, idx, f):
    """The port's entry (its plain version on the CPU) at a bf16 pool and
    bf16 hb against the JAX kernel in interpret mode: the fp32 output, and
    the gradient of ⟨out, cot⟩ with respect to hb taken in fp32 through the
    bf16 cast (the cotangent rounds to bf16, d_hb comes back in bf16)."""
    jpool, jb, pool, tb, hb, cot = _block_case(name, n_graphs, idx, f, seed=4)
    assert pool.dtype == BF16
    np.testing.assert_array_equal(pool.view(torch.int16).numpy(),
                                  np.asarray(jpool).view(np.int16))
    jfn, tfn = ENTRIES[kernel]
    jitems = (jb.item_pool, jb.item_row, jb.item_col, jb.item_permT, jb.item_colT)
    titems = (tb.item_pool, tb.item_row, tb.item_col, tb.item_permT, tb.item_colT)

    def jloss(h):
        out = jfn(h.astype(jnp.bfloat16), jpool, *jitems, True)
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hb))
    x = torch.from_numpy(hb).requires_grad_()
    out = tfn(x.to(BF16), pool, *titems, tb.num_items)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_block_bf16_autograd_is_the_rounded_transposed_product():
    """The entry's backward takes the cotangent in bf16 and returns d_hb in
    bf16: exactly the plain transposed product of the rounded cotangent,
    rounded."""
    _, _, pool, tb, hb, cot = _block_case("DD", 16, [2, 4, 6, -1], 8, seed=2)
    plan = block_csr.make_plan(tb.item_pool, tb.item_row, tb.item_col, tb.item_permT,
                               tb.item_colT, hb.shape[0])
    x = torch.from_numpy(hb).to(BF16).requires_grad_()
    out = block_csr.block_propagate_csr(x, pool, tb.item_pool, tb.item_row, tb.item_col,
                                        tb.item_permT, tb.item_colT, tb.num_items, plan)
    out.backward(torch.from_numpy(cot))
    want = block_propagate_plain(torch.from_numpy(cot).to(BF16), pool, plan.bwd.ip,
                                 plan.bwd.seg, plan.bwd.src, transpose=True)
    assert x.grad.dtype == BF16
    assert torch.equal(x.grad, want.to(BF16))


@pytest.mark.parametrize("mix", ["pool32-hb16", "pool16-hb32"])
def test_block_wrapper_refuses_mixed_dtypes(mix):
    _, _, pool, tb, hb, _ = _block_case("DD", 16, [2, 4], 8, seed=2)
    h = torch.from_numpy(hb)
    args = (h.to(BF16), pool.float()) if mix == "pool32-hb16" else (h, pool)
    for fn in (block_csr.block_propagate_csr, block_resident.block_propagate_resident):
        with pytest.raises(TypeError, match="share a dtype"):
            fn(*args, tb.item_pool, tb.item_row, tb.item_col, tb.item_permT,
               tb.item_colT, tb.num_items)


@pytest.mark.parametrize("t,dims", [(8, (32, 32, 32, 1)), (40, (32, 32, 32, 1)),
                                    (40, (16, 8, 1))], ids=["T8", "T40", "T40-16x8x1"])
def test_trunk_bf16_adjacency_matches_jax_fused_interpret(t, dims):
    """Forward and the written-out backward (through `GcnTrunkFn` on CPU
    tensors) against `gcn_trunk_fused` in interpret mode on a bf16
    adjacency, within rtol/atol 5e-3."""
    adj, hw1, mask, wsel, ws, bs, g = _case(dims, t, seed=5)
    ja16 = jnp.asarray(adj).astype(jnp.bfloat16)
    jm, jw = jnp.asarray(mask), jnp.asarray(wsel)
    want_cat, vjp = jax.vjp(
        lambda h, w, b: gcn_trunk_fused(dims, True, ja16, h, jm, jw, w, b),
        jnp.asarray(hw1), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    want = jax.tree_util.tree_leaves(vjp(jnp.asarray(g)))
    adj16 = _t(adj).to(BF16)
    np.testing.assert_array_equal(adj16.view(torch.int16).numpy(),
                                  np.asarray(ja16).view(np.int16))
    leaves = [_t(hw1), *map(_t, ws), *map(_t, bs)]
    xs = [x.clone().requires_grad_() for x in leaves]
    n = len(dims)
    cat = dt.gcn_trunk(dims, adj16, xs[0], _t(mask), _t(wsel), xs[1:n], xs[n:])
    np.testing.assert_allclose(cat.detach().numpy(), np.asarray(want_cat), rtol=5e-3,
                               atol=5e-3)
    got = torch.autograd.grad(cat, xs, _t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3, atol=5e-3)


def test_trunk_round_h_rounds_every_layer_output():
    """`round_h` (bf16 compute): every cat value is a bf16 value, the plain
    chain equals the fp32 chain with hw and h rounded where the reference's
    bf16 einsum chain rounds them, and it needs a bf16 adjacency."""
    dims = (16, 8, 1)
    adj, hw1, mask, wsel, ws, bs, _ = _case(dims, 24, seed=7)
    args = (_t(hw1), _t(mask), _t(wsel), [dt.round_bf16(_t(w)) for w in ws],
            list(map(_t, bs)))
    cat = dt.gcn_trunk(dims, _t(adj).to(BF16), *args, round_h=True)
    assert torch.equal(cat, dt.round_bf16(cat))
    a = _t(adj).to(BF16).float()
    hw, outs, sel = _t(hw1), [], _t(wsel).long()
    for i in range(len(dims)):
        h = torch.tanh(torch.bmm(a, dt.round_bf16(hw)) + args[4][i][sel][:, None, :])
        h = dt.round_bf16(h * _t(mask)[..., None])
        outs.append(h)
        if i + 1 < len(dims):
            hw = torch.bmm(h, args[3][i][sel])
    assert torch.equal(cat, torch.cat(outs, -1))
    with pytest.raises(ValueError, match="bf16 adjacency"):
        dt.gcn_trunk(dims, _t(adj), *args, round_h=True)


def test_trunk_plan_at_two_bytes_an_element():
    """The bf16 plan's shared memory is the fp32 plan's less half the
    adjacency band (16 bytes of row padding either way); the resident cap
    at dims (32, 32, 32, 1) and S = 56 rises from 320 to 392, and
    COLLAB's T = 464 class stays streamed; T = 256 fits C = 2 in bf16
    where fp32 needed C = 4."""
    dims = (32, 32, 32, 1)
    for t, c in ((88, 2), (176, 2), (256, 4)):
        f32, b16 = dt.resident_smem(t, c, dims), dt.resident_smem(t, c, dims, es=2)
        tb = dt.band_rows(t, c)
        half = tb * (-(-t // 32) * 32) * 2
        assert (f32[0] - b16[0], f32[1] - b16[1]) == (half, half)

    def cap(es):
        t = 8
        while dt.trunk_plan(56, t + 8, dims, es=es).regime == "resident":
            t += 8
        return t

    assert (cap(4), cap(2)) == (320, 392)
    assert dt.trunk_plan(56, 464, dims, es=2).regime == "streamed"
    assert dt.trunk_plan(56, 256, dims).c == 4 and dt.trunk_plan(56, 256, dims, es=2).c == 2
    s32, s16 = dt.trunk_plan(56, 624, dims), dt.trunk_plan(56, 624, dims, es=2)
    assert s16.regime == "streamed" and s16.fwd_smem < s32.fwd_smem


def test_bounds_at_two_bytes_an_element():
    """The fp32 bounds are the formulas chip_smoke printed before (each
    input read once, each output written once, fp32 peak); at 2 bytes an
    element the adjacency or pool bytes halve and their products count at
    the bf16 peak."""
    s, t, k, dims = 560, 88, 10, (32, 32, 32, 1)
    sd, pairs = sum(dims), 32 * 32 * 2 + 32
    fwd_bytes = 4 * (s * t * t + s * t * 32 + s * t + s * t * sd) + 4 * k * (pairs + sd) + 4 * s
    (fwd, by), _ = profiling.trunk_bounds(s, t, k, dims)
    assert fwd == pytest.approx(max(fwd_bytes / 3.35e12, (2 * s * t * t * sd + 2 * s * t * pairs)
                                    / 67e12) * 1e3)
    (fwd16, _), (bwd16, by16) = profiling.trunk_bounds(s, t, k, dims, es=2)
    assert fwd16 < fwd and by16 in ("bytes", "operations")
    n, nb, f = 575, 200, 32
    b32, by32 = profiling.block_bounds(n, nb, f)
    b16, by16 = profiling.block_bounds(n, nb, f, es=2)
    assert by32 == by16 == "bytes"
    assert b32 * 3.35e12 / 1e3 == pytest.approx(n * (128 * 128 * 4 + 128 * f * 4) + nb * 128 * f * 4)
    assert b16 * 3.35e12 / 1e3 == pytest.approx(n * (128 * 128 * 2 + 128 * f * 2) + nb * 128 * f * 4)
