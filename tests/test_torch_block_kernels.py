"""The port's block propagation (dgcnn_tpu_torch/kernels/block_prop.py,
block_csr.py, block_resident.py) against the JAX reference on assembled
batches with padded work items and unvisited block-rows, at F ∈ {32, 1}:
the plain forward and its autograd backward vs `block_propagate_pallas`
and `block_propagate_resident` in Pallas interpret mode (as the JAX
package's own tests run them) and the chunked XLA formulation; both
wrappers' autograd Functions on CPU tensors (which run the plain version
forward and transposed); and the wrappers' input checks. The CUDA kernels
are held against the plain version on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.block_pallas import block_propagate_pallas as j_pallas
from dgcnn_tpu.kernels.block_resident import block_propagate_resident as j_resident
from dgcnn_tpu.models.dgcnn import block_propagate_chunked as j_chunked
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import block_csr, block_prop, block_resident
import torch_threads  # noqa: F401  (torch on one CPU thread)

# fp32 on the CPU, the same products summed in another order
RTOL, ATOL = 1e-5, 1e-6
KERNELS = {  # name: (module with the launch counts, entry)
    "csr": (block_csr, block_csr.block_propagate_csr),
    "resident": (block_resident, block_resident.block_propagate_resident),
}


@functools.lru_cache(maxsize=None)
def _case(seed=0, n_graphs=24, slots=8):
    """One DD batch (two empty slots) with budget headroom, both packages."""
    gs = synthesize_tu_dataset("DD", num_graphs=n_graphs, seed=seed)
    host = tbs.build_block_graphset(gs)
    rng = np.random.default_rng(seed)
    idx = np.full(slots, -1, np.int32)
    idx[: slots - 2] = rng.permutation(n_graphs)[: slots - 2]
    nb, w = tbs.block_batch_extents(host.nb, host.block_count, idx[None])
    nb, w = nb + 5, w + 17
    batch = tbs.gather_block_batch(tbs.block_graphset_to_device(host, "cpu"),
                                   torch.from_numpy(idx), nb, w)
    assert int(batch.num_items) < w
    return host, batch, nb


def _items(batch):
    return (batch.item_pool, batch.item_row, batch.item_col, batch.item_permT,
            batch.item_colT)


def _jax_fn(name, pool, batch):
    ip, ir, ic, pT, cT = (jnp.asarray(t.numpy()) for t in _items(batch))
    pool = jnp.asarray(pool)
    if name == "pallas":
        return lambda h: j_pallas(h, pool, ip, ir, ic, pT, cT, True)
    if name == "resident":
        return lambda h: j_resident(h, pool, ip, ir, ic, pT, cT, True)
    n = jnp.asarray(batch.num_items.numpy())
    return lambda h: j_chunked(h, pool, ip, ir, ic, pT, cT, n)


@pytest.mark.parametrize("f", [32, 1])
@pytest.mark.parametrize("ref", ["pallas", "resident", "chunked"])
def test_plain_forward_and_autograd_match_jax(ref, f):
    host, batch, nb = _case()
    rng = np.random.default_rng(f)
    hb = rng.standard_normal((nb, 128, f)).astype(np.float32)
    g = rng.standard_normal((nb, 128, f)).astype(np.float32)
    want, vjp = jax.vjp(_jax_fn(ref, host.pool, batch), jnp.asarray(hb))
    want_g = vjp(jnp.asarray(g))[0]

    h = torch.from_numpy(hb).requires_grad_()
    out = block_prop.block_propagate_plain(
        h, torch.from_numpy(host.pool), batch.item_pool, batch.item_row,
        batch.item_col)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f", [32, 1])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_function_forward_and_backward_on_cpu(kernel, f):
    """The autograd Function on CPU tensors: the plain forward, and a
    backward that runs the plain version transposed over the col-major
    traversal, equal to autograd of the plain forward and to JAX; rows no
    item visits are exact zeros both ways."""
    host, batch, nb = _case(seed=1)
    rng = np.random.default_rng(10 + f)
    hb = rng.standard_normal((nb, 128, f)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((nb, 128, f)).astype(np.float32))
    pool = torch.from_numpy(host.pool)
    mod, entry = KERNELS[kernel]

    h = torch.from_numpy(hb).requires_grad_()
    out = entry(h, pool, *_items(batch), batch.num_items)
    out.backward(g)
    h2 = torch.from_numpy(hb).requires_grad_()
    ref = block_prop.block_propagate_plain(h2, pool, batch.item_pool,
                                           batch.item_row, batch.item_col)
    ref.backward(g)
    torch.testing.assert_close(out.detach(), ref.detach(), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(h.grad, h2.grad, rtol=RTOL, atol=ATOL)
    want, vjp = jax.vjp(_jax_fn("pallas", host.pool, batch), jnp.asarray(hb))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(vjp(jnp.asarray(g.numpy()))[0]),
                               rtol=RTOL, atol=ATOL)

    rp = block_prop.row_ptr(batch.item_row, nb)
    rpT = block_prop.row_ptr(batch.item_colT, nb)
    dead, deadT = rp[1:] == rp[:-1], rpT[1:] == rpT[:-1]
    assert dead.any() and deadT.any()
    assert (out.detach()[dead] == 0).all() and (h.grad[deadT] == 0).all()
    assert mod.launches.fwd_launches == 0 and mod.launches.bwd_launches == 0


def test_pallas_alias_and_helpers():
    assert block_csr.block_propagate_pallas is block_csr.block_propagate_csr
    seg = torch.tensor([0, 0, 2, 2, 2, 5, 7, 7], dtype=torch.int32)  # 7 = padding
    rp = block_prop.row_ptr(seg, 6)
    assert rp.dtype == torch.int32
    assert rp.tolist() == [0, 2, 2, 5, 5, 5, 6]
    ip = torch.arange(8, dtype=torch.int32) * 10
    perm = torch.tensor([1, 0, 2, 4, 3, 5, 6, 7], dtype=torch.int32)
    ipT, rT = block_prop.transposed_items(ip, seg, perm, 6)
    assert ipT.tolist() == [10, 0, 20, 40, 20 + 10, 50, 60, 70]
    assert rT.tolist() == [0, 0, 2, 2, 2, 5, 5, 5]  # padding clamped to nb-1


def _good():
    host, batch, nb = _case()
    hb = torch.zeros((nb, 128, 4))
    return [hb, torch.from_numpy(host.pool), *_items(batch), batch.num_items]


def _bad_cases():
    def with_(i, fn):
        def make():
            args = _good()
            args[i] = fn(args[i])
            return args
        return make

    return {
        "hb_2d": (with_(0, lambda t: t.reshape(-1, 4)), ValueError),
        "hb_bs": (with_(0, lambda t: t[:, :64].contiguous()), ValueError),
        "hb_wide": (with_(0, lambda t: torch.zeros(t.shape[0], 128, 129)), ValueError),
        "hb_f64": (with_(0, lambda t: t.double()), TypeError),
        "hb_noncontig": (with_(0, lambda t: torch.zeros(t.shape[0], 128, 8)[..., ::2]),
                         ValueError),
        "pool_shape": (with_(1, lambda t: t[:, :, :64].contiguous()), ValueError),
        "pool_bf16": (with_(1, lambda t: t.bfloat16()), TypeError),
        "items_i64": (with_(2, lambda t: t.long()), TypeError),
        "items_len": (with_(3, lambda t: t[:-1]), ValueError),
        "items_noncontig": (with_(4, lambda t: torch.stack([t, t], 1)[:, 0]), ValueError),
        "num_items_shape": (with_(7, lambda t: torch.zeros(2, dtype=torch.int32)),
                            ValueError),
        "device_meta": (lambda: [a.to("meta") for a in _good()], ValueError),
        "device_mixed": (with_(1, lambda t: t.to("meta")), ValueError),
    }


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("case", list(_bad_cases()))
def test_wrapper_rejects_bad_inputs(kernel, case):
    make, exc = _bad_cases()[case]
    with pytest.raises(exc):
        KERNELS[kernel][1](*make())
