"""The halo layout's point-to-point exchange (parallel/halo.py
`_swap_point_to_point`, the port of the reference's two `ppermute`s,
dgcnn_tpu/parallel/halo.py:45 `_exchange`) on CPU process grids of 3 and
4 `gloo` ranks (subprocesses of tests/torch_mesh_worker.py): its forward
and its backward bitwise equal to the all-reduce exchange and to the
shift they stand for, the transport `exchange_for` picks on gloo CPU
tensors, and the halo layout's log-probs, loss and gradients, now
exchanged point to point, against JAX's `make_halo_loss` on its CPU mesh
at the tolerances of tests/test_torch_halo.py."""

from functools import partial

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from dgcnn_tpu.batching import shard_pack as jsp
from dgcnn_tpu.parallel import make_mesh as jmake_mesh
from dgcnn_tpu.parallel.halo import _halo_pspecs, apply_halo as japply_halo
from dgcnn_tpu.parallel.halo import make_halo_loss as jhalo_loss
from dgcnn_tpu_torch.batching import shard_pack as sp
from dgcnn_tpu_torch.parity.convert import params_from_jax
from test_torch_halo import _gs, _jparams, _jset, _state
import torch_mesh_worker
import torch_threads  # noqa: F401  (torch on one CPU thread)

SWAP = {  # name: (mesh, H, S, F)
    "swap_1x3": ((1, 3), 5, 12, 7),
    "swap_1x4": ((1, 4), 3, 8, 97),
    "swap_2x2": ((2, 2), 4, 9, 2),
}
SPEC = dict(data="MUTAG", graphs=16, seed=3)
LOSS = {"loss_1x3": (1, 3), "loss_1x4": (1, 4)}  # name: mesh, global batch 16


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """{job name: [each rank's results]}; one grid of processes a world
    size."""
    root = tmp_path_factory.mktemp("p2p")
    jobs = {3: [], 4: []}
    for name, (mesh, h, s, f) in SWAP.items():
        jobs[mesh[0] * mesh[1]].append({"name": name, "kind": "halo_swap",
                                        "mesh": list(mesh), "h": h, "s": s, "f": f})
    for name, mesh in LOSS.items():
        path = root / f"{name}_params.npz"
        np.savez(path, **_state(SPEC))
        b = sp.halo_bucket(_gs(**SPEC), SPEC["graphs"], *mesh)
        jobs[mesh[1]].append(
            {"name": name, "kind": "halo_loss", **SPEC, "mesh": list(mesh),
             "params": str(path), "idx": list(range(SPEC["graphs"])),
             "bucket": [b.shard_nodes, b.shard_edges, b.shard_graphs, b.halo]})
    out = {}
    for world, js in jobs.items():
        results = torch_mesh_worker.spawn(tmp_path_factory.mktemp(f"world{world}"), world,
                                          js)
        for job in js:
            name = job["name"]
            out[name] = [{k[len(name) + 1:]: v for k, v in r.items()
                          if k.startswith(name + "/")} for r in results]
    return out


def _want(ranks, mesh, h):
    """Each rank's exchanged window and its input's gradient, from every
    rank's array and cotangent: the shift the exchange stands for, in the
    backward's order of additions."""
    n = mesh[1]
    out = []
    for r, res in enumerate(ranks):
        d, g = divmod(r, n)
        arr, cot = res["arr"], res["cot"]
        s = arr.shape[0]
        zeros = np.zeros((h, arr.shape[1]), np.float32)
        left = ranks[d * n + g - 1]["arr"][-h:] if g > 0 else zeros
        right = ranks[d * n + g + 1]["arr"][:h] if g < n - 1 else zeros
        grad = cot[h : h + s].copy()
        if g > 0:
            grad[:h] += ranks[d * n + g - 1]["cot"][h + s:]
        if g < n - 1:
            grad[s - h:] += ranks[d * n + g + 1]["cot"][:h]
        out.append((np.concatenate([left, arr, right]), grad))
    return out


@pytest.mark.parametrize("name", list(SWAP))
def test_point_to_point_is_the_all_reduce_exchange_bitwise(grids, name):
    mesh, h, _, _ = SWAP[name]
    ranks = grids[name]
    for r, (res, (fwd, bwd)) in enumerate(zip(ranks, _want(ranks, mesh, h))):
        assert str(res["transport"]) == "_swap_point_to_point", r
        for transport in ("p2p", "all_reduce"):
            np.testing.assert_array_equal(res[f"{transport}/fwd"], fwd,
                                          err_msg=f"rank {r} {transport} forward")
            np.testing.assert_array_equal(res[f"{transport}/bwd"], bwd,
                                          err_msg=f"rank {r} {transport} backward")


def _jax_halo(mesh):
    """JAX's log-probs in (rank, slot) order, its loss, correct count and
    gradients (as port state keys) for SPEC's 16 graphs at `mesh`."""
    gs = _gs(**SPEC)
    jm, jp = _jparams(SPEC["data"], SPEC["graphs"], SPEC["seed"])
    b = jsp.halo_bucket(_jset(gs), SPEC["graphs"], *mesh)
    batch = jsp.pack_step_halo(_jset(gs), np.arange(SPEC["graphs"]), *mesh,
                               b.shard_nodes, b.shard_edges, b.shard_graphs, b.halo)
    jmesh = jmake_mesh(mesh)

    @partial(jax.shard_map, mesh=jmesh, in_specs=(P(), _halo_pspecs(b.halo)),
             out_specs=P(("data", "graph")))
    def lp_fn(params, batch):
        local = jax.tree_util.tree_map(lambda a: a[0], batch)
        return japply_halo(params, jm, local)[None]

    lp = np.asarray(jax.jit(lp_fn)(jp, batch)).reshape(-1, gs.num_classes)
    loss_fn = jhalo_loss(jm, jmesh, b.halo, deterministic=True)
    (loss, correct), grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, batch, jax.random.PRNGKey(0)), has_aux=True))(jp)
    grads = {k: v.numpy() for k, v in
             params_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items()}
    return lp, float(loss), float(correct), grads


@pytest.mark.parametrize("name", list(LOSS))
def test_halo_exchanged_point_to_point_matches_jax(grids, name):
    ranks = grids[name]
    lp = np.concatenate([r["lp"] for r in ranks])
    mask = np.concatenate([r["graph_mask"] for r in ranks]) > 0
    want_lp, want_loss, want_correct, want_grads = _jax_halo(LOSS[name])
    np.testing.assert_allclose(lp[mask], want_lp[mask], rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), want_loss, rtol=1e-5, atol=1e-6)
        assert float(r["correct"]) == want_correct
        for k, g in want_grads.items():
            np.testing.assert_allclose(r[f"grad/{k}"], g, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {k}")
