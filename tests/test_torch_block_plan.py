"""The block kernels' per-batch plans (dgcnn_tpu_torch/kernels/block_prop.py
`plan_pieces` for the CSR kernel, `plan_groups` for the item-parallel
kernel) and the summation order the CUDA kernels take over them.

- Each table's invariants, both directions, on assembled DD batches
  (padded items, unvisited rows) and on edge cases: no real item, every
  item in one row (a run far longer than a piece), runs of exactly P and
  P + 1 items.
- A plain emulation of each kernel's order (per piece the items in item
  order, then a split row's partials in piece order; per group a
  register sum per row segment, then each row's segments in group order)
  against `block_propagate_pallas` and `block_propagate_resident` of the
  JAX package in Pallas interpret mode, forward and transposed (through
  the reference's VJP), F ∈ {32, 1}, rtol 1e-5 and atol 1e-6 (fp32, the
  same products summed in another order).
- Each `extern "C"` entry of csrc/block_csr.cu and block_resident.cu
  against the argument types its wrapper binds.
- models/dgcnn.py apply_block builds one plan per batch for a forward and
  a backward, and no propagation builds its own.

The CUDA kernels are held against the plain version on the card by
chip_smoke.py phase 3b."""

import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgcnn_tpu.kernels.block_pallas import block_propagate_pallas as j_pallas
from dgcnn_tpu.kernels.block_resident import block_propagate_resident as j_resident
from dgcnn_tpu_torch.batching import block_sparse as tbs
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.kernels import block_csr, block_prop, block_resident

RTOL, ATOL = 1e-5, 1e-6
BS = 128


@functools.lru_cache(maxsize=None)
def _dd(seed=0, n_graphs=24, slots=8):
    """One DD batch (two empty slots) with budget headroom: padded items
    and unvisited rows (W a multiple of 8, as the reference's item-parallel
    kernel needs)."""
    gs = synthesize_tu_dataset("DD", num_graphs=n_graphs, seed=seed)
    host = tbs.build_block_graphset(gs)
    rng = np.random.default_rng(seed)
    idx = np.full(slots, -1, np.int32)
    idx[: slots - 2] = rng.permutation(n_graphs)[: slots - 2]
    nb, w = tbs.block_batch_extents(host.nb, host.block_count, idx[None])
    nb, w = nb + 5, (w + 17 + 7) // 8 * 8
    batch = tbs.gather_block_batch(tbs.block_graphset_to_device(host, "cpu"),
                                   torch.from_numpy(idx), nb, w)
    items = (batch.item_pool, batch.item_row, batch.item_col, batch.item_permT,
             batch.item_colT)
    return torch.from_numpy(host.pool), items, batch.num_items, nb


def _made(rows, cols, nb, w, seed=0):
    """A batch of len(rows) real items at (row, col) (rows
    non-decreasing), blocks drawn from the DD pool, padded to w items."""
    pool, *_ = _dd()
    n = len(rows)
    rng = np.random.default_rng(seed)
    sentinel = pool.shape[0] - 1
    ip = np.full(w, sentinel, np.int32)
    ip[:n] = rng.integers(0, sentinel, n)
    row = np.full(w, nb, np.int32)
    row[:n] = rows
    col = np.zeros(w, np.int32)
    col[:n] = cols
    perm = np.arange(w, dtype=np.int32)
    perm[:n] = np.lexsort((row[:n], col[:n]))  # col-major: by col, then row
    colT = np.full(w, nb, np.int32)
    colT[:n] = col[perm[:n]]
    items = tuple(torch.from_numpy(a) for a in (ip, row, col, perm, colT))
    return pool, items, torch.tensor(n, dtype=torch.int32), nb


P = 4


def _cases():
    """name → (pool, items, num_items, nb)."""
    run = 9 * P + 3  # one row, a run far longer than a piece
    return {
        "dd": lambda: _dd(),
        "dd_seed1": lambda: _dd(seed=1),
        "no_items": lambda: _made([], [], 6, 16),
        "one_row": lambda: _made([0] * run, [i % 5 for i in range(run)], 5, 48),
        "runs_p_and_p1": lambda: _made([0] * P + [1] * (P + 1) + [3],
                                       [0, 1, 2, 3, 0, 1, 2, 3, 4, 3], 6, 16),
    }


def _row_ptr(seg, nb):
    return block_prop.row_ptr(seg, nb).tolist()


def _pieces(d, nb, p, budget):
    """Each grid block's piece as csrc/block_csr.cu find_piece derives it:
    (row, first item, end item), row -1 past the real pieces."""
    rp, ptr = d.row_ptr.tolist(), d.piece_ptr.tolist()
    out = []
    for q in range(budget):
        if q >= ptr[nb]:
            out.append((-1, 0, 0))
            continue
        r = [r for r in range(nb) if ptr[r] <= q < ptr[r + 1]]
        assert len(r) == 1  # exactly one row holds each real piece
        first = rp[r[0]] + (q - ptr[r[0]]) * p
        out.append((r[0], first, min(first + p, rp[r[0] + 1])))
    return [list(c) for c in zip(*out)]


def _check_pieces(d, nb, w, p):
    rows, firsts, ends = _pieces(d, nb, p, -(-w // p) + nb)
    ptr = d.piece_ptr.tolist()
    rp = _row_ptr(d.seg, nb)
    assert d.row_ptr.tolist() == rp
    total = ptr[nb]
    assert total <= len(rows) and all(r == -1 for r in rows[total:])
    covered = []
    for r in range(nb):
        mine = range(ptr[r], ptr[r + 1])
        length = rp[r + 1] - rp[r]
        assert len(mine) == max(1, -(-length // p))
        assert (len(mine) > 1) == (length > p)  # split rows, by their range
        for q in mine:
            assert rows[q] == r  # no piece crosses a row
            assert 0 <= ends[q] - firsts[q] <= p
            assert rp[r] <= firsts[q] and ends[q] <= rp[r + 1]
            assert (ends[q] > firsts[q]) or length == 0
            covered.extend(range(firsts[q], ends[q]))
    assert covered == list(range(rp[nb]))  # every real item once, in order


@pytest.mark.parametrize("p", [1, 2, P, 6])
@pytest.mark.parametrize("case", list(_cases()))
def test_piece_table_covers_every_item_once_within_rows(case, p):
    pool, items, n, nb = _cases()[case]()
    plan = block_prop.plan_pieces(*items, nb, p)
    w = items[0].shape[0]
    assert (plan.kind, plan.size, plan.nb, plan.w) == ("pieces", p, nb, w)
    for d in (plan.fwd, plan.bwd):
        _check_pieces(d, nb, w, p)
        assert _row_ptr(d.seg, nb)[nb] == int(n)


def _group_slots(d, g, n):
    """The scratch slot of each real item's row segment, as
    csrc/block_resident.cu numbers them: the segment's first item."""
    seg = d.seg.tolist()
    slot_of = []
    for first in range(0, n, g):
        slot = first
        for k in range(first, min(first + g, n)):
            if k > first and seg[k] != seg[k - 1]:
                slot = k
            slot_of.append(slot)
    return slot_of


def _row_slots(rp, r, g):
    """Row r's partial slots in the order the row pass adds them."""
    start, end = rp[r], rp[r + 1]
    if start == end:
        return []
    return [start] + list(range((start // g + 1) * g, end, g))


def _check_groups(d, nb, w, g, n):
    seg = d.seg.tolist()
    rp = _row_ptr(d.seg, nb)
    assert d.row_ptr.tolist() == rp and d.piece_ptr is None
    slot_of = _group_slots(d, g, n)
    assert slot_of == sorted(slot_of)
    assert len(set(slot_of)) <= -(-w // g) + nb
    for r in range(nb):  # the row pass finds exactly the row's segments
        want = sorted({slot_of[k] for k in range(rp[r], rp[r + 1])})
        assert _row_slots(rp, r, g) == want
    for k in range(n):  # a segment stays in one row and one group
        assert seg[slot_of[k]] == seg[k] and slot_of[k] // g == k // g


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("case", list(_cases()))
def test_group_segments_stay_in_one_row_and_group(case, g):
    pool, items, n, nb = _cases()[case]()
    plan = block_prop.plan_groups(*items, nb, g)
    w = items[0].shape[0]
    assert (plan.kind, plan.size, plan.parts) == ("groups", g, w)
    for d in (plan.fwd, plan.bwd):
        _check_groups(d, nb, w, g, int(n))


def _product(pool, hb, d, k, transpose):
    a = pool[int(d.ip[k])]
    return (a.T if transpose else a) @ hb[int(d.src[k])]


def emulate_pieces(hb, pool, plan, transpose):
    """block_csr.cu's order: each piece sums its items in item order; a
    row of one piece is that sum, a split row its pieces' partials added
    left to right."""
    d = plan.bwd if transpose else plan.fwd
    nb, bs, f = hb.shape
    rows, firsts, ends = _pieces(d, nb, plan.size, plan.parts)
    ptr = d.piece_ptr.tolist()
    parts = []
    for q in range(ptr[nb]):
        acc = torch.zeros(bs, f)
        for k in range(firsts[q], ends[q]):
            acc = acc + _product(pool, hb, d, k, transpose)
        parts.append(acc)
    out = torch.zeros(nb, bs, f)
    for r in range(nb):
        s = parts[ptr[r]]
        for j in range(ptr[r] + 1, ptr[r + 1]):
            s = s + parts[j]
        out[r] = s
    return out


def emulate_groups(hb, pool, plan, n, transpose):
    """block_resident.cu's order: each group sums consecutive items of a
    row in registers and writes one partial per row segment, in the slot
    of the segment's first item; each row adds its segments in group
    order (zeros when it has none)."""
    d = plan.bwd if transpose else plan.fwd
    nb, bs, f = hb.shape
    parts = {}
    for k, slot in enumerate(_group_slots(d, plan.size, n)):
        parts[slot] = parts.get(slot, torch.zeros(bs, f)) + _product(
            pool, hb, d, k, transpose)
    rp = d.row_ptr.tolist()
    out = torch.zeros(nb, bs, f)
    for r in range(nb):
        slots = _row_slots(rp, r, plan.size)
        if slots:
            s = parts[slots[0]]
            for j in slots[1:]:
                s = s + parts[j]
            out[r] = s
    return out


@pytest.mark.parametrize("f", [32, 1])
@pytest.mark.parametrize("kernel", ["csr", "resident"])
@pytest.mark.parametrize("case", ["dd", "no_items", "one_row", "runs_p_and_p1"])
def test_kernel_order_matches_jax_forward_and_transposed(case, kernel, f):
    pool, items, n, nb = _cases()[case]()
    rng = np.random.default_rng(f)
    hb = rng.standard_normal((nb, BS, f)).astype(np.float32)
    g = rng.standard_normal((nb, BS, f)).astype(np.float32)
    jitems = [jnp.asarray(t.numpy()) for t in items]
    jfn = j_pallas if kernel == "csr" else j_resident
    want, vjp = jax.vjp(lambda h: jfn(h, jnp.asarray(pool.numpy()), *jitems, True),
                        jnp.asarray(hb))
    want_t = vjp(jnp.asarray(g))[0]
    if kernel == "csr":
        plan = block_prop.plan_pieces(*items, nb, P)
        got = emulate_pieces(torch.from_numpy(hb), pool, plan, False)
        got_t = emulate_pieces(torch.from_numpy(g), pool, plan, True)
    else:
        plan = block_prop.plan_groups(*items, nb, 2)
        got = emulate_groups(torch.from_numpy(hb), pool, plan, int(n), False)
        got_t = emulate_groups(torch.from_numpy(g), pool, plan, int(n), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)
    if case == "no_items":
        assert not got.any() and not got_t.any()


@pytest.mark.parametrize("mod", [block_csr, block_resident], ids=["csr", "resident"])
def test_ctypes_signatures_match_the_c_entries(mod):
    """Each `extern "C"` entry of the kernel's source against the argument
    types the wrapper binds: the count, and pointer or int at each place
    (a missing int would pass the stream pointer as a 32-bit int)."""
    with open(mod._CU) as f:
        src = f.read()
    entries = dict(re.findall(r'extern "C" [\w\s*]+?\b(\w+)\(([^)]*)\)', src))
    assert set(entries) == set(mod._SIGNATURES)
    for name, params in entries.items():
        kinds = ["ptr" if "*" in p else "int" for p in params.split(",")]
        bound = ["int" if t is ctypes.c_int else "ptr" for t in mod._SIGNATURES[name]]
        assert kinds == bound, name


@pytest.mark.parametrize("entry,make_plan", [
    (block_csr.block_propagate_csr, block_csr.make_plan),
    (block_resident.block_propagate_resident, block_resident.make_plan),
], ids=["csr", "resident"])
def test_entry_takes_the_batch_plan_and_refuses_a_foreign_one(entry, make_plan):
    pool, items, n, nb = _dd()
    hb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (nb, BS, 8)).astype(np.float32))
    plan = make_plan(*items, nb)
    torch.testing.assert_close(entry(hb, pool, *items, n, plan),
                               entry(hb, pool, *items, n), rtol=0, atol=0)
    other = (block_resident if make_plan is block_csr.make_plan else block_csr).make_plan
    with pytest.raises(ValueError):
        entry(hb, pool, *items, n, other(*items, nb))
    with pytest.raises(ValueError):  # built for another row budget
        entry(hb[:-1].contiguous(), pool, *items, n, plan)


@pytest.mark.parametrize("impl,planner", [("pallas", "plan_pieces"),
                                          ("xla", "plan_groups")])
def test_apply_block_plans_once_per_batch(monkeypatch, impl, planner):
    """One forward and backward of the model: one plan, and no transposed
    item lists or row pointers built by the propagations themselves."""
    from dgcnn_tpu_torch.models.dgcnn import DGCNN, DGCNNNet, init_params
    from dgcnn_tpu_torch.train.loop import train_step, make_optimizer

    gs = synthesize_tu_dataset("DD", num_graphs=12, seed=3)
    host = tbs.build_block_graphset(gs)
    idx = np.arange(8, dtype=np.int32)
    nb, w = tbs.block_batch_extents(host.nb, host.block_count, idx[None])
    dev = tbs.block_graphset_to_device(host, "cpu")
    batch = tbs.gather_block_batch(dev, torch.from_numpy(idx), nb + 2, w + 8)
    model = DGCNN(num_features=gs.num_features, num_classes=gs.num_classes)
    net = DGCNNNet(model, init_params(torch.Generator().manual_seed(0), model, "cpu"))

    calls = {planner: 0, "transposed_items": 0, "row_ptr": 0}

    def counted(name):
        fn = getattr(block_prop, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(block_prop, name, wrapped)

    for name in calls:
        counted(name)
    train_step(net, make_optimizer(net), batch, torch.Generator().manual_seed(0),
               pool=dev.pool, block_impl=impl)
    assert calls == {planner: 1, "transposed_items": 1, "row_ptr": 0}
