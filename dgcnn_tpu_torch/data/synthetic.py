"""Synthetic profile datasets — offline stand-ins for the eight TU
benchmarks.

The build environment has no network egress, so the real TU-Dortmund
downloads (reference README.md:24-27) are unavailable; these generators
produce datasets with the same *shape contract* as each benchmark —
graph/class counts, feature decomposition (attrs ‖ one-hot labels ‖ degree,
SURVEY §2d), node-count and edge-density statistics — so every code path
(packing, kernels, CV driver, bench) exercises realistic shapes. A planted
class signal makes them learnable, so training tests can assert accuracy:
class-dependent edge density, node-label histogram, and attr shift — plus,
for the degree-only datasets (COLLAB/IMDB, where per-graph degree
normalization + top-k SortPooling erase most distributional signals),
class-dependent degree assortativity and graph size (_sample_two_block).

Features are assembled through the same `assemble_features` as the real
parser, so parser↔synthetic round-trips are bit-exact (tests/test_data.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.data.tu_parser import assemble_features

# bump whenever generated output changes — the synthetic npz cache filename
# embeds it, so stale caches from an older generator never get loaded
SYNTHETIC_VERSION = 4

# Shape statistics of the eight reference benchmarks (graph/class counts:
# reference README.md:62-83; feature decomposition: README.md:84-94 and
# SURVEY §2d; node/edge averages are the published TU collection stats).
# avg_degree = 2 * avg_undirected_edges / avg_nodes.
PROFILES = {
    "MUTAG": dict(num_graphs=188, num_classes=2, num_attrs=0,
                  num_node_labels=7, avg_nodes=17.93, max_nodes=28,
                  avg_degree=2.21, sigma=0.20),
    "PTC_MR": dict(num_graphs=344, num_classes=2, num_attrs=0,
                   num_node_labels=18, avg_nodes=14.29, max_nodes=64,
                   avg_degree=2.06, sigma=0.35),
    "NCI1": dict(num_graphs=4110, num_classes=2, num_attrs=0,
                 num_node_labels=37, avg_nodes=29.87, max_nodes=111,
                 avg_degree=2.16, sigma=0.30),
    "PROTEINS": dict(num_graphs=1113, num_classes=2, num_attrs=1,
                     num_node_labels=3, avg_nodes=39.06, max_nodes=620,
                     avg_degree=3.73, sigma=0.55),
    "DD": dict(num_graphs=1178, num_classes=2, num_attrs=0,
               num_node_labels=89, avg_nodes=284.32, max_nodes=5748,
               avg_degree=5.03, sigma=0.80),
    # COLLAB default = the measured optimum of the generator-v4 sweep
    # (2026-08-20, tools/probe_collab_signal.py + inline follow-ups,
    # 3-fold × 40-epoch on-chip): two-block (assort 0.7, size_shift 0.2)
    # → 69.6%; EVERY added lever lowered it — the union-of-cliques
    # ego-network family (`family="cliques"`, the REAL COLLAB generative
    # process: class sets mean clique size clique_frac·clique_sep^±1)
    # measured 54.0-59.1% across (frac, sep) ∈ {.25,.35,.45}×{2,3};
    # degree-tail separation (ratio_sep 1.2/1.5/2.0) 59.7-66.6%;
    # assort/size neighbors (0.6-0.8 × 0.2-0.25) 61.5-65.2%. At COLLAB's
    # ~90% mean edge density, local clique structure does NOT transport
    # through degree-only features + per-graph normalization + top-k
    # pooling in this synthetic regime — a MEASURED ceiling now, not an
    # asserted one. The levers stay profile-tunable for re-sweeps.
    "COLLAB": dict(num_graphs=5000, num_classes=3, num_attrs=0,
                   num_node_labels=0, avg_nodes=74.49, max_nodes=492,
                   avg_degree=65.97, sigma=0.50),
    "IMDB-BINARY": dict(num_graphs=1000, num_classes=2, num_attrs=0,
                        num_node_labels=0, avg_nodes=19.77, max_nodes=136,
                        avg_degree=9.76, sigma=0.40),
    "IMDB-MULTI": dict(num_graphs=1500, num_classes=3, num_attrs=0,
                       num_node_labels=0, avg_nodes=13.00, max_nodes=89,
                       avg_degree=10.14, sigma=0.35),
}


def _sample_undirected_edges(rng: np.random.Generator, n: int, m: int):
    """`m` distinct undirected pairs over `n` nodes, no self-loops; sparse
    graphs get a Hamiltonian-path backbone (degree ≥ 1 everywhere), dense
    ones sample pair indices without replacement."""
    complete = n * (n - 1) // 2
    m = int(np.clip(m, 1, complete))
    if m > complete // 4:
        iu, iv = np.triu_indices(n, 1)
        sel = rng.choice(complete, size=m, replace=False)
        return iu[sel].astype(np.int32), iv[sel].astype(np.int32)

    chain_u = np.arange(n - 1, dtype=np.int64)
    chain_codes = chain_u * n + (chain_u + 1)
    extra = m - (n - 1)
    if extra <= 0:
        u, v = chain_u[:m], (chain_u + 1)[:m]
        return u.astype(np.int32), v.astype(np.int32)
    cand_a = rng.integers(0, n, size=4 * extra + 16)
    cand_b = rng.integers(0, n, size=4 * extra + 16)
    keep = cand_a != cand_b
    lo = np.minimum(cand_a[keep], cand_b[keep])
    hi = np.maximum(cand_a[keep], cand_b[keep])
    codes = np.setdiff1d(lo * n + hi, chain_codes)  # unique + not in chain
    codes = rng.permutation(codes)[:extra]  # unbiased truncation
    u = np.concatenate([chain_u, codes // n])
    v = np.concatenate([chain_u + 1, codes % n])
    return u.astype(np.int32), v.astype(np.int32)


def _sample_two_block(rng: np.random.Generator, n: int, target_m: int,
                      t: float, rho: float = 0.3, ratio: float = 4.0):
    """Degree-heterogeneous two-block Bernoulli graph with tunable
    assortativity `t`: a random `rho`-fraction core carries `ratio`× the
    Chung-Lu weight of the periphery, and same-block pairs are further
    scaled by (1+t), cross-block by (1-t). The edge-probability scale is
    bisected so E[#edges] == target_m.

    Why this signal for the degree-only datasets (COLLAB/IMDB): the only
    node feature is the per-graph max-normalized degree (reference
    utils.py:22-23), and SortPooling keeps only the TOP-k nodes of the
    learned (degree-correlated) sort order — so the class signal must be
    visible in the 1-hop neighborhoods of the HIGHEST-degree nodes. A
    density shift is normalized away; a low-degree tail is truncated by
    top-k. Assortativity is exactly what one GCN layer reads there: in an
    assortative graph (t>0) high-degree nodes aggregate high-degree
    neighbors, in a disassortative one (t<0) they aggregate low-degree
    neighbors. A Hamiltonian-path backbone keeps degree ≥ 1."""
    iu, iv = np.triu_indices(n, 1)
    core = np.zeros(n, dtype=bool)
    core[rng.permutation(n)[: max(1, round(rho * n))]] = True
    w = np.where(core, ratio, 1.0)
    same = core[iu] == core[iv]
    pw = w[iu] * w[iv] * np.where(same, 1.0 + t, 1.0 - t)
    target = float(np.clip(target_m, 1, len(pw)))
    lo, hi = 0.0, 1.0 / max(pw.min(), 1e-6)  # q=hi → every pair kept
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if np.minimum(1.0, mid * pw).sum() < target:
            lo = mid
        else:
            hi = mid
    keep = rng.random(len(pw)) < np.minimum(1.0, hi * pw)
    codes = iu[keep].astype(np.int64) * n + iv[keep]
    chain_u = np.arange(n - 1, dtype=np.int64)
    codes = np.union1d(codes, chain_u * n + (chain_u + 1))
    return (codes // n).astype(np.int32), (codes % n).astype(np.int32)


def _sample_ego_cliques(rng: np.random.Generator, n: int, target_m: int,
                        frac: float, spread: float = 0.4):
    """Union-of-cliques ego-network with ~`target_m` undirected edges:
    cliques of lognormal mean size `frac·n` are unioned until the edge
    budget fills (the last clique is randomly truncated to land on it);
    a Hamiltonian-path backbone keeps degree ≥ 1.

    This is HOW the real COLLAB graphs arise — each graph is a
    researcher's ego collaboration network, i.e. a union of co-author
    cliques — so the class lever (mean clique size via `frac`) plants
    exactly the local-structure signal (triangle/ego-clique density)
    that distinguishes the real classes' collaboration cultures: few
    large collaborations vs many small ones at the SAME size and edge
    density. Degree features can read it through GCN aggregation because
    clique co-membership correlates neighbor degrees over multiple hops."""
    chain_u = np.arange(n - 1, dtype=np.int64)
    codes = chain_u * n + (chain_u + 1)
    target = int(np.clip(target_m, 1, n * (n - 1) // 2))
    mean_size = float(np.clip(frac * n, 2.0, n))
    mu = np.log(mean_size) - spread ** 2 / 2.0  # lognormal MEAN = frac·n
    while len(codes) < target:
        size = int(np.clip(round(rng.lognormal(mu, spread)), 2, n))
        members = np.sort(rng.choice(n, size=size, replace=False))
        iu, iv = np.triu_indices(size, 1)
        new = np.setdiff1d(
            members[iu].astype(np.int64) * n + members[iv], codes
        )
        need = target - len(codes)
        if len(new) > need:
            new = rng.permutation(new)[:need]
        codes = np.concatenate([codes, new])
    codes = np.sort(codes)
    return (codes // n).astype(np.int32), (codes % n).astype(np.int32)


def synthesize_tu_dataset(
    name: str, num_graphs: Optional[int] = None, seed: int = 0,
    use_node_attr: bool = True,
) -> GraphSet:
    """Generate a profile-shaped synthetic dataset. `num_graphs=None` uses
    the benchmark's real graph count (for bench/full-run shapes).
    `use_node_attr=False` drops continuous attr columns, mirroring
    parse_tu_dir's flag so the synthetic feature width matches what the
    same config sees on real data."""
    if name not in PROFILES:
        raise KeyError(f"unknown profile {name!r}; have {sorted(PROFILES)}")
    p = PROFILES[name]
    g = p["num_graphs"] if num_graphs is None else int(num_graphs)
    c = p["num_classes"]
    n_labels, n_attrs = p["num_node_labels"], p["num_attrs"]
    if not use_node_attr:
        n_attrs = 0
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, sorted(PROFILES).index(name)])
    )

    # balanced class assignment, shuffled
    y = rng.permutation((np.arange(g) % c).astype(np.int32))

    node_ptr = np.zeros(g + 1, dtype=np.int64)
    edge_ptr = np.zeros(g + 1, dtype=np.int64)
    srcs, dsts, labels_list, attrs_list = [], [], [], []
    degree_only = not n_labels and not n_attrs
    for i in range(g):
        # degree-only datasets also shift node count per class (±10-20%):
        # the smallest COLLAB/IMDB graphs saturate to cliques at the
        # profile density, where no degree-distribution signal can exist —
        # size is the signal that carries them
        # per-class size shift is SYMMETRIC around the profile mean, so
        # avg_nodes is preserved whatever the strength; strength and the
        # assortativity span are profile-tunable (degree-only datasets
        # only — see the COLLAB signal sweep record below PROFILES)
        size_shift = p.get("size_shift", 0.2)
        assort = p.get("assort", 0.7)
        size_mu = p["avg_nodes"] * (
            (1.0 + size_shift * (float(y[i]) - (c - 1) / 2.0))
            if degree_only else 1.0
        )
        # lognormal(mu, sigma) has MEAN exp(mu + sigma^2/2): subtract
        # sigma^2/2 so size_mu is the distribution's mean, as the profile
        # table documents (avg_nodes) — log(size_mu) alone makes it the
        # median and overshoots the mean by exp(sigma^2/2) (DD: +38%)
        n = int(np.clip(
            round(rng.lognormal(
                np.log(size_mu) - p["sigma"] ** 2 / 2.0, p["sigma"]
            )),
            5, p["max_nodes"],
        ))
        # planted signal: class shifts edge density ±25%
        d = p["avg_degree"] * (1.0 + 0.25 * (float(y[i]) - (c - 1) / 2.0))
        if degree_only and p.get("family") == "cliques":
            # class sets the clique-size distribution of the ego-network:
            # class y's cliques average clique_frac·clique_sep^(y−(c−1)/2)
            # of the graph — same size and edge budget, different local
            # structure (_sample_ego_cliques)
            frac = p.get("clique_frac", 0.35) * p.get(
                "clique_sep", 2.0
            ) ** (float(y[i]) - (c - 1) / 2.0)
            u, v = _sample_ego_cliques(rng, n, round(n * d / 2.0), frac)
        elif degree_only:
            # class additionally sets the degree assortativity — see
            # _sample_two_block for why the density shift alone does not
            # reach the model through normalization + top-k SortPooling on
            # the larger graphs (it DOES for sub-k graphs, where
            # SortPooling keeps every node — the signals compose).
            # ratio_sep (optional) further separates the degree-TAIL
            # shape per class (core weight ratio), which survives the
            # per-graph max normalization as a histogram-shape signal
            t = assort * (2.0 * float(y[i]) / max(1, c - 1) - 1.0)
            ratio = 4.0 * p.get("ratio_sep", 1.0) ** (
                float(y[i]) - (c - 1) / 2.0
            )
            u, v = _sample_two_block(
                rng, n, round(n * d / 2.0), t, ratio=ratio
            )
        else:
            u, v = _sample_undirected_edges(rng, n, round(n * d / 2.0))
        # store both directions (TU graphs are symmetric — SURVEY §2c)
        srcs.append(np.concatenate([u, v]))
        dsts.append(np.concatenate([v, u]))
        node_ptr[i + 1] = node_ptr[i] + n
        edge_ptr[i + 1] = edge_ptr[i] + 2 * len(u)
        if n_labels:
            # planted signal: class rotates the label histogram
            w = 1.5 ** (-((np.arange(n_labels) + y[i] * max(1, n_labels // c))
                          % n_labels))
            labels_list.append(rng.choice(n_labels, size=n, p=w / w.sum()))
        if n_attrs:
            attrs_list.append(
                rng.normal(0.5 * (float(y[i]) - (c - 1) / 2.0), 1.0,
                           size=(n, n_attrs)).astype(np.float32)
            )

    total_nodes = int(node_ptr[-1])
    node_labels = None
    if n_labels:
        node_labels = np.concatenate(labels_list).astype(np.int64)
        # guarantee every label bin occurs so the one-hot width is always
        # n_labels (matches the real datasets, where all bins appear)
        node_labels[: min(n_labels, total_nodes)] = np.arange(
            min(n_labels, total_nodes)
        )
    node_attrs = np.concatenate(attrs_list) if n_attrs else None

    edge_src = np.concatenate(srcs).astype(np.int32)
    edge_dst = np.concatenate(dsts).astype(np.int32)
    x = assemble_features(
        total_nodes, node_ptr, edge_dst, edge_ptr, node_labels, node_attrs
    )
    return GraphSet(
        x=x,
        node_ptr=node_ptr,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_ptr=edge_ptr,
        y=y,
        num_classes=c,
    )
