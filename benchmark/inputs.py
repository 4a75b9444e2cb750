"""Everything a run feeds both sides, made from `--seed`: the graphs, the
fold split, each fold's epoch shuffles, the initial weights and the
dropout generators' seeds. The program and the plain reference get the
same objects; neither makes any of them itself."""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from benchmark import synthetic

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def leaf_shapes(model: dict, num_features: int, num_classes: int) -> list:
    """(name, shape, init bound) of every weight in the published layout:
    GCN weights [in, out] (Glorot bound, zero biases), conv5 one matmul a
    sort-pooled row [Σdims, c5], conv6 [width, c5, c6], the readout
    flattened time-major into lin1 [T·c6, dense], lin2 [dense, C]; the
    others torch's default U(±1/√fan_in). A bound of 0 is a zero leaf."""
    out, d_in = [], num_features
    for i, d in enumerate(model["hidden_dims"]):
        out += [(f"gcn.{i}.w", (d_in, d), math.sqrt(6.0 / (d_in + d))),
                (f"gcn.{i}.b", (d,), 0.0)]
        d_in = d
    cat = sum(model["hidden_dims"])
    c5, c6 = model["conv1d_channels"]
    w = model["conv1d_kernel"]
    flat = (model["sort_pool_k"] // 2 - w + 1) * c6
    dense = model["dense_dim"]
    for name, shape, fan in (("conv5.w", (cat, c5), cat), ("conv5.b", (c5,), cat),
                             ("conv6.w", (w, c5, c6), c5 * w), ("conv6.b", (c6,), c5 * w),
                             ("lin1.w", (flat, dense), flat), ("lin1.b", (dense,), flat),
                             ("lin2.w", (dense, num_classes), dense),
                             ("lin2.b", (num_classes,), dense)):
        out.append((name, shape, 1.0 / math.sqrt(fan)))
    return out


def nest(flat: dict) -> dict:
    """{"gcn.0.w": t, ...} → the nested {"gcn": [{"w", "b"}], "conv5": {...}}."""
    gcn = sorted({int(k.split(".")[1]) for k in flat if k.startswith("gcn.")})
    out = {"gcn": [{"w": flat[f"gcn.{i}.w"], "b": flat[f"gcn.{i}.b"]} for i in gcn]}
    for name in ("conv5", "conv6", "lin1", "lin2"):
        out[name] = {"w": flat[f"{name}.w"], "b": flat[f"{name}.b"]}
    return out


def stratified_folds(y: np.ndarray, k: int, seed: int) -> list:
    """Per class, the members shuffled and dealt round-robin: [(train, test)]."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7, k]))
    fold_of = np.empty(len(y), dtype=np.int64)
    for c in np.unique(y):
        members = rng.permutation(np.flatnonzero(y == c))
        fold_of[members] = np.arange(len(members)) % k
    idx = np.arange(len(y))
    return [(idx[fold_of != f].astype(np.int32), idx[fold_of == f].astype(np.int32))
            for f in range(k)]


def stream_seed(seed: int, *key: int) -> int:
    a, b = np.random.SeedSequence([int(seed), *key]).generate_state(2)
    return (int(a) << 31 ^ int(b)) & ((1 << 63) - 1)


@dataclasses.dataclass
class Inputs:
    cfg: dict  # the configuration file
    seed: int
    graphs: dict  # synthetic.generate's arrays
    folds: list  # [(train ids, test ids)] a fold
    params: list  # [fold] → {"gcn.0.w": tensor, ...} on the device
    dropout_seeds: list  # [fold] → int

    def shuffle(self, fold: int) -> np.random.Generator:
        """Fold `fold`'s epoch shuffle stream: epoch e's order of its
        training graphs is the e-th `permutation(n_train)`."""
        return np.random.default_rng(np.random.SeedSequence([self.seed, 11, fold]))

    def epoch_ids(self, fold: int, epochs: int) -> list:
        """The training graph ids of fold `fold`'s first `epochs` epochs."""
        rng, train = self.shuffle(fold), self.folds[fold][0]
        return [train[rng.permutation(len(train))] for _ in range(epochs)]


def make_inputs(cfg: dict, seed: int, device, num_graphs: int = 0) -> Inputs:
    """The run's inputs; `num_graphs` > 0 cuts the dataset (CPU tests only)."""
    data = dict(cfg["data"])
    if num_graphs:
        data["num_graphs"] = int(num_graphs)
    graphs = synthetic.generate(data, seed, data["profile_id"])
    tr = cfg["train"]
    folds = stratified_folds(graphs["y"], tr["num_folds"], seed)
    shapes = leaf_shapes(cfg["model"], graphs["x"].shape[1], graphs["num_classes"])
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 5))
    # every fold's weights in one draw on the device
    u = torch.rand((tr["num_folds"], sum(sizes)), generator=gen, device=device)
    params = []
    for f in range(tr["num_folds"]):
        leaves, off = {}, 0
        for (name, shape, bound), n in zip(shapes, sizes):
            leaves[name] = (((u[f, off:off + n] * 2.0 - 1.0) * bound).reshape(shape)
                            if bound else torch.zeros(shape, device=device))
            off += n
        params.append(leaves)
    return Inputs(cfg, int(seed), graphs, folds, params,
                  [stream_seed(seed, 13, f) for f in range(tr["num_folds"])])
