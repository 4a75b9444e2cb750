"""Everything a run feeds both sides, made from `--seed`: the graphs, the
fold split, each fold's epoch shuffles, the initial weights and the
dropout generators' seeds. The program and the plain reference get the
same objects; neither makes any of them itself."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from benchmark import family, synthetic

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    """`configs/<name>.json`, its model family's modules found
    (`family.of`: a ValueError names a missing one)."""
    cfg = load_json("configs", name + ".json")
    family.of(cfg)
    return cfg


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
    shapes = family.of(cfg).reference.leaf_shapes(cfg["model"], graphs["x"].shape[1],
                                                  graphs["num_classes"])
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
