"""Cross-validation fold indices.

The reference vendors fixed 10-fold index files from muhanzhang/pytorch_DGCNN
(`data/<DS>/10fold_idx/{train,test}_idx-<k>.txt`, one 0-based graph index
per line) and loads them with `np.loadtxt` (reference train.py:103-106,
README.md:26-27). We read the same files verbatim when present — required
for accuracy-parity runs, since those folds are NOT an exact partition for
MUTAG/PTC/PROTEINS/DD (SURVEY §2a "Fold-index data") — and otherwise fall
back to deterministic stratified folds.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

Fold = Tuple[np.ndarray, np.ndarray]

# Canonical fold indices bundled from the reference protocol (see
# tools/import_reference_folds.py for provenance + regeneration).
_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "folds.npz",
)


def load_fold_indices(fold_dir: str, fold_number: int) -> Fold:
    """Read `{train,test}_idx-<k>.txt` exactly like the reference
    (train.py:103-106)."""
    train = np.loadtxt(
        os.path.join(fold_dir, f"train_idx-{fold_number}.txt"), dtype=np.int64
    ).reshape(-1)
    test = np.loadtxt(
        os.path.join(fold_dir, f"test_idx-{fold_number}.txt"), dtype=np.int64
    ).reshape(-1)
    return train, test


def has_fold_files(fold_dir: str, num_folds: int) -> bool:
    return all(
        os.path.exists(os.path.join(fold_dir, f"{kind}_idx-{k}.txt"))
        for k in range(1, num_folds + 1)
        for kind in ("train", "test")
    )


def make_stratified_folds(
    y: np.ndarray, num_folds: int = 10, seed: int = 0
) -> List[Fold]:
    """Deterministic stratified K-fold: per class, shuffle then deal
    round-robin into folds. Test sets form an exact partition of the
    dataset; train = complement."""
    y = np.asarray(y)
    n = len(y)
    rng = np.random.default_rng(np.random.SeedSequence([seed, num_folds]))
    fold_of = np.empty(n, dtype=np.int64)
    for cls in np.unique(y):
        members = rng.permutation(np.flatnonzero(y == cls))
        fold_of[members] = np.arange(len(members)) % num_folds
    all_idx = np.arange(n)
    return [
        (all_idx[fold_of != k], all_idx[fold_of == k]) for k in range(num_folds)
    ]


def load_bundled_folds(
    data_type: str, num_folds: int, num_graphs: int
) -> Optional[List[Fold]]:
    """Canonical folds from the bundled asset, or None when the asset lacks
    this dataset/fold-count or was built for a different dataset size
    (bundled indices address the REAL benchmark — reject them for
    synthetic/subset datasets whose graph count differs)."""
    if not os.path.exists(_ASSET):
        return None
    with np.load(_ASSET) as z:
        keys = [
            (f"{data_type}/train_idx-{k}", f"{data_type}/test_idx-{k}")
            for k in range(1, num_folds + 1)
        ]
        if not all(tr in z and te in z for tr, te in keys):
            return None
        folds = [(z[tr], z[te]) for tr, te in keys]
    # reject unless the folds COVER this dataset: indices in range AND
    # every graph present in some fold (a larger synthetic dataset would
    # otherwise silently run CV on a prefix of itself). Coverage is over
    # train ∪ test — the reference's own 10fold_idx files leave a few
    # graphs out of every TEST fold (MUTAG: 180/188) but none out of both.
    if max(int(arr.max()) for pair in folds for arr in pair) >= num_graphs:
        return None
    covered = np.unique(np.concatenate([a for pair in folds for a in pair]))
    if len(covered) != num_graphs:
        return None
    return folds


def get_folds(
    y: np.ndarray,
    fold_dir: str,
    num_folds: int = 10,
    seed: int = 0,
    data_type: str = "",
) -> List[Fold]:
    """Fold resolution: user fold files → bundled canonical folds (parity
    with the reference protocol) → deterministic stratified folds."""
    if fold_dir and has_fold_files(fold_dir, num_folds):
        return [load_fold_indices(fold_dir, k) for k in range(1, num_folds + 1)]
    if data_type:
        bundled = load_bundled_folds(data_type, num_folds, len(y))
        if bundled is not None:
            return bundled
    return make_stratified_folds(y, num_folds, seed)
