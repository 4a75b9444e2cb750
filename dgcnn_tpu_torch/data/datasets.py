"""Dataset loading: cache → raw TU files → synthetic fallback.

The capability contract follows PyG's `TUDataset` (reference train.py:81-87):
a one-time parse of the raw TU text files is cached as processed arrays
(npz instead of torch tensors), and subsequent loads skip parsing
(SURVEY §3.5). Layout, shared with PyG so a user can drop in already-
downloaded data:

    <root>/<name>/raw/<name>_A.txt ...       raw TU text files
    <root>/<name>/processed/<name>[...].npz  our cache (per use_node_attr)

Offline behavior: with no raw files and no cache, callers can opt into
the synthetic profile generator (`allow_synthetic=True`) which preserves
every shape/feature contract — see data/synthetic.py. Unlike
dgcnn_tpu/data/datasets.py this copy never downloads: the port reads only
the offline raw-dir and cache paths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.data.synthetic import SYNTHETIC_VERSION, synthesize_tu_dataset
from dgcnn_tpu_torch.data.tu_parser import parse_tu_dir

# Published stats of the eight benchmarks (reference README.md:62-94;
# num_features = attrs + one-hot label bins + 1 degree column, SURVEY §2d).
DATASET_STATS = {
    "MUTAG": dict(num_graphs=188, num_classes=2, num_features=8),
    "PTC_MR": dict(num_graphs=344, num_classes=2, num_features=19),
    "NCI1": dict(num_graphs=4110, num_classes=2, num_features=38),
    "PROTEINS": dict(num_graphs=1113, num_classes=2, num_features=5),
    "DD": dict(num_graphs=1178, num_classes=2, num_features=90),
    "COLLAB": dict(num_graphs=5000, num_classes=3, num_features=1),
    "IMDB-BINARY": dict(num_graphs=1000, num_classes=2, num_features=1),
    "IMDB-MULTI": dict(num_graphs=1500, num_classes=3, num_features=1),
}


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    """Provenance of a loaded dataset."""

    name: str
    source: str  # "cache" | "raw" | "synthetic"
    path: str = ""


def _raw_dir(root: str, name: str) -> str:
    return os.path.join(root, name, "raw")


def _cache_path(root: str, name: str, use_node_attr: bool) -> str:
    suffix = "" if use_node_attr else "_noattr"
    return os.path.join(root, name, "processed", f"{name}{suffix}.npz")


def _has_raw(raw: str, name: str) -> bool:
    return all(
        os.path.exists(os.path.join(raw, f"{name}_{s}.txt"))
        for s in ("A", "graph_indicator", "graph_labels")
    )


def verify_dataset_stats(
    name: str, gs: GraphSet, use_node_attr: bool = True, strict: bool = False
) -> bool:
    """Cross-check a loaded REAL dataset against the published benchmark
    stats (reference README.md:62-94). A mismatch means wrong/truncated
    raw files or a parser regression — warn loudly (or raise under
    `strict`) instead of silently training on the wrong data. Returns
    True when the stats match (or the dataset is unknown)."""
    want = DATASET_STATS.get(name)
    if want is None:
        return True
    got = dict(
        num_graphs=gs.num_graphs,
        num_classes=gs.num_classes,
        num_features=gs.num_features,
    )
    expected = dict(want)
    if not use_node_attr and name == "PROTEINS":
        expected["num_features"] = 4  # the 1 continuous attr column drops
    if got == expected:
        return True
    msg = (
        f"{name}: loaded stats {got} != published {expected} "
        f"(reference README.md:62-94) — wrong or truncated raw files?"
    )
    if strict:
        raise ValueError(msg)
    import warnings

    warnings.warn(msg, stacklevel=2)
    print(f"WARNING: {msg}")
    return False


def load_dataset(
    name: str,
    root: str = "data",
    use_node_attr: bool = True,
    allow_synthetic: bool = False,
    strict_stats: bool = False,
) -> Tuple[GraphSet, DatasetMeta]:
    """Load a benchmark dataset, preferring (in order) the processed cache,
    raw TU files, and — only if explicitly allowed — the
    synthetic profile generator. Real-data loads are cross-checked against
    the published benchmark stats (`verify_dataset_stats`)."""
    cache = _cache_path(root, name, use_node_attr)
    if os.path.exists(cache):
        gs = GraphSet.from_npz(cache)
        verify_dataset_stats(name, gs, use_node_attr, strict=strict_stats)
        return gs, DatasetMeta(name, "cache", cache)

    raw = _raw_dir(root, name)
    if _has_raw(raw, name):
        gs = parse_tu_dir(raw, name, use_node_attr=use_node_attr)
        verify_dataset_stats(name, gs, use_node_attr, strict=strict_stats)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        gs.to_npz(cache)
        return gs, DatasetMeta(name, "raw", raw)

    if allow_synthetic:
        # synthetic datasets cache separately from real ones (never under
        # the real cache path, so adding real data later wins), keyed by
        # the generator VERSION so a generator change invalidates stale
        # caches — regeneration is O(10s) for COLLAB/DD
        attr_tag = "" if use_node_attr else "_noattr"
        synth_cache = os.path.join(
            root, name, "processed",
            f"{name}_synthetic_v{SYNTHETIC_VERSION}{attr_tag}.npz",
        )
        if os.path.exists(synth_cache):
            return GraphSet.from_npz(synth_cache), DatasetMeta(
                name, "synthetic", synth_cache
            )
        gs = synthesize_tu_dataset(name, use_node_attr=use_node_attr)
        try:
            os.makedirs(os.path.dirname(synth_cache), exist_ok=True)
            gs.to_npz(synth_cache)
        except OSError:
            pass
        return gs, DatasetMeta(name, "synthetic")
    raise FileNotFoundError(
        f"dataset {name!r}: no cache at {cache} and no raw files at {raw}. "
        f"Place the TU files under {raw}/ (see "
        f"data/tu_parser.py for the format) or pass allow_synthetic=True "
        f"for profile-shaped synthetic data."
    )
