"""Fetch and verify TU benchmark datasets (the real-data ingestion path:
PyG TUDataset's download role, reference train.py:81-87); the port's
copy of tools/fetch_datasets.py, over the port's data layer.

    # on a machine with network access:
    python -m dgcnn_tpu_torch.tools.fetch_datasets --root data MUTAG NCI1 ...
    python -m dgcnn_tpu_torch.tools.fetch_datasets --root data --all

    # an already-downloaded TU zip (touches no network):
    python -m dgcnn_tpu_torch.tools.fetch_datasets --root data \
        --from_zip ~/Downloads/MUTAG.zip

then train with `python -m dgcnn_tpu_torch.cli --data_type MUTAG
--data_root data`. Every ingested dataset is parsed at once and strictly
verified against the published benchmark stats (graph, class and
feature counts, reference README.md:62-94) before its processed cache is
written: a truncated download or a wrong archive fails here, not
mid-training. The loader itself never downloads (data/datasets.py); only
this tool's URL mode does, when asked to.
"""

from __future__ import annotations

import argparse
import os
import shutil
import zipfile

from dgcnn_tpu_torch.data.datasets import (
    DATASET_STATS,
    _cache_path,
    _has_raw,
    _raw_dir,
    verify_dataset_stats,
)
from dgcnn_tpu_torch.data.tu_parser import parse_tu_dir

# TU-Dortmund graph-kernel collection (reference README.md:24-26)
TU_URL = "https://www.chrsmrrs.com/graphkerneldatasets/{name}.zip"


def _extract(zip_path: str, root: str, name: str) -> None:
    """Extract a TU zip (a top-level `<name>/` directory of `_*.txt`
    files) into <root>/<name>/raw/."""
    extract_root = os.path.join(root, name, "_extract")
    try:
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(extract_root)
        src = os.path.join(extract_root, name)
        if not os.path.isdir(src):
            raise ValueError(f"{zip_path}: no top-level {name}/ directory in archive")
        raw = _raw_dir(root, name)
        os.makedirs(raw, exist_ok=True)
        for fn in os.listdir(src):
            os.replace(os.path.join(src, fn), os.path.join(raw, fn))
        if not _has_raw(raw, name):
            raise ValueError(f"{zip_path}: archive missing required TU files")
    finally:
        shutil.rmtree(extract_root, ignore_errors=True)


def _download(root: str, name: str) -> bool:
    """Fetch and extract the TU zip (the reference's `_download`, which
    the port's loader does not have). False on any failure (network, a
    bad zip, an unexpected layout); scratch files are removed either way."""
    import urllib.request

    zip_path = os.path.join(root, name, f"{name}.zip")
    os.makedirs(os.path.dirname(zip_path), exist_ok=True)
    try:
        with urllib.request.urlopen(TU_URL.format(name=name), timeout=30) as r, \
                open(zip_path, "wb") as f:
            f.write(r.read())
        _extract(zip_path, root, name)
        return True
    except (OSError, ValueError, zipfile.BadZipFile):
        return False
    finally:
        if os.path.exists(zip_path):
            os.remove(zip_path)


def fetch_one(name: str, root: str, from_zip: str | None = None) -> bool:
    """Ingest (or download), parse, strictly verify and cache one dataset.
    True on success."""
    raw = _raw_dir(root, name)
    if from_zip is not None:
        _extract(from_zip, root, name)
        print(f"{name}: ingested from {from_zip}")
    elif _has_raw(raw, name):
        print(f"{name}: raw files already present")
    elif _download(root, name):
        print(f"{name}: downloaded")
    else:
        print(f"{name}: FAILED — no raw files and download failed "
              f"(no network? use --from_zip)")
        return False

    gs = parse_tu_dir(raw, name, use_node_attr=True)
    verify_dataset_stats(name, gs, use_node_attr=True, strict=True)
    cache = _cache_path(root, name, use_node_attr=True)
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    gs.to_npz(cache)
    print(f"{name}: verified ({gs.num_graphs} graphs, {gs.num_classes} classes, "
          f"{gs.num_features} features) → cached {cache}")
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("datasets", nargs="*", help="dataset names (see --all)")
    p.add_argument("--root", default="data")
    p.add_argument("--all", action="store_true",
                   help=f"fetch all benchmarks: {', '.join(DATASET_STATS)}")
    p.add_argument("--from_zip", default=None,
                   help="ingest this local TU zip instead of downloading (one "
                        "dataset; its name from the file name unless exactly "
                        "one dataset argument is given)")
    args = p.parse_args(argv)

    names = list(DATASET_STATS) if args.all else args.datasets
    if args.from_zip and not names:
        names = [os.path.splitext(os.path.basename(args.from_zip))[0]]
    if not names:
        p.error("give dataset names, --all, or --from_zip")
    if args.from_zip and len(names) != 1:
        p.error("--from_zip ingests exactly one dataset")

    ok = True
    for name in names:
        if name not in DATASET_STATS:
            print(f"{name}: unknown (choices: {', '.join(DATASET_STATS)})")
            ok = False
            continue
        ok &= fetch_one(name, args.root, args.from_zip)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
