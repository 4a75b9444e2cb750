"""Real-data ingestion at dataset scale; the port's copy of
tools/dress_rehearsal.py.

The build environment has no network, so no real TU download can run
here. This tool drives the real-data path (TU zip → `fetch_datasets
--from_zip` → strict stats check → npz cache → the CLI) at full scale
with the one TU corpus it can make offline: the synthetic profile
written as genuine TU text files (`data/tu_parser.py write_tu_format`).

  1. synthesize the full-scale profile (default NCI1: 4,110 graphs);
  2. recover the TU raw pieces (node labels from the one-hot block, the
     attribute columns), write `<name>_A.txt` etc. and zip them as a
     TU-Dortmund download is zipped (a top-level `<name>/` directory);
  3. `fetch_one(from_zip=...)`: parse, strict published-stats check,
     cache: the code a user with network access runs;
  4. reload from the cache and require the round trip byte-identical to
     the generated dataset (features, topology, labels);
  5. with `--train`, run the port's CLI (`python -m dgcnn_tpu_torch.cli`,
     a fresh process) on the ingested cache for `--num_epochs` epochs and
     require it to finish with a finite accuracy. It runs on the card;
     `--platform cpu` runs it on the CPU, and without a card it raises
     before anything is written.

    python -m dgcnn_tpu_torch.tools.dress_rehearsal [--name NCI1] [--train]

Prints one JSON line with the verified counts (or {"error": ...}).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import zipfile

import numpy as np

from dgcnn_tpu_torch.data.datasets import load_dataset
from dgcnn_tpu_torch.data.synthetic import PROFILES, synthesize_tu_dataset
from dgcnn_tpu_torch.data.tu_parser import write_tu_format
from dgcnn_tpu_torch.tools.fetch_datasets import fetch_one
from dgcnn_tpu_torch.train.cv import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_tu_zip(gs, name: str, out_dir: str) -> str:
    """GraphSet → `<out_dir>/<name>.zip` with the TU download layout
    (a top-level `<name>/` holding the `_*.txt` files)."""
    prof = PROFILES[name]
    n_attrs, n_labels = prof["num_attrs"], prof["num_node_labels"]
    attrs = gs.x[:, :n_attrs].astype(np.float32) if n_attrs else None
    labels = (np.argmax(gs.x[:, n_attrs: n_attrs + n_labels], axis=1)
              if n_labels else None)
    raw = os.path.join(out_dir, "_tu_raw", name)
    write_tu_format(raw, name, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                    gs.y, node_labels=labels, node_attrs=attrs)
    zip_path = os.path.join(out_dir, f"{name}.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for fn in sorted(os.listdir(raw)):
            z.write(os.path.join(raw, fn), arcname=f"{name}/{fn}")
    shutil.rmtree(os.path.join(out_dir, "_tu_raw"))
    return zip_path


def train_cli(name: str, root: str, num_epochs: int, platform: str) -> str:
    """The CLI on the ingested cache in a fresh process (so its device
    logic runs as a user's); its `Overall ...` line, whose test accuracy
    must be finite."""
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run(
            [sys.executable, "-m", "dgcnn_tpu_torch.cli", "--data_type", name,
             "--num_epochs", str(num_epochs), "--data_root", root, "--out_root", td,
             "--platform", platform],
            capture_output=True, text=True, timeout=1500, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"the CLI failed ({proc.returncode}):\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("Overall")]
    acc = re.search(r"Testing Accuracy: ([^%]+)%", line[-1]) if line else None
    if acc is None or not math.isfinite(float(acc.group(1))):
        raise RuntimeError(f"no finite test accuracy in the CLI's output:\n"
                           f"{proc.stdout[-2000:]}")
    return line[-1].strip()


def run(name: str, root: str, train: bool, num_epochs: int = 3,
        platform: str = "auto") -> dict:
    if train:  # before anything is written: no card, no run
        resolve_device("cpu" if platform == "cpu" else None)
    gs = synthesize_tu_dataset(name, num_graphs=None, seed=0)
    with tempfile.TemporaryDirectory() as td:
        zip_path = make_tu_zip(gs, name, td)
        zip_bytes = os.path.getsize(zip_path)
        if not fetch_one(name, root, from_zip=zip_path):
            raise RuntimeError("fetch_one failed")

    loaded, meta = load_dataset(name, root, allow_synthetic=False, strict_stats=True)
    if meta.source != "cache":
        raise RuntimeError(f"loaded from {meta.source}, not the cache")
    # the round trip: generator → TU text → parser → cache, byte for byte
    for field in ("x", "node_ptr", "edge_src", "edge_dst", "edge_ptr", "y"):
        np.testing.assert_array_equal(getattr(loaded, field), getattr(gs, field),
                                      err_msg=field)
    if loaded.num_classes != gs.num_classes:
        raise RuntimeError(f"num_classes {loaded.num_classes} != {gs.num_classes}")

    out = {
        "name": name,
        "graphs": int(loaded.num_graphs),
        "nodes": int(loaded.node_ptr[-1]),
        "edges": int(loaded.edge_ptr[-1]),
        "zip_bytes": int(zip_bytes),
        "round_trip": "byte_identical",
    }
    if train:
        out["cli"] = train_cli(name, root, num_epochs, platform)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", default="NCI1", choices=sorted(PROFILES))
    ap.add_argument("--root", default=None,
                    help="dataset root (default: a temporary directory, removed)")
    ap.add_argument("--train", action="store_true",
                    help="also train the CLI on the ingested cache")
    ap.add_argument("--num_epochs", type=int, default=3,
                    help="the CLI's epochs under --train")
    ap.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                    help="where --train runs: auto = the card (raises when "
                         "CUDA is absent); cpu = the plain PyTorch path")
    args = ap.parse_args(argv)

    td = None
    root = args.root
    if root is None:
        td = tempfile.mkdtemp(prefix="dress_rehearsal_")
        root = os.path.join(td, "data")
    try:
        out = run(args.name, root, args.train, args.num_epochs, args.platform)
    except Exception as exc:  # one parseable line either way
        print(json.dumps({"error": repr(exc)[:300]}))
        raise
    finally:
        if td is not None:
            shutil.rmtree(td, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
