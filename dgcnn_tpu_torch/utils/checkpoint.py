"""Checkpoint save/restore — the port of dgcnn_tpu/utils/checkpoint.py.

A bundle is a nested dict (and lists) of tensors, arrays and numbers,
stored as one `<path>.npz` of leaves keyed by their '/'-joined path, plus
a `<path>.treedef.json` manifest of the keys. Writes are atomic: each
file goes to a temporary name and is renamed, the manifest first, so a
crash between the two renames leaves the previous valid .npz beside it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        return [(prefix, np.asarray(tree))]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def save_checkpoint(path: str, bundle: Dict[str, Any]) -> None:
    """Atomically write a bundle to `<path>.npz` (+ `<path>.treedef.json`)."""
    leaves = _flatten(bundle)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp_manifest = path + ".tmp.treedef.json"
    with open(tmp_manifest, "w") as f:
        json.dump({"keys": [k for k, _ in leaves], "num_leaves": len(leaves)}, f)
    os.replace(tmp_manifest, path + ".treedef.json")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **dict(leaves))
    os.replace(tmp, path + ".npz")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a bundle back as nested dicts of numpy arrays (list positions
    become string keys "0", "1", …). Raises ValueError when the npz and
    its manifest disagree."""
    with open(path + ".treedef.json") as f:
        keys = json.load(f)["keys"]
    out: Dict[str, Any] = {}
    with np.load(path + ".npz") as z:
        if sorted(z.files) != sorted(keys):
            raise ValueError(f"{path}: npz leaves do not match its manifest")
        for key in keys:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path + ".npz")
