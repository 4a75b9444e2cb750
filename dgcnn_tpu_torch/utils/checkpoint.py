"""Checkpoint save/restore — the port of dgcnn_tpu/utils/checkpoint.py.

A bundle is a nested dict (and lists) of tensors, arrays and numbers,
stored as one `<path>.npz` of leaves keyed by their '/'-joined path, plus
a `<path>.treedef.json` manifest of the keys. Writes are atomic: each
file goes to a temporary name and is renamed, the manifest first, so a
crash between the two renames leaves the previous valid .npz beside it.

`load_into` puts a loaded bundle back into live objects (a module's
parameters, an Adam's state, a `FoldAdam`'s buffers, a generator's
state) by an in-place `copy_` into the tensors that already exist: a
captured CUDA graph holds their addresses. A bundle whose leaves or
shapes are not the live object's raises ValueError, so a bundle written
under one optimizer layout (per-leaf or `--opt_flatten`) does not load
under the other. The format is the port's own: leaves keyed by the
port's state-dict paths, which the reference's bundles do not carry.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch


def _leaf_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaf_paths(v, f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree: Any) -> List[Tuple[str, np.ndarray]]:
    out = []
    for key, leaf in _leaf_paths(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        out.append((key, np.asarray(leaf)))
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


def remove_checkpoint(path: str) -> None:
    """Delete a bundle's files, if there are any."""
    for suffix in (".npz", ".treedef.json"):
        try:
            os.remove(path + suffix)
        except FileNotFoundError:
            pass


def _restore_tensors(live: Any, saved: Any, what: str = "bundle") -> None:
    """Copy every leaf of `saved` (a `load_checkpoint` subtree) into the
    live tensor at the same path of `live`, in place. Raises ValueError,
    before copying anything, unless both have the same paths and shapes."""
    want, got = dict(_leaf_paths(live)), dict(_leaf_paths(saved))
    if want.keys() != got.keys():
        raise ValueError(
            f"{what}: the bundle's leaves {sorted(got)} are not the live "
            f"object's {sorted(want)} (written under another model or "
            f"optimizer layout, e.g. with or without --opt_flatten?)")
    for key, t in want.items():
        if tuple(np.shape(got[key])) != tuple(t.shape):
            raise ValueError(f"{what}/{key}: the bundle's shape {np.shape(got[key])} "
                             f"is not the live tensor's {tuple(t.shape)}")
    with torch.no_grad():
        for key, t in want.items():
            t.copy_(torch.from_numpy(np.array(got[key])))  # a contiguous copy, 0-d kept


def init_adam_state(optimizer: torch.optim.Adam) -> None:
    """Create the state `torch.optim.Adam` creates lazily at its first
    step (`Adam._init_group`), where it is missing: the step count on the
    parameter's device when the optimizer is capturable, else on the CPU,
    and zero moments."""
    for group in optimizer.param_groups:
        on_device = group["capturable"] or group["fused"]
        for p in group["params"]:
            st = optimizer.state[p]
            if st:
                continue
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device if on_device else "cpu")
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def adam_tensors(optimizer: torch.optim.Adam) -> Dict[str, list]:
    """Adam's live step counts and moments, a list per key in the
    optimizer's parameter order (the state must exist: `init_adam_state`)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {key: [optimizer.state[p][key] for p in params]
            for key in ("step", "exp_avg", "exp_avg_sq")}


def adam_state(optimizer: torch.optim.Adam) -> Dict[str, list]:
    """Adam's step counts and moments, a list per key in the optimizer's
    parameter order (zeros where it has taken no step), on the CPU: a
    `capturable` Adam keeps its step counts on the card."""
    init_adam_state(optimizer)
    return {key: [t.detach().cpu() for t in ts]
            for key, ts in adam_tensors(optimizer).items()}


def load_into(obj: Any, saved: Any) -> None:
    """Put a bundle's subtree back into the live `obj`, in place:
      * an `nn.Module`: its parameters (state-dict paths);
      * a `torch.optim.Adam`: its step counts and moments in `adam_state`'s
        layout (a missing state is created first; a capturable Adam's
        step counts stay on the device);
      * a `torch.Generator`: its state (`get_state()`'s bytes);
      * anything with `state_tensors()` (train/loop.py `FoldAdam`): the
        tensors it returns."""
    if isinstance(obj, torch.Generator):
        obj.set_state(torch.from_numpy(np.array(saved, dtype=np.uint8)))
    elif isinstance(obj, torch.nn.Module):
        _restore_tensors(obj.state_dict(), saved, "params")
    elif isinstance(obj, torch.optim.Adam):
        init_adam_state(obj)
        _restore_tensors(adam_tensors(obj), saved, "opt_state")
    else:
        _restore_tensors(obj.state_tensors(), saved, type(obj).__name__)
