"""Weight transfer between the JAX reference's parameter pytree and the
port's `DGCNNNet` state — the port's counterpart of
dgcnn_tpu/parity/convert.py.

Both packages keep the same layout (weights [in, out], conv6 'HIO', the
readout flattened time-major), so the transfer is a copy: numpy leaves in,
tensors out, and back. The nested tree is the reference's
{"gcn": [{"w", "b"}, ...], "conv5": {"w", "b"}, "conv6", "lin1", "lin2"};
the port's state keys are `gcn.<i>.w`, `gcn.<i>.b`, `conv5.w`, ….

Fold-stacked trees carry over the same way: the reference's lockstep
state (dgcnn_tpu/train/cv_vmap.py:632 `_init_all`, every leaf with a
leading fold axis) goes through `params_from_jax` into the state of a
`DGCNNFoldsNet`, and `fold_state` slices one fold back out as a
`DGCNNNet` state.

`params_to_torch_state` / `torch_state_to_params` convert between that
tree and the reference PyTorch/PyG model's `state_dict` (the port's copy
of dgcnn_tpu/parity/convert.py:25-96, NumPy in and out), which the parity
harness writes into its dumps and the oracle (parity/torch_oracle.py)
reads. The layouts differ there:
  * torch Linear/PyG-Linear weights are [out, in]; ours are [in, out];
  * conv5 `Conv1d(1, c5, C, C)` is our per-node matmul `w5 [C, c5]`
    (ops/readout.py), torch weight [c5, 1, C];
  * conv6 `Conv1d(c5, c6, K)` torch [c6, c5, K] ↔ ours 'HIO' [K, c5, c6];
  * torch flattens the readout [B, c6, T] channel-major, ours flattens
    [B, T, c6] time-major: a fixed row permutation of
    `classifier_1.weight` (`_flatten_perm`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_HEADS = ("conv5", "conv6", "lin1", "lin2")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference pytree (numpy, array-like or tensor leaves) → port state
    dict of fp32 CPU tensors (copies)."""
    state: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["gcn"]):
        for n in ("w", "b"):
            state[f"gcn.{i}.{n}"] = torch.from_numpy(
                np.array(as_numpy(layer[n]), dtype=np.float32)
            )
    for name in _HEADS:
        for n in ("w", "b"):
            state[f"{name}.{n}"] = torch.from_numpy(
                np.array(as_numpy(tree[name][n]), dtype=np.float32)
            )
    return state


def as_numpy(a) -> np.ndarray:
    """A leaf as a NumPy array (a tensor detached and copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state dict → reference pytree with numpy leaves."""

    def arr(key):
        return state[key].detach().cpu().numpy().copy()

    n_layers = len({k.split(".")[1] for k in state if k.startswith("gcn.")})
    return {
        "gcn": [
            {"w": arr(f"gcn.{i}.w"), "b": arr(f"gcn.{i}.b")}
            for i in range(n_layers)
        ],
        **{name: {"w": arr(f"{name}.w"), "b": arr(f"{name}.b")} for name in _HEADS},
    }


def state_to_params(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state dict → the nested dict of tensors `apply_dense` takes."""
    n_layers = len({k.split(".")[1] for k in state if k.startswith("gcn.")})
    return {
        "gcn": [
            {"w": state[f"gcn.{i}.w"], "b": state[f"gcn.{i}.b"]}
            for i in range(n_layers)
        ],
        **{name: {"w": state[f"{name}.w"], "b": state[f"{name}.b"]} for name in _HEADS},
    }


def fold_state(state: Dict[str, torch.Tensor], fold: int) -> Dict[str, torch.Tensor]:
    """Fold `fold` (0-based) of a fold-stacked port state dict (leaves
    [F, ...]) → a `DGCNNNet` state dict (copies)."""
    return {k: v[fold].detach().clone() for k, v in state.items()}


def _flatten_perm(t_len: int, c6: int) -> np.ndarray:
    """perm[ours_row] = torch_column: ours index t*c6+c ↔ torch c*T+t."""
    t_idx, c_idx = np.meshgrid(np.arange(t_len), np.arange(c6), indexing="ij")
    return (c_idx * t_len + t_idx).reshape(-1)


def params_to_torch_state(params, model) -> Dict[str, np.ndarray]:
    """Reference-shaped tree (NumPy or tensor leaves) → the reference
    model's `state_dict()` arrays (NumPy)."""
    state: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["gcn"], start=1):
        state[f"conv{i}.lin.weight"] = as_numpy(layer["w"]).T
        state[f"conv{i}.bias"] = as_numpy(layer["b"])

    w5 = as_numpy(params["conv5"]["w"])  # [C, c5]
    state["conv5.weight"] = w5.T[:, None, :]  # [c5, 1, C]
    state["conv5.bias"] = as_numpy(params["conv5"]["b"])

    w6 = as_numpy(params["conv6"]["w"])  # [K, c5, c6]
    state["conv6.weight"] = np.transpose(w6, (2, 1, 0))  # [c6, c5, K]
    state["conv6.bias"] = as_numpy(params["conv6"]["b"])

    t_len = model.sort_pool_k // 2 - model.conv1d_kernel + 1
    c6 = model.conv1d_channels[1]
    perm = _flatten_perm(t_len, c6)
    lin1 = as_numpy(params["lin1"]["w"])  # [flat(ours), dense]
    torch_w1 = np.empty_like(lin1.T)  # [dense, flat(torch)]
    torch_w1[:, perm] = lin1.T[:, np.arange(len(perm))]
    state["classifier_1.weight"] = torch_w1
    state["classifier_1.bias"] = as_numpy(params["lin1"]["b"])

    state["classifier_2.weight"] = as_numpy(params["lin2"]["w"]).T
    state["classifier_2.bias"] = as_numpy(params["lin2"]["b"])
    return state


def torch_state_to_params(state: Dict[str, np.ndarray], model) -> Dict[str, Any]:
    """The reference model's `state_dict()` arrays → reference-shaped tree
    with NumPy leaves (`params_from_jax` takes it into a port state)."""
    gcn = []
    i = 1
    while f"conv{i}.lin.weight" in state and i <= len(model.hidden_dims):
        gcn.append({"w": np.asarray(state[f"conv{i}.lin.weight"]).T,
                    "b": np.asarray(state[f"conv{i}.bias"])})
        i += 1

    w5 = np.asarray(state["conv5.weight"])[:, 0, :].T  # [C, c5]
    w6 = np.transpose(np.asarray(state["conv6.weight"]), (2, 1, 0))  # [K, c5, c6]

    t_len = model.sort_pool_k // 2 - model.conv1d_kernel + 1
    c6 = model.conv1d_channels[1]
    perm = _flatten_perm(t_len, c6)
    torch_w1 = np.asarray(state["classifier_1.weight"])  # [dense, flat(torch)]
    lin1 = torch_w1[:, perm].T  # [flat(ours), dense]

    return {
        "gcn": gcn,
        "conv5": {"w": w5, "b": np.asarray(state["conv5.bias"])},
        "conv6": {"w": w6, "b": np.asarray(state["conv6.bias"])},
        "lin1": {"w": lin1, "b": np.asarray(state["classifier_1.bias"])},
        "lin2": {"w": np.asarray(state["classifier_2.weight"]).T,
                 "b": np.asarray(state["classifier_2.bias"])},
    }
