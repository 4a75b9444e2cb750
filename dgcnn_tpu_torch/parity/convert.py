"""Weight transfer between the JAX reference's parameter pytree and the
port's `DGCNNNet` state — the port's counterpart of
dgcnn_tpu/parity/convert.py.

Both packages keep the same layout (weights [in, out], conv6 'HIO', the
readout flattened time-major), so the transfer is a copy: numpy leaves in,
tensors out, and back. The nested tree is the reference's
{"gcn": [{"w", "b"}, ...], "conv5": {"w", "b"}, "conv6", "lin1", "lin2"};
the port's state keys are `gcn.<i>.w`, `gcn.<i>.b`, `conv5.w`, ….
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_HEADS = ("conv5", "conv6", "lin1", "lin2")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference pytree (numpy or array-like leaves) → port state dict."""
    state: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["gcn"]):
        for n in ("w", "b"):
            state[f"gcn.{i}.{n}"] = torch.from_numpy(
                np.array(layer[n], dtype=np.float32)
            )
    for name in _HEADS:
        for n in ("w", "b"):
            state[f"{name}.{n}"] = torch.from_numpy(
                np.array(tree[name][n], dtype=np.float32)
            )
    return state


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
