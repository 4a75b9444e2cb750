"""The `dgcnn` family's program side (benchmark/family.py): the published
model in the names of the program's Config, and the program's model and
nets built from the benchmark's flat weights (`inputs.make_inputs`),
which benchmark/drive.py builds through."""

from __future__ import annotations

from dgcnn_tpu_torch.models.dgcnn import DGCNNFoldsNet, DGCNNNet, stack_params
from dgcnn_tpu_torch.train import cv


def config_fields(model: dict) -> dict:
    """The model group as the program's Config names its fields."""
    return {"hidden_dims": tuple(model["hidden_dims"]), "sort_pool_k": model["sort_pool_k"],
            "conv1d_channels": tuple(model["conv1d_channels"]),
            "conv1d_kernel": model["conv1d_kernel"], "dense_dim": model["dense_dim"],
            "dropout_rate": model["dropout_rate"]}


def model(pcfg, num_features: int, num_classes: int):
    """The program's model, as its CV driver builds it from the Config."""
    return cv._model_from_config(pcfg, num_features, num_classes)


def nest(flat: dict) -> dict:
    """{"gcn.0.w": t, ...} → the nested {"gcn": [{"w", "b"}], "conv5": {...}}."""
    gcn = sorted({int(k.split(".")[1]) for k in flat if k.startswith("gcn.")})
    out = {"gcn": [{"w": flat[f"gcn.{i}.w"], "b": flat[f"gcn.{i}.b"]} for i in gcn]}
    for name in ("conv5", "conv6", "lin1", "lin2"):
        out[name] = {"w": flat[f"{name}.w"], "b": flat[f"{name}.b"]}
    return out


def net(m, flat: dict) -> DGCNNNet:
    """One fold's net, owning the weights `flat`."""
    return DGCNNNet(m, nest(flat))


def folds_net(m, flats: list) -> DGCNNFoldsNet:
    """The folds' nets in one module, for fold-lockstep, from their weights."""
    return DGCNNFoldsNet(m, stack_params([nest(f) for f in flats]))
