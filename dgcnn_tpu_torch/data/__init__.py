"""Data layer: TU-format graph datasets as flat NumPy arrays — the port's
own copies of dgcnn_tpu/data (NumPy and the standard library only), so
both packages build the same bytes from the same seed."""

from dgcnn_tpu_torch.data.datasets import DATASET_STATS, DatasetMeta, load_dataset
from dgcnn_tpu_torch.data.folds import (
    get_folds,
    load_fold_indices,
    make_stratified_folds,
)
from dgcnn_tpu_torch.data.graphset import GraphSet
from dgcnn_tpu_torch.data.synthetic import PROFILES, synthesize_tu_dataset
from dgcnn_tpu_torch.data.tu_parser import (
    assemble_features,
    parse_tu_dir,
    write_tu_format,
)

__all__ = [
    "DATASET_STATS",
    "DatasetMeta",
    "GraphSet",
    "PROFILES",
    "assemble_features",
    "get_folds",
    "load_dataset",
    "load_fold_indices",
    "make_stratified_folds",
    "parse_tu_dir",
    "synthesize_tu_dataset",
    "write_tu_format",
]
