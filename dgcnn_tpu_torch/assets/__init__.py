"""Bundled data assets: a byte-for-byte copy of dgcnn_tpu/assets/folds.npz
(canonical CV fold indices — see data/folds.py). A package so packaging
tools ship the .npz payload declared in pyproject.toml."""
