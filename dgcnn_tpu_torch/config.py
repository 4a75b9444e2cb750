"""Experiment configuration — the port's copy of dgcnn_tpu/config.py.

Same field names, defaults and validation, so a CLI flag means the same on
both packages. What differs from the reference:

  * `adj_dtype="auto"` resolves to float32: the TPU's bf16 resolution
    rested on its matrix unit rounding fp32 operands anyway, which the
    H100's fp32 path does not do. `adj_dtype="bfloat16"` and
    `compute_dtype="bfloat16"` run as in the reference on the dense,
    multi-tile and block layouts (the kernels' bf16 modes); the COO
    layout ignores `adj_dtype`, as the reference's COO engines do, and
    runs bf16 compute with its SpMM kernels in fp32, as the reference's;
  * `dense_trunk` is accepted for flag parity, but the port always runs
    its CUDA trunk kernel on the card (kernels/dense_trunk.py);
  * `block_impl` names the port's two block-propagation kernels:
    "pallas" the CSR kernel (kernels/block_csr.py, the port of
    block_pallas), "xla" the item-parallel kernel
    (kernels/block_resident.py: per-item products, then a
    destination-sorted segment sum, as a kernel); "auto" resolves by the
    port's own H100 measurement (`resolved_block_impl`);
  * `spmm_impl` names one COO SpMM kernel each (ops/spmm.py): "xla" the
    row-parallel CSR kernel, "onehot" the edge-block kernel, "pallas" the
    block-COO kernel on host-packed batches that carry block-pair
    structures; "auto" resolves by the port's H100 measurement
    (`resolved_spmm_impl`), where the reference chose by TPU VMEM gates;
  * `coo_assembly` picks the COO engine as in the reference: "device"
    assembles batches on the card (`DeviceCooEngine`), "host" packs them
    with NumPy and ships one epoch at a time (`CooEngine`); `--spmm
    pallas` always packs on the host, where the structures are built;
  * `max_fused_epochs` bounds the epochs of one chunk, as in the
    reference, on every layout: a chunk's epochs run through the layout's
    fused runner (train/loop.py `FusedRun`: one host round trip a chunk;
    on the card one CUDA-graph replay an epoch once the runner has
    captured, at the chunk's budget on the block and COO layouts); every
    `epoch` event carries the chunk's `chunk_epochs` and its seconds
    over k;
  * `coo_fuse_bytes` has the reference's meaning for the host-packed COO
    engine (`CooEngine`): a chunk runs in sub-chunks of
    clip(`coo_fuse_bytes` // one packed epoch's bytes, 1, 64) epochs, one
    host round trip each;
  * `xla_cache_dir` is a TPU compile knob with no effect here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DATASETS = (
    "DD",
    "PTC_MR",
    "NCI1",
    "PROTEINS",
    "IMDB-BINARY",
    "IMDB-MULTI",
    "MUTAG",
    "COLLAB",
)


@dataclasses.dataclass(frozen=True)
class Config:
    """Full experiment configuration (field-for-field dgcnn_tpu.Config)."""

    # -- reference-parity flags (reference train.py:19-24) --
    data_type: str = "DD"
    batch_size: int = 50
    num_epochs: int = 100
    seed: int = 324

    # -- data --
    data_root: str = "data"
    fold_index_dir: Optional[str] = None
    use_node_attr: bool = True
    num_folds: int = 10

    # -- model --
    hidden_dims: Tuple[int, ...] = (32, 32, 32, 1)
    sort_pool_k: int = 30
    sort_pool_percentile: Optional[float] = None
    conv1d_channels: Tuple[int, int] = (16, 32)
    conv1d_kernel: int = 5
    dense_dim: int = 128
    dropout_rate: float = 0.5

    # -- optimization (Adam, optax.adam's formula) --
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    opt_flatten: bool = False

    # -- layout and kernels --
    layout: str = "auto"
    dense_max_nodes: int = 2048
    multi_dense_min_tile: int = 256
    dense_max_device_bytes: int = 8_000_000_000
    spmm_impl: str = "auto"
    node_pad_multiple: int = 256
    edge_pad_multiple: int = 1024
    graph_pad_multiple: int = 8
    compute_dtype: str = "float32"
    adj_dtype: str = "auto"
    block_impl: str = "auto"
    # accepted for flag parity: the port always runs its CUDA trunk
    dense_trunk: str = "auto"
    cv_parallel: str = "auto"
    lockstep_max_step_bytes: int = 128 << 20
    max_fused_epochs: int = 25
    coo_assembly: str = "device"
    coo_fuse_bytes: int = 1 << 30
    mesh_shape: Tuple[int, int] = (1, 1)
    xla_cache_dir: str = ""

    # -- artifacts --
    epochs_dir: str = "epochs"
    statistics_dir: str = "statistics"
    checkpoint_resume: bool = False
    checkpoint_every: int = 0
    log_every: int = 0
    tensorboard_dir: Optional[str] = None

    def resolved_adj_dtype(self) -> str:
        """Concrete adjacency storage dtype: "auto" → float32 (see module
        docstring)."""
        if self.adj_dtype != "auto":
            return self.adj_dtype
        return "float32"

    def resolved_block_impl(self) -> str:
        """Concrete block propagation kernel: "auto" → "pallas", the CSR
        kernel, which beat the item-parallel kernel on the DD main path at
        both the mean and the largest batch on the H100 (PERF.md, PR 2)."""
        if self.block_impl != "auto":
            return self.block_impl
        return "pallas"

    def resolved_spmm_impl(self) -> str:
        """Concrete COO SpMM kernel: "auto" → "xla", the row-parallel CSR
        kernel, the faster of the two kernels that run on device-assembled
        batches over a DD COO train step on the H100 (PERF.md, PR 3). Like
        the reference's engines, "auto" never attaches block-pair
        structures."""
        if self.spmm_impl != "auto":
            return self.spmm_impl
        return "xla"

    def __post_init__(self):
        if self.data_type not in DATASETS:
            raise ValueError(
                f"unknown data_type {self.data_type!r}; expected one of {DATASETS}"
            )
        if self.spmm_impl not in ("auto", "xla", "onehot", "pallas"):
            raise ValueError(f"unknown spmm_impl {self.spmm_impl!r}")
        if (
            len(self.mesh_shape) != 2
            or any(int(d) < 1 for d in self.mesh_shape)
        ):
            raise ValueError(
                f"mesh_shape must be two positive ints (data, graph); got "
                f"{self.mesh_shape!r}"
            )
        if self.layout not in ("auto", "coo", "dense", "multi", "block",
                               "halo"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.adj_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"unknown adj_dtype {self.adj_dtype!r}")
        if self.block_impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown block_impl {self.block_impl!r}")
        if self.coo_assembly not in ("device", "host"):
            raise ValueError(f"unknown coo_assembly {self.coo_assembly!r}")
        if int(self.multi_dense_min_tile) < 8:
            raise ValueError(
                f"multi_dense_min_tile must be ≥8 (sublane-aligned tile); "
                f"got {self.multi_dense_min_tile!r}"
            )
        if self.cv_parallel not in ("auto", "folds", "sequential"):
            raise ValueError(f"unknown cv_parallel {self.cv_parallel!r}")
        if self.dense_trunk not in ("auto", "xla", "fused"):
            raise ValueError(f"unknown dense_trunk {self.dense_trunk!r}")
        if self.sort_pool_percentile is not None and not (
            0.0 < self.sort_pool_percentile <= 1.0
        ):
            raise ValueError(
                f"sort_pool_percentile must be a fraction in (0, 1], got "
                f"{self.sort_pool_percentile!r}"
            )
