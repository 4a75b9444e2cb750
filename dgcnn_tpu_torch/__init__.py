"""dgcnn_tpu_torch — the PyTorch/CUDA port of dgcnn_tpu for NVIDIA Hopper.

A second package beside `dgcnn_tpu` (the JAX reference, which it never
imports). The module tree mirrors the reference so each counterpart is
found at the same path; inside, the code is PyTorch idiom: `nn.Module`s,
plain functions on tensors, an explicit `device`, explicit
`torch.Generator`s.

The port trains DGCNN on the dense layout through a hand-written CUDA
GCN-trunk kernel (kernels/dense_trunk.py, csrc/dense_trunk.cu) and on the
block-sparse layout through two hand-written CUDA block-propagation
kernels (kernels/block_csr.py, kernels/block_resident.py), and on the COO
layout through three hand-written CUDA SpMM kernels
(kernels/spmm_pallas.py, kernels/spmm_block_coo.py); it resumes a
crashed run from its in-flight bundles (train/cv.py) and classifies
graphs from a fold bundle (infer.py). Entry points
run on `cuda` unless the caller passes `device="cpu"`; on a CPU tensor
every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from dgcnn_tpu_torch.config import DATASETS, Config

__all__ = ["Config", "DATASETS", "__version__"]
