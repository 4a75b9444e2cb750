"""Imported by every `test_torch_*.py`: torch's CPU ops run on one thread.

Tier-1 runs the suite in six pytest workers on one host, and each
worker's torch would otherwise start an intra-op thread pool as wide as
the host. The pools then oversubscribe the cores: one chunked-epoch case
of `test_torch_fused_sparse.py` took 138 s with six copies running at
once, against 6 s with one thread each (8-core host). One thread changes
what runs where, never what is checked."""

import torch

torch.set_num_threads(1)
