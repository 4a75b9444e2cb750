"""The (data, graph) process grid — the port of dgcnn_tpu/parallel/mesh.py
(`device_grid` :28, `make_mesh` :37, `initialize_multihost` :44).

The reference names a 2-D mesh of devices inside one program, axes

    "data"  — data parallelism over the sub-batches of one global batch
    "graph" — edge partitioning within a sub-batch: each device owns a
              contiguous slice of the batch's edge stream and one sum per
              GCN layer rebuilds the full aggregate.

The port has one process per device (`torch.distributed`), so the mesh is
a grid of D × G ranks: rank r sits at (d, g) = divmod(r, G), the
reference's row-major reshape of its device list. `ProcessGrid` hands a
rank its `d`, `g`, its device and the two groups it sums over: the data
group (the D ranks of its column, same g) and the graph group (the G
ranks of its row, same d). The mesh path's collectives are `all_reduce`,
`broadcast` (and the barrier), and the halo layout's point-to-point
exchange (parallel/halo.py), which `gloo` serves on CPU tensors only: on
CUDA tensors under `gloo` the exchange is an `all_reduce` instead.

Under `nccl` on a CUDA device (`ProcessGrid.graphed`) the mesh engines
capture each epoch, collectives included, in a CUDA graph, as the
single-device engines do; a `gloo` collective cannot be captured, so
under `gloo` every epoch runs eagerly.

Deliberate divergence: the reference takes the first D·G devices of its
one process and ignores the rest; here every rank is a device, so a world
size other than D·G raises.

The backend is `nccl` for CUDA devices and `gloo` for the CPU;
`initialize_multihost(backend=...)` takes another only for a run of
several ranks on one card (nccl refuses two ranks on one GPU). A failed
init raises: there is no fall back to another backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_HINT = (
    "launch one process per device, e.g. `torchrun --nproc_per_node N -m "
    "dgcnn_tpu_torch.cli --mesh D,G ...` (N = D·G), or pass --multihost "
    "--coordinator HOST:PORT --num_processes N --process_id R on each host"
)


def device_grid(shape: Tuple[int, int], world_size: Optional[int] = None) -> np.ndarray:
    """The ranks of a (D, G) grid, [D, G] row-major: rank d·G + g at (d, g).
    `world_size` (default: the initialised group's, else 1) must be D·G."""
    d, g = (int(v) for v in shape)
    if d < 1 or g < 1:
        raise ValueError(f"mesh shape must be two positive ints, got {shape}")
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if world_size != d * g:
        raise ValueError(
            f"mesh {tuple(shape)} needs exactly {d * g} ranks, the process group "
            f"has {world_size}: the port runs one process per device ({LAUNCH_HINT})")
    return np.arange(d * g).reshape(d, g)


@dataclasses.dataclass
class ProcessGrid:
    """One rank's view of the (data, graph) grid. `data_group` and
    `graph_group` are None without an initialised process group (one
    rank, nothing to sum); `backend` is the process group's ("nccl",
    "gloo"), None without one."""

    shape: Tuple[int, int]
    rank: int
    device: torch.device
    data_group: Optional[object] = None
    graph_group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def d(self) -> int:
        return self.rank // self.shape[1]

    @property
    def g(self) -> int:
        return self.rank % self.shape[1]

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_graph(self) -> int:
        return self.shape[1]

    @property
    def graphed(self) -> bool:
        """Whether the mesh engines run each epoch as a CUDA-graph replay:
        on a CUDA device whose collectives run on `nccl` (or with no
        process group: nothing to exchange). A `gloo` collective cannot be
        captured, so under `gloo` the epochs run eagerly."""
        return self.device.type == "cuda" and self.backend in (None, "nccl")

    @property
    def writer(self) -> bool:
        """Rank 0 alone writes the run's files."""
        return self.rank == 0

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()

    def check_replicas(self, tensors, what: str) -> None:
        """Raise unless every rank holds `tensors` bitwise equal: one
        all-reduce (max) over all ranks of a position-weighted sum of
        their bytes and of its negation; a no-op without a process group."""
        if not dist.is_initialized():
            return
        b = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
        w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 65521 + 1
        d = (b.to(torch.int64) * w).sum()
        m = torch.stack([d, -d])
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        if m[0] != -m[1]:
            raise RuntimeError(f"the ranks' replicas differ: {what}")


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """`t` summed in place over `group`'s ranks (no-op for None)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast_from(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` overwritten in place with rank `src`'s (a global rank of
    `group`; no-op for None)."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The rank's device: `cuda:LOCAL_RANK` (torchrun's variable; else the
    rank modulo the cards) unless the caller names one; "cpu" runs the
    plain path."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", _local_rank(rank))
    else:
        dev = torch.device("cuda", _local_rank(rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (CLI: "
                               "--platform cpu) to run the mesh on the CPU")
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(n, 1)


def make_mesh(shape: Tuple[int, int] = (1, 1), device=None) -> ProcessGrid:
    """This rank's `ProcessGrid` over the initialised process group. A
    grid of more than one rank needs `initialize_multihost` (or any
    `init_process_group`) first; every rank must call this in the same
    order, since it creates the grid's groups (`new_group`). Without a
    process group a (1, 1) grid runs alone, with no groups."""
    shape = (int(shape[0]), int(shape[1]))
    n = shape[0] * shape[1]
    if not dist.is_initialized():
        if n > 1:
            raise RuntimeError(f"mesh {shape} needs {n} processes and no process "
                               f"group is initialised: {LAUNCH_HINT}")
        return ProcessGrid(shape, 0, rank_device(device, 0))
    ranks = device_grid(shape)
    rank = dist.get_rank()
    dev = rank_device(device, rank)
    # every rank creates every group, in one order (new_group's contract)
    data_groups = [dist.new_group(ranks[:, g].tolist()) for g in range(shape[1])]
    graph_groups = [dist.new_group(ranks[d, :].tolist()) for d in range(shape[0])]
    d, g = divmod(rank, shape[1])
    return ProcessGrid(shape, rank, dev, data_groups[g], graph_groups[d],
                       str(dist.get_backend()))


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device=None) -> None:
    """Join the run's process group: `tcp://coordinator` with the given
    world size and rank, else `env://` (torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT). `backend` defaults to nccl, or gloo when
    `device` is the CPU. An already initialised group is a no-op; every
    other failure propagates — a swallowed bad-coordinator error would let
    each process train its own replica with no warning."""
    if dist.is_initialized():
        return
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
