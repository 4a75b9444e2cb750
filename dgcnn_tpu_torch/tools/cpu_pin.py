"""The CPU side of the card-vs-CPU checks, pinned.

The CPU's bits for one batch depend on torch's intra-op thread count and
on MKL's code path (its conditional numerical reproducibility branch),
and neither is the same on every host. chip_smoke.py and
tools/probe_repeat.py's child processes run the CPU side at `THREADS`
threads and `MKL_CBWR`: `pin_environ` sets both in an environment before
torch loads there (a process started with it inherits them) and
`describe` reports what the process runs at. MKL reads `MKL_CBWR` once,
when it first runs, so it must be set before torch is imported.

This module imports nothing at load time, so that a script can pin before
its first `import torch`.
"""

from __future__ import annotations

import os

THREADS = 8  # torch's default on an 8-core host of an H100
MKL_CBWR = "AVX2"  # a branch every x86 host of an H100 runs; ignored without MKL


def pin_environ(env=None):
    """`env` (default `os.environ`) with the pinned thread count and MKL
    branch set; returns it."""
    env = os.environ if env is None else env
    env["OMP_NUM_THREADS"] = str(THREADS)
    env["MKL_NUM_THREADS"] = str(THREADS)
    env["MKL_CBWR"] = MKL_CBWR
    return env


def describe() -> str:
    """This process's CPU side: torch's threads, `MKL_CBWR`, the MKL torch
    was built with and ATen's CPU code path."""
    import torch

    mkl = next((line.strip(" -") for line in torch.__config__.show().splitlines()
                if "Math Kernel Library" in line), "no MKL")
    return (f"{torch.get_num_threads()} torch threads, MKL_CBWR="
            f"{os.environ.get('MKL_CBWR', 'unset')} ({mkl}), ATen CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}")
