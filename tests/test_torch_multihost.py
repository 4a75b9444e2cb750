"""The CLI's multi-host flags on the port (dgcnn_tpu_torch/cli.py →
parallel/mesh.py `initialize_multihost`): two real processes join one
`gloo` group over localhost through `--multihost --coordinator`, and
again through torchrun's environment (env://), and train synthetic
MUTAG on a (1, 2) grid; rank 0 alone writes the run's files and both
ranks print the same summary. In process: `initialize_multihost`'s
backend choice, its no-op on an initialised group and its propagated
failures, and a `--mesh` of several ranks without a group. Mirrors
tests/test_multihost.py."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from dgcnn_tpu_torch import cli
from dgcnn_tpu_torch.parallel import mesh
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds for both processes together


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two(tmp_path, argv_of, env_of):
    common = ["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
              "--num_folds", "2", "--num_epochs", "1", "--mesh", "1,2",
              "--layout", "coo", "--data_root", str(tmp_path / "data"),
              "--out_root", str(tmp_path / "out")]
    procs = []
    for r in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", **env_of(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dgcnn_tpu_torch.cli", *common, *argv_of(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                        .decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    summaries = [[line for line in out.splitlines() if line.startswith("Overall")]
                 for out in outs]
    assert summaries[0] and summaries[0] == summaries[1]
    stats = tmp_path / "out" / "statistics"
    assert (stats / "MUTAG_results_overall.csv").exists()
    assert (tmp_path / "out" / "epochs" / "MUTAG_2.npz").exists()
    assert '"mesh_shape": [1, 2]' in (stats / "MUTAG_events.jsonl").read_text()


def test_two_processes_through_the_coordinator_flags(tmp_path):
    coord = f"localhost:{_free_port()}"
    _run_two(tmp_path,
             lambda r: ["--multihost", "--coordinator", coord, "--num_processes", "2",
                        "--process_id", str(r)],
             lambda r: {})


def test_two_processes_through_torchruns_environment(tmp_path):
    port = str(_free_port())
    _run_two(tmp_path, lambda r: [],
             lambda r: {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
                        "MASTER_ADDR": "localhost", "MASTER_PORT": port})


def test_a_mesh_of_several_ranks_without_a_group_says_how_to_launch(tmp_path):
    with pytest.raises(RuntimeError, match="needs 4 processes.*torchrun"):
        cli.main(["--data_type", "MUTAG", "--synthetic", "--platform", "cpu",
                  "--mesh", "2,2", "--out_root", str(tmp_path)])


def test_initialize_multihost_picks_the_backend_and_init_method(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    mesh.initialize_multihost("h:1", 4, 2, device="cpu")
    mesh.initialize_multihost(device="cuda:0")
    mesh.initialize_multihost(backend="gloo")
    assert calls == [
        ("gloo", {"init_method": "tcp://h:1", "world_size": 4, "rank": 2}),
        ("nccl", {"init_method": "env://"}),
        ("gloo", {"init_method": "env://"}),
    ]
    with pytest.raises(ValueError, match="--num_processes and --process_id"):
        mesh.initialize_multihost("h:1", device="cpu")


def test_initialize_multihost_is_a_no_op_once_initialised(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("init_process_group called on an initialised group")

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group", refuse)
    mesh.initialize_multihost("h:1", 2, 0)


def test_initialize_multihost_propagates_every_other_failure(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="connection refused"):
        mesh.initialize_multihost("h:1", 2, 0, backend="nccl")


def test_the_cli_maps_the_flags_onto_initialize_multihost(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(mesh, "initialize_multihost",
                        lambda *a, **k: seen.update(args=a, kw=k))
    monkeypatch.setattr(cli, "run_cross_validation", lambda cfg, **k: seen.update(
        mesh=cfg.mesh_shape, device=k["device"]))
    cli.main(["--data_type", "MUTAG", "--platform", "cpu", "--multihost",
              "--coordinator", "h:9", "--num_processes", "1", "--process_id", "0",
              "--out_root", str(tmp_path)])
    assert seen == {"args": ("h:9", 1, 0), "kw": {"device": "cpu"}, "mesh": (1, 1),
                    "device": "cpu"}
