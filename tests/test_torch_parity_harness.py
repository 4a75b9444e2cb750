"""The port's parity tooling against the reference's: the activation
harness (dgcnn_tpu_torch/parity/harness.py) against
dgcnn_tpu/parity/harness.py on the same weights and graphs, COO and dense,
its npz files against the reference's (same keys and shapes, each
package's `compare` reading the other's), the PyG state_dict converters
bitwise against the reference's, and the port's plain-torch oracle bitwise
against the reference's."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dgcnn_tpu.batching import compute_bucket as jax_bucket
from dgcnn_tpu.batching import pack_batch as jax_pack
from dgcnn_tpu.batching.dense import pack_dense_batch as jax_pack_dense
from dgcnn_tpu.data.graphset import GraphSet as JGraphSet
from dgcnn_tpu.models.dgcnn import DGCNN as JDGCNN
from dgcnn_tpu.models.dgcnn import init_params as jax_init
from dgcnn_tpu.parity import convert as jconvert
from dgcnn_tpu.parity import harness as jharness
from dgcnn_tpu.parity import torch_oracle as joracle
from dgcnn_tpu_torch.batching.dense import dense_tile, pack_dense_batch
from dgcnn_tpu_torch.batching.packer import compute_bucket, pack_batch
from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.models.dgcnn import DGCNN
from dgcnn_tpu_torch.parity import convert, harness, torch_oracle
import torch_threads  # noqa: F401  (torch on one CPU thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _jset(gs):
    return JGraphSet(gs.x, gs.node_ptr, gs.edge_src, gs.edge_dst, gs.edge_ptr,
                     gs.y, gs.num_classes)


def _setup(name, seed=7):
    gs = synthesize_tu_dataset(name, num_graphs=N, seed=11)
    kw = dict(num_features=gs.num_features, num_classes=gs.num_classes)
    jm = JDGCNN(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(seed), jm))
    return gs, jm, DGCNN(**kw), jp


def _batches(gs, layout):
    if layout == "coo":
        return (pack_batch(gs, np.arange(N), compute_bucket(gs, N)),
                jax_pack(_jset(gs), np.arange(N), jax_bucket(_jset(gs), N)))
    t = dense_tile(gs)
    return (pack_dense_batch(gs, np.arange(N), t, 8),
            jax_pack_dense(_jset(gs), np.arange(N), t, 8))


@pytest.mark.parametrize("layout", ["coo", "dense"])
@pytest.mark.parametrize("name", ["MUTAG", "NCI1", "DD"])
def test_port_dump_equals_the_references(name, layout):
    gs, jm, tm, jp = _setup(name)
    tb, jb = _batches(gs, layout)
    got = harness.dump_activations(jp, tm, tb, device="cpu")
    want = jharness.dump_activations(jp, jm, jb)
    report = harness.compare_dumps(got, want)
    assert set(report) == {"gcn1", "gcn2", "gcn3", "gcn4", "sort_pool", "log_probs"}
    for k in report:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


def test_dump_takes_port_tensors_and_refuses_a_missing_card():
    gs, _, tm, jp = _setup("MUTAG")
    tb, _ = _batches(gs, "coo")
    params = {"gcn": [{n: torch.tensor(v).requires_grad_() for n, v in layer.items()}
                      for layer in jp["gcn"]],
              **{h: {n: torch.tensor(v) for n, v in jp[h].items()}
                 for h in ("conv5", "conv6", "lin1", "lin2")}}
    a = harness.dump_activations(params, tm, tb, device="cpu")
    b = harness.dump_activations(jp, tm, tb, device="cpu")
    assert all(np.array_equal(a[k], b[k]) for k in a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            harness.dump_activations(jp, tm, tb)


def test_npz_files_have_the_references_keys_and_shapes(tmp_path):
    gs, jm, tm, jp = _setup("NCI1")
    tb, jb = _batches(gs, "coo")
    harness._flat_save(str(tmp_path / "port.npz"), jp, tm,
                       harness.dump_activations(jp, tm, tb, device="cpu"))
    jharness._flat_save(str(tmp_path / "ref.npz"), jp, jm,
                        jharness.dump_activations(jp, jm, jb))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("w_"):
                assert a[k].tobytes() == b[k].tobytes(), k
    harness.compare_dumps(harness._load_acts(str(tmp_path / "port.npz")),
                          jharness._load_acts(str(tmp_path / "ref.npz")))


def _port_cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "dgcnn_tpu_torch.parity.harness", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_cli_dump_then_compare_port_against_the_reference(tmp_path, capsys):
    """The reference's CLI dumps synthetic MUTAG with its seeded weights;
    the port's CLI dumps the same graphs with that dump's weights
    (`--weights`) on the CPU; each package's `compare` passes the pair, and
    fails a pair whose weights differ."""
    ref, port, other = (str(tmp_path / f) for f in ("ref.npz", "port.npz", "other.npz"))
    common = ["--data_type", "MUTAG", "--synthetic", "--num_graphs", "20",
              "--data_root", str(tmp_path / "data")]
    assert jharness.main(["dump", "--out", ref, *common]) == 0
    assert "wrote" in _port_cli("dump", "--out", port, "--weights", ref,
                                "--platform", "cpu", *common)
    assert "PARITY OK" in _port_cli("compare", port, ref)
    capsys.readouterr()
    assert jharness.main(["compare", ref, port]) == 0
    assert "PARITY OK" in capsys.readouterr().out
    assert harness.main(["dump", "--out", other, "--seed", "3", "--platform", "cpu",
                         *common]) == 0
    with pytest.raises(AssertionError):
        harness.main(["compare", other, ref])


def test_pyg_state_round_trips_and_equals_the_references():
    gs, jm, tm, jp = _setup("PROTEINS", seed=2)
    got = convert.params_to_torch_state(jp, tm)
    want = jconvert.params_to_torch_state(jp, jm)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    back = convert.torch_state_to_params(got, tm)
    jback = jconvert.torch_state_to_params(want, jm)
    for a, b, c in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(jback)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes() == np.asarray(c).tobytes()
    # the port's own tensors convert to the same bytes
    state = convert.params_from_jax(jp)
    from_port = convert.params_to_torch_state(convert.state_to_params(state), tm)
    assert all(from_port[k].tobytes() == got[k].tobytes() for k in got)


@pytest.mark.parametrize("name", ["MUTAG", "IMDB-BINARY"])
def test_oracle_equals_the_references_and_the_port_dump(name):
    gs, jm, tm, jp = _setup(name, seed=5)
    state = convert.params_to_torch_state(jp, tm)
    graphs = torch_oracle.graphs_from_graphset(gs)
    jgraphs = joracle.graphs_from_graphset(_jset(gs))
    assert all(a.tobytes() == b.tobytes() for g, h in zip(graphs, jgraphs)
               for a, b in zip(g, h))
    got = torch_oracle.forward_activations(state, graphs)
    want = joracle.forward_activations(state, jgraphs)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].tobytes() == want[k].tobytes(), k
    tb, _ = _batches(gs, "coo")
    harness.compare_dumps(harness.dump_activations(jp, tm, tb, device="cpu"), got)


def test_train_trajectory_equals_the_references():
    gs, jm, tm, jp = _setup("MUTAG", seed=1)
    state = convert.params_to_torch_state(jp, tm)
    graphs = torch_oracle.graphs_from_graphset(gs)
    losses, final = torch_oracle.train_trajectory(state, graphs, gs.y, num_steps=2)
    jlosses, jfinal = joracle.train_trajectory(state, graphs, gs.y, num_steps=2)
    assert losses.tobytes() == jlosses.tobytes()
    assert all(final[k].tobytes() == jfinal[k].tobytes() for k in final)
