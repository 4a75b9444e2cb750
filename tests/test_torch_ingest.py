"""Real-data ingestion on the port (dgcnn_tpu_torch/tools/fetch_datasets.py,
dress_rehearsal.py) against the reference's tools: a TU zip made from the
synthetic profile, ingested by both packages' `fetch_datasets
--from_zip`, gives byte-equal caches; a bad archive and a stats mismatch
raise the reference's errors; the dress rehearsal's round trip is byte
for byte and its `--train` runs the port's CLI. No test downloads."""

import contextlib
import io
import os
import zipfile

import pytest

from dgcnn_tpu_torch.data.synthetic import synthesize_tu_dataset
from dgcnn_tpu_torch.tools import dress_rehearsal, fetch_datasets
from tools import fetch_datasets as jax_fetch
import torch_threads  # noqa: F401  (torch on one CPU thread)


@pytest.fixture(scope="module")
def mutag_zip(tmp_path_factory):
    """Synthetic MUTAG at its published size, zipped as TU-Dortmund zips it."""
    d = tmp_path_factory.mktemp("zip")
    return dress_rehearsal.make_tu_zip(synthesize_tu_dataset("MUTAG"), "MUTAG", str(d))


def _fetch(mod, argv):
    """`mod.main(argv)` → (exit code, what it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def test_from_zip_gives_the_references_cache_bytes(tmp_path, mutag_zip):
    caches = []
    for mod, sub in ((fetch_datasets, "port"), (jax_fetch, "jax")):
        rc, out = _fetch(mod, ["--root", str(tmp_path / sub), "--from_zip", mutag_zip])
        assert rc == 0
        assert "MUTAG: verified (188 graphs, 2 classes, 8 features)" in out
        cache = tmp_path / sub / "MUTAG" / "processed" / "MUTAG.npz"
        caches.append(cache.read_bytes())
        assert not (tmp_path / sub / "MUTAG" / "_extract").exists()
    assert caches[0] == caches[1]
    # raw files in place: the second call parses them again, touching nothing else
    rc, out = _fetch(fetch_datasets, ["--root", str(tmp_path / "port"), "MUTAG"])
    assert rc == 0 and "MUTAG: raw files already present" in out
    cache = tmp_path / "port" / "MUTAG" / "processed" / "MUTAG.npz"
    assert cache.read_bytes() == caches[0]


def _bad_zip(path, members):
    with zipfile.ZipFile(path, "w") as z:
        for name in members:
            z.writestr(name, "1, 2\n")
    return str(path)


@pytest.mark.parametrize("members", [
    ["MUTAG_A.txt", "MUTAG_graph_indicator.txt", "MUTAG_graph_labels.txt"],
    ["MUTAG/MUTAG_A.txt"],
], ids=["no_top_level_directory", "missing_tu_files"])
def test_a_bad_archive_raises_the_references_error(tmp_path, members):
    bad = _bad_zip(tmp_path / "MUTAG.zip", members)
    errors = []
    for mod, sub in ((fetch_datasets, "port"), (jax_fetch, "jax")):
        with pytest.raises(ValueError) as e:
            _fetch(mod, ["--root", str(tmp_path / sub), "--from_zip", bad])
        errors.append(str(e.value))
        assert not (tmp_path / sub / "MUTAG" / "_extract").exists()
    assert errors[0] == errors[1] and bad in errors[0]


def test_a_stats_mismatch_raises_the_references_error(tmp_path):
    short = dress_rehearsal.make_tu_zip(synthesize_tu_dataset("MUTAG", num_graphs=100),
                                        "MUTAG", str(tmp_path))
    errors = []
    for mod, sub in ((fetch_datasets, "port"), (jax_fetch, "jax")):
        with pytest.raises(ValueError) as e:
            _fetch(mod, ["--root", str(tmp_path / sub), "--from_zip", short])
        errors.append(str(e.value))
        assert not (tmp_path / sub / "MUTAG" / "processed").exists()
    assert errors[0] == errors[1] and "'num_graphs': 100" in errors[0]


def test_argument_errors_are_the_references(tmp_path, mutag_zip):
    unknown = ["--root", str(tmp_path), "NOPE"]
    assert _fetch(fetch_datasets, unknown) == _fetch(jax_fetch, unknown)
    assert _fetch(fetch_datasets, unknown)[0] == 1
    for argv in ([], ["--from_zip", mutag_zip, "MUTAG", "NCI1"]):
        for mod in (fetch_datasets, jax_fetch):
            with pytest.raises(SystemExit):
                _fetch(mod, argv)


def test_dress_rehearsal_round_trip_and_cli(tmp_path, capsys):
    root = tmp_path / "data"
    assert dress_rehearsal.main(["--name", "MUTAG", "--root", str(root), "--train",
                                 "--num_epochs", "1", "--platform", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"round_trip": "byte_identical"' in line and '"graphs": 188' in line
    assert '"cli": "Overall Training Accuracy: ' in line
    assert (root / "MUTAG" / "processed" / "MUTAG.npz").exists()


def test_dress_rehearsal_without_a_card_raises_before_writing(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dress_rehearsal.run("MUTAG", str(tmp_path / "data"), train=True)
    assert not os.path.exists(tmp_path / "data")
