"""BENCHMARK.json against the contract's shape rules, and every name it
holds found as a file of the benchmark."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_every_cell_reports_setup_and_another_end_to_end_metric(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for c in cells:
        names = {m["name"] for m in bench["end_to_end"] if c in m.get("workloads", cells)}
        assert "setup_s" in names and len(names) >= 2, c
    for m in bench["per_layer"]:
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells)), m["name"]


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_cells_find_their_files(bench, kind):
    for w in bench["workloads"]:
        name = {"configs": w["config"], "traffic": w["traffic"], "limits": w["name"]}[kind]
        path = os.path.join(HERE, kind, name + ".json")
        with open(path) as f:
            json.load(f)
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_metrics_find_their_readers(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]
        assert set(m.get("workloads", cells)) <= cells


def test_every_per_layer_metric_lists_its_cells(bench):
    """A metric without a list would have to be reported by every cell,
    those later PRs add too."""
    for m in bench["per_layer"]:
        assert m.get("workloads"), m["name"]


def test_every_config_finds_its_family(bench):
    from benchmark import family
    from benchmark.inputs import load_config

    for c in bench["configs"]:
        fam = family.of(load_config(c["name"]))
        for name in ("Graphs", "follow", "evaluate", "FAULTS", "leaf_shapes"):
            assert hasattr(fam.reference, name), (c["name"], name)
        assert hasattr(fam.work, "fold_epoch"), c["name"]
        for name in ("config_fields", "model", "net", "folds_net"):
            assert hasattr(fam.program, name), (c["name"], name)


# a cell's `why` names its layout and fold schedule in these words, where
# it does
LAYOUT_WORDS = {"multi-tile": "multi", "block": "block", "coo": "coo", "dense": "dense"}


def _named(why: str):
    """(layout, lockstep) as the words of `why` name them, None where not."""
    text = why.lower()
    layout = next((v for k, v in LAYOUT_WORDS.items() if k in text), None)
    lockstep = (False if "one after another" in text
                else True if "lockstep" in text else None)
    return layout, lockstep


def test_every_cell_runs_the_layout_its_why_names(bench):
    """At the cell's own size the traffic resolves, as the program decides
    it, to the layout and fold schedule the cell's `why` names."""
    from dgcnn_tpu_torch.train import cv

    from benchmark import drive, harness
    from benchmark.inputs import make_inputs

    for w in bench["workloads"]:
        cfg, traffic = harness.cell_files(w["name"])
        inp = make_inputs(cfg, 2147483659, "cpu")
        pcfg, ds = drive.program_config(cfg, traffic, inp.seed), drive.graph_set(inp)
        layout = cv.choose_layout(pcfg, ds)
        got = (layout, cv.lockstep_engages(pcfg, ds, layout))
        for want, have in zip(_named(w["why"]), got):
            assert want is None or want == have, (w["name"], got)


def test_limits_name_known_numbers(bench):
    from benchmark.check import NAMES

    for w in bench["workloads"]:
        with open(os.path.join(HERE, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        assert limits and set(limits) <= set(NAMES)
