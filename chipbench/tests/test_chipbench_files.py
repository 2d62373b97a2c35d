"""BENCHMARK.json and the files it names: each cell's configuration,
traffic driver and per-layer readers are found by name, and every name,
unit and bound is within the contract's limits."""
import json
import pathlib
import re

import pytest

from chipbench import harness, reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "chipbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]])
def test_names_in_allowed_characters(name):
    assert NAME.match(name)


def test_names_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [m["name"] for m in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for c in m.get("workloads", ()):
        assert c in CELLS
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w, cfg = harness.load_cell(cell)
    entry = next(e for e in BENCH["workloads"] if e["name"] == cell)
    assert w["config"] == entry["config"] == cfg["name"]
    assert w["chips"] == entry["chips"] == 1
    assert w["why"] == entry["why"] and len(w["why"]) <= 200
    assert harness.driver_for(w)
    for fn in ("setup", "window", "end_to_end", "free", "check",
               "control"):
        assert callable(getattr(harness.driver_for(w), fn))
    assert set(w["limits"]) and all(v > 0 for v in w["limits"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    from chipbench.run import cell_metrics
    e2e, layer = cell_metrics(cell, BENCH)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in layer:          # each moves an end-to-end metric of the cell
        assert m["moves"] in names


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_found_by_name(m):
    assert callable(harness.reader_for(m["name"]))


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = ROOT / c["file"]
    assert path.is_file() and c["file"].startswith("chipbench/")
    cfg = json.loads(path.read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    reference.set_precision(cfg)        # a precision the runs implement
    for l in cfg["layers"]:
        assert set(l) >= {"name", "C", "Cout", "H", "W", "k", "pad"}


def test_layer_names_match_one_spelling():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("change", [{"dtype": "bfloat16"}, {"tf32": True},
                                    {"dtype": None}])
def test_unimplemented_precision_refused(change):
    cfg = dict(harness.load_json("configs", "vgg16-t1"), **change)
    with pytest.raises(ValueError):
        reference.set_precision(cfg)
