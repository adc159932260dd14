"""BENCHMARK.json against the contract it is written to, and the files the
harness finds by its names."""
import json
import re

import pytest

from bench.lib import harness

B = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"] and B["command"][1] == "bench/run.py"
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + [w["name"] for w in B["workloads"]]
                         + [c["name"] for c in B["configs"]]
                         + [w["traffic"] for w in B["workloads"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_keys(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    allowed |= {"bound"} if metric in B["end_to_end"] else {"layer", "moves"}
    assert set(metric) <= allowed
    if metric in B["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")


def test_unique_names():
    for group in (METRICS, B["workloads"], B["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


def reports(cell, e2e_name):
    m = {x["name"]: x for x in B["end_to_end"]}[e2e_name]
    return harness.applies(m, cell)


@pytest.mark.parametrize("metric", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    cells = metric.get("workloads", [w["name"] for w in B["workloads"]])
    for cell in cells:
        assert reports(cell, metric["moves"]), (metric["name"], cell)
    assert (harness.BENCH / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in B["end_to_end"] if harness.applies(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(harness.applies(m, cell["name"]) for m in B["per_layer"])
    assert cell["chips"] == 1
    _, c, tr = harness.cell_files(cell["name"])
    assert (harness.BENCH / "drivers" / f"{tr['driver']}.py").exists()
    assert (harness.BENCH / "models" / f"{c['model_type']}.py").exists()


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    c = json.loads((harness.ROOT / conf["file"]).read_text())
    assert c["name"] == conf["name"] and c["reduced"] == conf["reduced"]
    assert conf["file"].startswith("bench/")
    used = [w for w in B["workloads"] if w["config"] == conf["name"]]
    assert used
    assert set(c["limits"]) and all(isinstance(v, (int, float)) for v in c["limits"].values())


def test_layers_one_name_each():
    """Metrics of one layer name it letter for letter alike."""
    by_mod = {}
    for m in B["per_layer"]:
        by_mod.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_mod.values())


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
