"""Everything BENCHMARK.json names is found by name, within the contract's
limits on names, units and bounds."""

import importlib
import json
import re

import pytest

from benchmark import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found(cell):
    spec = run.cell_spec(cell["name"], BENCH)
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    model = importlib.import_module(
        f"benchmark.models.{spec['config']['model']}")
    for fn in ("make_pool", "pipeline", "check", "control"):
        assert callable(getattr(model, fn))
    assert {"nsims", "pool", "check_pipelines"} <= set(spec["traffic"])
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((run.ROOT / conf["file"]).read_text())
    assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert set(cfg["limits"]) >= {"score_gap", "theta_gap", "J_gap",
                                  "H_gap", "sigma_gap", "map_grad"}
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        return
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(run._metric_reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_every_cell_reports_a_per_layer_metric_and_setup():
    for w in BENCH["workloads"]:
        spec = run.cell_spec(w["name"], BENCH)
        assert spec["per_layer"] and spec["end_to_end"]
