"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_config_keeps_a_cell_and_every_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}

    def e2e_in(cell):
        return [n for n, m in e2e.items() if cell in m.get("workloads", cells)]

    for cell in cells:
        assert "setup_s" in e2e_in(cell) and len(e2e_in(cell)) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    w = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    entry = next(x for x in BENCH["workloads"] if x["name"] == cell)
    assert (w["config"], w["traffic"], w["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert set(w["limits"]) == {"sigma_gap", "mean_gap"}
    cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    c = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert c["file"] == f"portbench/configs/{w['config']}.json"
    assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert (HERE / "drivers" / f"{traffic['driver']}.py").exists()


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert (HERE / "metrics" / f"{metric}.py").exists()
