"""A tiny CPU run of each driver prints the result line the driver reads;
a run without a card fails; nothing JAX is loaded."""
import json
import subprocess
import sys

import pytest

from portbench.harness import forbidden_modules
from portbench.tests._tiny import ROOT

CELLS = ["mi_stream", "insight_fleet11", "insight_stream", "mi_replay"]


def tiny(cell, trace=0, fault=None, timeout=420):
    """Run ``_tiny.py`` in its own process: (result line, modules found,
    readings)."""
    cmd = [sys.executable, str(ROOT / "portbench" / "tests" / "_tiny.py"),
           cell, str(trace)] + ([fault] if fault else [])
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    extra = json.loads(lines[-1])
    return json.loads(lines[-2]), extra["forbidden"], extra["readings"], p.stderr


@pytest.mark.parametrize("cell,trace", [(c, 0) for c in CELLS]
                         + [("insight_stream", 1), ("insight_fleet11", 1)])
def test_tiny_run_prints_the_result_line(cell, trace):
    line, forbidden, readings, err = tiny(cell, trace)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared"
    assert set(keys) == {"correct", "attempted", "failed", "metrics", "device",
                         "compared"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["compared"]) == {"sigma_gap", "mean_gap"}
    # stderr closes with each compared number beside its limit
    tail = err.strip().splitlines()[-2:]
    assert all(t.startswith("compared ") and " limit " in t for t in tail)
    if not trace:
        assert "setup_s" in line["metrics"]
    else:
        # a CPU run writes no number under a device metric
        assert line["metrics"] == {}
    assert forbidden == []


def test_without_a_card_the_run_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "mi_stream", "--seed", str(2 ** 31 + 5), "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "CUDA" in p.stderr
    assert p.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "ekf_vio_tpu_torchx", types.ModuleType("x"))
    assert "ekf_vio_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "ekf_vio_tpu.core", types.ModuleType("y"))
    assert "ekf_vio_tpu" in forbidden_modules()
