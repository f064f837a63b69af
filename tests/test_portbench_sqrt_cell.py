"""The benchmark's square-root-form replay cell (``mi_sqrt_replay``: driver
``portbench/drivers/replay_sqrt.py``) in a tiny CPU run
(``portbench/tests/_tiny_sqrt.py``, each in its own process): the result
line the driver reads, with nothing of JAX loaded and no device metric
written on the CPU; and a broken timed path, a factor left unchanged by
every step or a pose moved 1 mm where a step produces it, reads
``correct`` false."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELL = "mi_sqrt_replay"


def tiny(trace=0, fault=None, timeout=600):
    """(result line, modules found, readings) of one tiny run."""
    cmd = [sys.executable, str(ROOT / "portbench" / "tests" / "_tiny_sqrt.py"),
           CELL, str(trace)] + ([fault] if fault else [])
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    extra = json.loads(lines[-1])
    return json.loads(lines[-2]), extra["forbidden"], extra["readings"]


@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_run_prints_the_result_line(trace):
    line, forbidden, readings = tiny(trace)
    assert line["correct"] is True and line["attempted"] > 0, readings
    assert set(line["compared"]) == {"sigma_gap", "mean_gap"}
    if trace:
        assert line["metrics"] == {}   # no device number from a CPU run
    else:
        assert set(line["metrics"]) == {"offline_fps", "setup_s"}
    assert forbidden == []


@pytest.mark.parametrize("fault", ("unchanged", "altered"))
def test_a_broken_path_is_not_correct(fault):
    line, _, readings = tiny(0, fault)
    assert line["correct"] is False, readings
