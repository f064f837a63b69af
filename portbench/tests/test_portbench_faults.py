"""The comparison sees a broken timed path: each fault a cell can have,
planted under a tiny CPU run, makes ``correct`` false.  (The exchange
between chips is no fault these one-chip cells can have.)"""
import pytest

from portbench.tests.test_portbench_drivers import tiny

FAULTS = [(c, f) for c in ("mi_stream", "insight_stream", "insight_fleet11",
                           "mi_replay") for f in ("unchanged", "altered")]
FAULTS.append(("insight_fleet11", "half_batch"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_path_is_not_correct(cell, fault):
    line, _, readings, _ = tiny(cell, 0, fault)
    assert line["correct"] is False, readings
