"""On the card: the control (the plain reference in TF32, the precision
below the configurations' float32), put in the program's place, makes the
harness's ``correct`` false where the program's own gaps pass, on each
cell shrunk to a test's size.  Needs a CUDA device and nvcc; skips
without one.  The limits themselves come from control.py's readings at
each cell's own size (PERF.md)."""
import json
import time

import pytest
import torch

from portbench.tests._tiny import patch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the port's kernels)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["mi_stream", "insight_fleet11",
                                  "insight_stream", "mi_replay"])
def test_control_fails_where_the_program_passes(card, cell, capsys):
    from portbench.harness import Harness

    h = Harness(cell, 2 ** 31 + 17, 2.0, False, time.perf_counter(), patch=patch)
    h.control = True
    assert h.run() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert h.readings["program_correct"] is True, h.readings["program"]
    assert line["correct"] is False, h.readings["control"]
