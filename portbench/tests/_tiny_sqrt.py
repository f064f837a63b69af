"""``_tiny.py`` for the square-root-form replay cell: its driver
(``replay_sqrt``) shrunk as ``_tiny.py`` shrinks ``replay``, the same
faults.  Run as a script it prints the result line, then one line of the
modules it found loaded and the readings:

    python3 portbench/tests/_tiny_sqrt.py <cell> <trace 0|1> [fault]
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.tests import _tiny  # noqa: E402

SHRUNK_AS = {"replay_sqrt": "replay"}


def patch(h):
    """``_tiny.patch`` with the driver read as the one it is shrunk as; the
    profiled call long enough to hold the VI initialization."""
    driver = h.traffic["driver"]
    h.traffic["driver"] = SHRUNK_AS[driver]
    _tiny.patch(h)
    h.traffic["driver"] = driver
    h.traffic["profile_frames"] = int(h.config["vio"]["vi_init_frames"]) + 3


def main(argv) -> int:
    import torch

    from portbench.harness import Harness, forbidden_modules

    torch.set_num_threads(2)
    workload, trace = argv[0], bool(int(argv[1]))
    if len(argv) > 2:
        _tiny.break_path(argv[2])
    h = Harness(workload, _tiny.SEED, 2.0, trace, time.perf_counter(),
                require_card=False, patch=patch)
    rc = h.run()
    print(json.dumps({"forbidden": forbidden_modules(),
                      "readings": getattr(h, "readings", None)}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
