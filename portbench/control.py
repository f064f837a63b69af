#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's gaps and its
control's, on several seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control 2]

For each seed, one run of the cell as ``run.py`` makes it (same set-up,
window and comparison, result line included).  On the first ``--control``
seeds (all by default) the control runs beside the comparison: the plain
reference computed with TF32 matmuls and convolutions (the precision
below the configuration's float32), from the same states and inputs as
the reference it is held against, and it stands in the program's place,
so that run's ``correct`` says whether the control passes.  Prints one
JSON line a seed, after all runs: ``{"seed", "program_correct",
"control_correct", "program": {gap: value}, "control": {gap: value}}``.
The benchmark's own runs never run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import Harness, cache_env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", type=int, default=None,
                   help="how many of the first seeds run the control")
    args = p.parse_args(argv)
    cache_env()
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control is None else args.control
    rows = []
    for i, seed in enumerate(seeds):
        h = Harness(args.workload, seed, args.seconds, False, time.perf_counter())
        h.control = i < n_control
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = h.run()
        sys.stdout.write(buf.getvalue())
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        row = dict(seed=seed, rc=rc, program_correct=h.readings["program_correct"],
                   **{k: v for k, v in h.readings.items() if k != "program_correct"})
        if h.control:
            row["control_correct"] = line["correct"]
        rows.append(row)
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
