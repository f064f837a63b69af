"""A cell shrunk to a CPU-sized run, for the tests: the harness's look
for a card skipped, the camera halved, a few frames, the plain versions of
the kernels.  Run as a script it prints the result line, then one line of
the modules it found loaded and the readings:

    python3 portbench/tests/_tiny.py <cell> <trace 0|1> [fault]

``fault`` breaks the timed path underneath: ``unchanged`` (a step returns
the state it was given), ``altered`` (a step's pose is moved by 1 mm where
it is produced), ``half_batch`` (half of the lanes left out, their
outputs and states the mean over the rest).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

SEED = 2 ** 31 + 4242


def patch(h):
    c = h.config["camera"]
    for k in ("width", "height"):
        c[k] = c[k] // 2
    for k in ("fx", "fy", "cx", "cy"):
        c[k] = c[k] / 2.0
    t = h.traffic
    t["scene"]["texture_px"] = 768
    t["scene"]["texture_px_per_m"] = 160.0
    t["frames"] = {"stream": 16, "fleet": 8, "replay": 15}[t["driver"]]
    t.update(sessions=2, sample_steps=100, lanes=4, compare_frames=3, follow_frames=1,
             profile_frames=3, profile_lead_s=1.0, eager_steps=3)


def break_path(fault: str) -> None:
    import torch

    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.parallel import batched_engine

    real = engine.step
    if fault == "unchanged":
        def step(es, *a, **k):
            return es, real(es, *a, **k)[1]
        engine.step = step
    elif fault == "altered":
        def step(es, *a, **k):
            es, out = real(es, *a, **k)
            bump = torch.zeros_like(out.base_mu)
            bump[..., 0] = 1e-3
            es.filt = es.filt.replace(base_mu=es.filt.base_mu + bump)
            return es, out._replace(base_mu=out.base_mu + bump)
        engine.step = step
    elif fault == "half_batch":
        run = batched_engine.run_sequences_batched

        def half(images, times, *a, **k):
            b = images.shape[0] // 2
            es, outs = run(images[:b], times[:b], *a, **k)

            def fill(x):
                m = x.to(torch.float64).mean(0, keepdim=True)
                m = m.round() if not x.is_floating_point() else m
                return torch.cat([x, m.to(x.dtype).expand_as(x)], 0)

            from torch.utils import _pytree

            return (_pytree.tree_map(fill, es),
                    type(outs)(*(fill(x) for x in outs)))
        batched_engine.run_sequences_batched = half
    else:
        raise ValueError(fault)


def main(argv) -> int:
    import torch

    from portbench.harness import Harness, forbidden_modules

    torch.set_num_threads(2)
    workload, trace = argv[0], bool(int(argv[1]))
    if len(argv) > 2:
        break_path(argv[2])
    h = Harness(workload, SEED, 2.0, trace, time.perf_counter(),
                require_card=False, patch=patch)
    rc = h.run()
    print(json.dumps({"forbidden": forbidden_modules(),
                      "readings": getattr(h, "readings", None)}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
