"""Evidence that a distributed op really ran distributed.

Port of ``ekf_vio_tpu/parallel/evidence.py``.  The JAX module reads the
compiled XLA executable: the collective ops of its optimized HLO and its
memory analysis.  A torch program has no HLO; the same two facts come
from what ran:

* ``collective_inventory(fn)``: the c10d collectives a
  ``torch.profiler`` trace (CPU activity) records while ``fn`` runs,
  counted by kind;
* ``memory_analysis(s)``: the bytes of this rank's Σ blocks against a
  replicated D x D covariance.
"""
from __future__ import annotations

import re

from torch.profiler import ProfilerActivity, profile

# kind -> pattern on the c10d op name with its underscores removed
# (c10d::_allgather_base_, c10d::alltoall_base_, c10d::allreduce_,
# c10d::_reduce_scatter_base_, c10d::broadcast_, ...)
COLLECTIVES = {
    "all-gather": "allgather",
    "all-to-all": "alltoall",
    "all-reduce": "allreduce",
    "reduce-scatter": "reducescatter",
    "broadcast": "broadcast",
}


def collective_inventory(fn) -> dict:
    """Run ``fn`` once under the profiler; count its c10d collectives by
    kind, plus ``total``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = dict.fromkeys(COLLECTIVES, 0)
    for e in prof.events():
        if not e.name.startswith("c10d::"):
            continue
        op = re.sub("_", "", e.name[len("c10d::"):])
        for kind, pat in COLLECTIVES.items():
            if pat in op:
                counts[kind] += 1
    counts["total"] = sum(counts[k] for k in COLLECTIVES)
    return counts


def memory_analysis(s) -> dict:
    """This rank's Σ bytes (``bb``, ``bf``, ``ff`` of a
    ShardedFilterState) against the replicated D²·4 of a dense f32 Σ."""
    n = s.n_max
    d = 22 + 3 * n
    out = {k: getattr(s, k).numel() * getattr(s, k).element_size()
           for k in ("bb", "bf", "ff")}
    out["rank_sigma_bytes"] = out["bb"] + out["bf"] + out["ff"]
    out["replicated_sigma_bytes"] = d * d * 4
    out["fraction"] = out["rank_sigma_bytes"] / out["replicated_sigma_bytes"]
    return out
