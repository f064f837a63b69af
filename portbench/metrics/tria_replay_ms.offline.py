"""Device time a replayed square-root-form step spends in its QR
triangularizations (``core/sqrt_filter.py``: the ``vio.tria.*`` spans,
``imu``, ``predict``, ``update``, ``posterior`` and ``wipe``), from the
offline cells' recorded call (``portbench/spans.py``): the program's
device stamps at each span's start and end, which the replays of the
captured step re-run; summed over the roles, mean over the replayed
steps, in ms.  Nothing to read where the program has no such span (the
covariance form, or a program older than them)."""
from portbench import spans

PREFIX = "vio.tria."


def read(s):
    got = [v for k, v in spans.fill(s).get("replay_spans_ms", {}).items()
           if k.startswith(PREFIX)]
    return sum(got) if got else None
