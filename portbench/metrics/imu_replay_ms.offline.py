"""Device time a replayed step spends in ``vio.imu`` (``core/imu``: the IMU
propagation), from the offline cells' recorded call
(``portbench/spans.py``): the program's device stamps at the span's
start and end, which the replays of the captured step re-run; mean over
the replayed steps, in ms."""
from portbench import spans

SPANS = ("vio.imu",)


def read(s):
    got = spans.fill(s).get("replay_spans_ms", {})
    got = [got[n] for n in SPANS if n in got]
    return sum(got) if got else None
