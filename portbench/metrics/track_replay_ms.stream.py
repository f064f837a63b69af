"""Device time a replayed step spends in the front end: ``vio.pyramid``,
``vio.track`` and ``vio.gates`` (where the configuration gates), from
the stream cells' span slice (``portbench/spans.py``): the program's device
stamps, which the replays of the captured step re-run; mean over the
replayed steps, in ms."""
from portbench import spans

SPANS = ("vio.pyramid", "vio.track", "vio.gates")


def read(s):
    got = spans.fill(s).get("replay_spans_ms", {})
    got = [got[n] for n in SPANS if n in got]
    return sum(got) if got else None
