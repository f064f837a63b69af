"""Device idle share of a streamed frame in the span slice
(``portbench/spans.py``): 1 - (the replay's last device stamp - its
first) / the frame's latency, mean over the slice's frames, in %.  The
gaps between the graph's nodes count as busy (``device_idle_pct.stream``
keeps them); what is left is the frame's host time outside the replay."""
from portbench import spans


def read(s):
    return spans.fill(s).get("replay_idle_pct")
