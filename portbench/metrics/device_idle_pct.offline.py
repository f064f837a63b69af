"""Device idle share of one profiled call of the offline entry (its
initialization, eager first step, capture and replays): 1 - (union of
device-op intervals / wall), in %."""


def read(s):
    if s.get("frames") or not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
