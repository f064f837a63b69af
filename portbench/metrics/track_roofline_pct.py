"""Share of the card's roofline in ``vio.track``: the least time the
tracking work of these inputs needs (``roofline/track.py``: the windows
of the tracked features at every level, each pixel read once, and one
iteration each, at the published HBM and f32 peaks) over the device time
under ``vio.track`` in the eager sample, in %.  Nothing to read without a
card whose peaks are known."""


def read(s):
    bound, dev = s.get("track_bound_ms"), s.get("spans_ms", {}).get("vio.track")
    if bound is None or not dev:
        return None
    return 100.0 * bound / dev
