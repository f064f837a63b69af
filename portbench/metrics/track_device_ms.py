"""Device time a step under the program's ``vio.pyramid, vio.track, vio.gates`` span(s), from the
eager sample's profile (a replay runs no spans), in ms."""

SPANS = ("vio.pyramid", "vio.track", "vio.gates")


def read(s):
    got = [s.get("spans_ms", {}).get(n) for n in SPANS]
    got = [g for g in got if g is not None]
    return sum(got) if got else None
