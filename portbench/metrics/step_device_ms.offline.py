"""Device-op time a replayed (batched) step of the profiled offline call:
the device ops from its first graph launch on, over the launches, in ms."""


def read(s):
    if s.get("frames"):
        return None
    return s.get("replay_device_ms")
