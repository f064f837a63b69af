"""Device idle share of a streamed frame: 1 - (mean device-op time of a
traced frame / mean latency of the window's untraced frames), in %.  The
profiler slows the frames it traces, so the traced slice's own wall time
would count its overhead as idle."""
import statistics


def read(s):
    dev, wall = s.get("frame_device_ms"), s.get("untraced_frame_ms")
    if not dev or not wall:
        return None
    return 100.0 * (1.0 - statistics.fmean(dev) / wall)
