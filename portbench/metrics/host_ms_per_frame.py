"""Host time a streamed frame: the mean latency of the window's untraced
frames minus the mean device-op time of a traced frame (copies and the
replayed step's kernels), in ms.  The profiler slows the frames it
traces, so their own wall time would measure it, not the host glue."""
import statistics


def read(s):
    dev, wall = s.get("frame_device_ms"), s.get("untraced_frame_ms")
    if not dev or wall is None:
        return None
    return wall - statistics.fmean(dev)
