"""Device-op time a streamed frame (copies in and out and the replayed
step's kernels), the mean over the profiled frames, in ms."""
import statistics


def read(s):
    v = s.get("frame_device_ms")
    return statistics.fmean(v) if v else None
