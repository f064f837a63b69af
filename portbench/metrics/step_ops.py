"""Device operations a streamed frame (a count: copies and the replayed
step's kernels), the mean over the profiled frames."""
import statistics


def read(s):
    v = s.get("frame_ops")
    return statistics.fmean(v) if v else None
