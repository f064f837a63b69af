"""Host time of the CUDA-graph capture of each offline call
(``scan.last["capture_s"]`` after it), the mean over the window's calls,
in ms."""


def read(s):
    return s.get("capture_ms")
