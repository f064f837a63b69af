"""Runtime tracing / profiling.

Port of ``ekf_vio_tpu/utils/profiling.py``:

* ``FrameTimer`` — the reference's running-average frames/s meter
  (EKFVIO.cpp:119-135), host-side (a copy).
* ``trace`` — a context manager around ``torch.profiler`` (CPU and CUDA
  activity where a card is present, CPU only otherwise) that writes a
  Chrome trace (``trace.json``) into ``logdir``.
* ``device_timer`` — median seconds of a call, with
  ``torch.cuda.synchronize`` around each call where a card is present.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class FrameTimer:
    """Running-average per-frame wall-clock meter (EKFVIO.cpp:119-135).

    >>> ft = FrameTimer(log_every=60)
    >>> with ft.frame(): ...   # per frame
    >>> ft.fps
    """

    def __init__(self, log_every: int = 0, log_fn=print):
        self.count = 0
        self.total_s = 0.0
        self.last_s = 0.0
        self.log_every = log_every
        self.log_fn = log_fn

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.last_s = time.perf_counter() - t0
        self.total_s += self.last_s
        self.count += 1
        if self.log_every and self.count % self.log_every == 0:
            self.log_fn(
                f"[frame {self.count}] average dt {self.average_dt_ms:.3f} ms"
                f" ({self.fps:.1f} fps)"
            )

    @property
    def average_dt_ms(self) -> float:
        return 1e3 * self.total_s / max(self.count, 1)

    @property
    def fps(self) -> float:
        return self.count / self.total_s if self.total_s > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed ops; writes ``logdir/trace.json`` (Chrome
    trace format, viewable in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def device_timer(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall-clock seconds of ``fn(*args)``, the card synchronized
    before and after each call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    samples = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]
