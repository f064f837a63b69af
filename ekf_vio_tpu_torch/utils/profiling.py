"""Runtime tracing / profiling.

Port of ``ekf_vio_tpu/utils/profiling.py``:

* ``FrameTimer`` — the reference's running-average frames/s meter
  (EKFVIO.cpp:119-135), host-side (a copy).
* ``trace`` — a context manager around ``torch.profiler`` (CPU and CUDA
  activity where a card is present, CPU only otherwise) that writes a
  Chrome trace (``trace.json``) into ``logdir``, with the recorder's
  spans and counts merged in.
* ``device_timer`` — median seconds of a call, with
  ``torch.cuda.synchronize`` around each call where a card is present.

and the program's own recorder of spans and counts, which also works
inside a captured CUDA graph (``scan.py``), where no host code runs:

* ``span(name)`` marks a layer of the step (``vio.imu``, ``vio.update``,
  ...).  With no recorder active it enters ``torch.profiler``'s
  ``record_function`` under the same name and nothing else.  With one
  active it records on the host (name, start, end, parent span, frame
  id) and, when the step runs eagerly or is being captured, puts a device
  stamp (``csrc/stamp.cu``: ``%globaltimer`` written into the recorder's
  ring on the card) on the current stream at its start and its end.  A
  replay of the captured graph re-runs the stamps.
* ``frame(name)`` is a span that begins a frame: one row of the ring,
  whose id every span of that step shares (``vio.step``, ``vio.init``).
  A step counter on the card advances once a frame, inside the graph.
* ``count(name, x)`` writes the number of true entries of ``x`` (its sum)
  into the frame's row, ``count(name, x, y)`` the number of entries where
  the masks ``x`` and ``y`` differ (``y`` may be a Python bool: ``True``
  counts the false entries of ``x``): tracked, gated, added, lost,
  skipped.  The arithmetic runs only with a recorder on.
* ``enable`` / ``disable`` / ``recording`` turn the process's recorder on
  and off; ``flush()`` copies the ring to the host once and returns the
  spans and counts since the last flush (``Trace``).

Host spans use the profiler's clock (``time.time_ns``: CLOCK_REALTIME, the
clock ``torch.profiler`` stamps host events with); device stamps are set
on it with one offset measured when the recorder is made.  The recorder is
process state, as ``torch.profiler``'s is: one at a time, on one device.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import time
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from ekf_vio_tpu_torch import cuda_lib


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


# ---------------------------------------------------------------- stamps

NAME = "stamp"
OP_BEGIN, OP_TIME, OP_SUM, OP_CONST = range(4)  # csrc/stamp.cu's ops
HEADER = 2  # slots 0 (layout id) and 1 (frame id) of a row
SLOTS = 64  # slots of a ring row: the header and a frame's writes


def launches() -> int:
    """Stamp kernel launches since the last ``reset_launches``, counted on
    the card by each launch (``csrc/launch_count.cuh``)."""
    return cuda_lib.launch_count(NAME)


def reset_launches() -> None:
    cuda_lib.reset_launch_count(NAME)


@functools.cache
def _lib():
    lib = cuda_lib.load(NAME)
    lib.ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p]
    lib.ring_write.restype = ctypes.c_int
    lib.timer_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.timer_probe.restype = ctypes.c_int
    return lib


# the integer types a count's sum reads as they are, by size in bytes
_ELEM = {torch.bool: 1, torch.uint8: 1, torch.int32: 4, torch.int64: 8}


def _check_ring(ring: Tensor, counter: Tensor) -> None:
    if (ring.dtype != torch.int64 or ring.dim() != 2
            or not ring.is_contiguous() or counter.dtype != torch.int64
            or counter.shape != (1,) or counter.device != ring.device):
        raise ValueError("expected an int64 [rows, slots] contiguous ring "
                         "and an int64 [1] counter on its device")


@torch.library.custom_op("ekf_vio_tpu_torch::ring_write",
                         mutates_args=("ring", "counter"))
def _ring_op(ring: Tensor, counter: Tensor, slot: int, op: int,
             values: Optional[Tensor], constant: int) -> None:
    """One write into the frame's row of ``ring`` (``csrc/stamp.cu``):
    ``op`` begins a frame, stamps the time, sums ``values`` (bool or
    integers, read as they are) or writes ``constant``; the kernel on
    CUDA."""
    _check_ring(ring, counter)
    if values is not None:
        if values.dtype not in _ELEM:
            values = values.to(torch.int64)
        values = values.contiguous()
    lib = _lib()
    rc = lib.ring_write(ring.data_ptr(), counter.data_ptr(), ring.shape[0],
                        ring.shape[1], slot, op,
                        None if values is None else values.data_ptr(),
                        0 if values is None else values.numel(),
                        0 if values is None else _ELEM[values.dtype],
                        constant, ring.device.index,
                        cuda_lib.stream_ptr(ring))
    cuda_lib.check(lib, rc, "ring_write")
    cuda_lib.note_device(NAME, ring.device.index)


@_ring_op.register_kernel("cpu")
def _ring_op_cpu(ring, counter, slot, op, values, constant):
    """The kernel's arithmetic on the host, with the host clock."""
    now = time.time_ns()
    _check_ring(ring, counter)
    c = int(counter[0])
    if op == OP_BEGIN:
        c += 1
        counter[0] = c
    row = ring[c % ring.shape[0]]
    v = now
    if op == OP_BEGIN:
        row[0], row[1] = 0, c
    elif op == OP_SUM:
        v = int(values.to(torch.int64).sum())
    elif op == OP_CONST:
        v = constant
    row[slot] = v


@_ring_op.register_vmap
def _ring_op_vmap(info, in_dims, ring, counter, slot, op, values, constant):
    """Once per batched step: the ring and counter are the recorder's and
    never batched; a count's per-lane values are summed over the lanes,
    as the kernels fold lanes into one launch (``frontend/lanes.py``)."""
    if values is not None and in_dims[4] is not None:
        values = values.movedim(in_dims[4], 0)
    _ring_op(ring, counter, slot, op, values, constant)
    return None, None


def timer_resolution_ns(device=None, iters: int = 100_000) -> dict:
    """``%globaltimer`` on the card as one thread sees it, read ``iters``
    times in a row: the smallest step between two readings and the mean
    period of its updates, in ns."""
    dev = torch.device(device if device is not None else "cuda")
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = _lib()
    cuda_lib.check(lib, lib.timer_probe(out.data_ptr(), iters, dev.index or 0,
                                        cuda_lib.stream_ptr(out)),
                   "timer_probe")
    step, changes, span = out.tolist()
    return {"min_step_ns": step, "changes": changes,
            "mean_period_ns": span / changes if changes else float("nan")}


# ---------------------------------------------------------------- recorder


_OFF = contextlib.nullcontext()  # reusable: nullcontext keeps no state


@dataclasses.dataclass
class Span:
    """One span: ``start_ns`` / ``end_ns`` on the profiler's clock,
    ``parent`` the index of the enclosing span in the same list (-1 for
    none), ``frame`` the frame id (-1 for none)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int = -1
    frame: int = -1

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class Count(NamedTuple):
    name: str
    frame: int
    value: int
    ts_ns: int  # the frame's last stamp before the count


class Trace(NamedTuple):
    """What a flush returns: host spans, device spans (from the stamps),
    counts, and the frames whose row the ring overwrote before it was
    read (a ring of R rows holds the last R frames)."""
    host: list
    device: list
    counts: list
    dropped: int


def self_ns(spans) -> list:
    """Each span's self time: its duration minus the part of its interval
    that its child spans cover."""
    children = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent >= 0:
            children[s.parent].append(i)
    out = []
    for s, kids in zip(spans, children):
        covered, reach = 0, s.start_ns
        for a, b in sorted((max(spans[k].start_ns, s.start_ns),
                            min(spans[k].end_ns, s.end_ns)) for k in kids):
            a = max(a, reach)
            if b > a:
                covered += b - a
                reach = b
        out.append(s.duration_ns - covered)
    return out


class Recorder:
    """Spans and counts of one process, kept in memory: host spans in a
    list, device stamps and counts in a ring [rows, slots] of int64 on
    ``device`` with a step counter beside it (``csrc/stamp.cu``).

    ``frames`` mirrors the counter on the host: a frame begun eagerly adds
    one, a frame begun while a CUDA graph is captured adds one to
    ``captured`` instead, and the code that replays the graph reports its
    frames with ``replayed``."""

    def __init__(self, device="cpu", rows: int = 4096):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if rows < 1:
            raise ValueError(f"a ring of {rows} rows holds no frame")
        self.rows, self.slots = rows, SLOTS
        self.ring = torch.zeros(rows, SLOTS, dtype=torch.int64,
                                device=self.device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.host: list[Span] = []
        self.layouts: dict[tuple, int] = {}   # slot labels -> layout id
        self.frames = 0
        self.captured = 0
        self._open: list[int] = []            # open host spans, innermost last
        self._labels: list[str] | None = None  # the open frame's slots
        self._frame = -1                       # the open frame's id
        self._read = 0                         # frames already flushed
        self.offset_ns = self._clock_offset()

    # -------------------------------------------------------- device side
    def _write(self, op: int, label: str | None, values=None, constant=0,
               slot=None) -> None:
        if slot is None:
            slot = HEADER + len(self._labels)
            if slot >= self.slots:
                raise RuntimeError(f"a frame needs more than {self.slots} "
                                   f"slots of the ring at {label!r}")
            self._labels.append(label)
        _ring_op(self.ring, self.counter, slot, op, values, constant)

    def _clock_offset(self) -> int:
        """ns to add to a device stamp to put it on the host clock: the
        stamp of a launch made right after a synchronize, against the
        midpoint of the host readings around it (the tightest of a few
        tries); 0 on the CPU, where the stamp is the host clock."""
        if self.device.type != "cuda":
            return 0
        probe = torch.zeros(1, 1, dtype=torch.int64, device=self.device)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        best = None
        for _ in range(8):
            torch.cuda.synchronize(self.device)
            t0 = time.time_ns()
            _ring_op(probe, zero, 0, OP_TIME, None, 0)
            torch.cuda.synchronize(self.device)
            t1 = time.time_ns()
            stamp = int(probe[0, 0])
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, (t0 + t1) // 2 - stamp)
        return best[1]

    def _capturing(self) -> bool:
        return (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing())

    # -------------------------------------------------------- host side
    @contextlib.contextmanager
    def span(self, name: str, begins_frame: bool = False,
             annotate: bool = False):
        """A span; with ``begins_frame`` outside a frame, a frame.  The
        host span encloses the device writes and, with ``annotate``, a
        ``record_function`` range under the same name."""
        start = time.time_ns()
        rf = torch.profiler.record_function(name) if annotate else _OFF
        rf.__enter__()
        begins = begins_frame and self._labels is None
        if begins:
            if self._capturing():
                self.captured += 1
                self._frame = -1
            else:
                self.frames += 1
                self._frame = self.frames
            self._labels = []
            self._write(OP_BEGIN, name + ">")
        elif self._labels is not None:
            self._write(OP_TIME, name + ">")
        idx = len(self.host)
        self.host.append(Span(name, start, 0,
                              self._open[-1] if self._open else -1,
                              self._frame if self._labels is not None
                              else -1))
        self._open.append(idx)
        frames_before = self.frames
        try:
            yield
        finally:
            if self._labels is not None:
                self._write(OP_TIME, name + "<")
            if begins:
                layout = tuple(self._labels)
                lid = self.layouts.setdefault(layout, len(self.layouts) + 1)
                self._write(OP_CONST, None, constant=lid, slot=0)
                self._labels, self._frame = None, -1
            rf.__exit__(None, None, None)
            rec = self.host[idx]
            rec.end_ns = time.time_ns()
            self._open.pop()
            if rec.frame < 0 and self.frames > frames_before:
                rec.frame = self.frames   # the (last) frame run inside it

    def count(self, name: str, x: Tensor,
              y: Tensor | bool | None = None) -> None:
        """The number of true entries (the sum) of ``x``, or with ``y`` of
        ``x ^ y``, into the open frame's row; outside a frame nothing.  A
        0-d ``x`` is written as it is (no op of its own); a mask costs its
        reduction (``count_value``)."""
        if self._labels is None:
            return
        self._write(OP_SUM, "#" + name, values=count_value(x, y))

    def replayed(self, frames: int) -> None:
        """A graph that holds ``frames`` frames was replayed."""
        self.frames += frames

    # -------------------------------------------------------- read out
    def flush(self) -> Trace:
        """Copy the ring to the host (one synchronisation) and turn the
        frames since the last flush into spans and counts; the host spans
        recorded since then are returned and forgotten.  A span outside
        any frame takes the frame that ran inside it, else its parent's."""
        if self._open:
            raise RuntimeError("flush inside an open span")
        ring = self.ring.cpu().tolist()
        last = int(self.counter.cpu()[0])
        first = max(self._read + 1, last - self.rows + 1)
        dropped = first - (self._read + 1)
        self._read = last
        by_id = {v: k for k, v in self.layouts.items()}
        device, counts = [], []
        for f in range(first, last + 1):
            row = ring[f % self.rows]
            labels = by_id.get(row[0])
            if row[1] != f or labels is None:  # unfinished or overwritten
                dropped += 1
                continue
            stack, t = [], 0
            for label, v in zip(labels, row[HEADER:]):
                if label[0] == "#":
                    counts.append(Count(label[1:], f, v, t))
                    continue
                t = v + self.offset_ns
                if label[-1] == ">":
                    stack.append(len(device))
                    device.append(Span(label[:-1], t, t,
                                       stack[-2] if len(stack) > 1 else -1,
                                       f))
                else:
                    device[stack.pop()].end_ns = t
        host, self.host = self.host, []
        for s in host:
            if s.frame < 0 and s.parent >= 0:
                s.frame = host[s.parent].frame
        return Trace(host, device, counts, dropped)


_active: Recorder | None = None


def active() -> Recorder | None:
    """The recorder that is on, or None."""
    return _active


def enable(device="cpu", rows: int = 4096) -> Recorder:
    """Turn a new recorder on (the one before it, if any, is dropped
    unread)."""
    global _active
    _active = Recorder(device, rows)
    return _active


def disable() -> Recorder | None:
    """Turn the recorder off; returns it (its ``flush`` still reads)."""
    global _active
    rec, _active = _active, None
    return rec


def flush() -> Trace:
    """``Recorder.flush`` of the recorder that is on."""
    if _active is None:
        raise RuntimeError("no recorder is on")
    return _active.flush()


@contextlib.contextmanager
def recording(device="cpu", rows: int = 4096):
    """A recorder on for the block: ``with recording(dev) as rec: ...``."""
    rec = enable(device, rows)
    try:
        yield rec
    finally:
        if _active is rec:
            disable()


def span(name: str):
    """A layer's span.  With no recorder on: ``record_function(name)``
    (the ``vio.*`` layer spans, which ``torch.profiler`` traces of eager
    steps read) and nothing else."""
    if _active is None:
        return torch.profiler.record_function(name)
    return _active.span(name, annotate=True)


def frame(name: str):
    """A span that begins a frame (``vio.step``, ``vio.init``): a row of
    the ring and the frame id of every span inside it.  Nothing at all
    with no recorder on."""
    if _active is None:
        return _OFF
    return _active.span(name, begins_frame=True)


def framed(name: str):
    """Decorator: each call of the function is a ``frame(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with frame(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count_value(x: Tensor, y: Tensor | bool | None = None) -> Tensor:
    """What a count writes: a 0-d ``x`` as it is, else the number of true
    entries of ``x`` (or of ``x ^ y``; ``y`` a mask or a bool) as an int64
    0-d tensor."""
    if y is not None:
        x = x ^ y
    return x.sum(dtype=torch.int64) if x.dim() else x


def count(name: str, x: Tensor, y: Tensor | bool | None = None) -> None:
    """``Recorder.count`` on the recorder that is on; nothing otherwise,
    so pass the masks and not an expression of them: a caller's ``a ^ b``
    would run with the recorder off too."""
    if _active is not None:
        _active.count(name, x, y)


# ---------------------------------------------------------------- export


def chrome_events(tr: Trace, base_ns: int = 0,
                  pid: str = "ekf_vio_tpu_torch") -> list:
    """A flush as Chrome-trace events on the profiler's clock (``ts`` in
    µs from ``base_ns``): spans as complete events on a host and a device
    row, counts as counter events at their frame's stamp."""
    def x(s, tid):
        return {"ph": "X", "name": s.name, "pid": pid, "tid": tid,
                "ts": (s.start_ns - base_ns) / 1e3,
                "dur": s.duration_ns / 1e3, "args": {"frame": s.frame}}

    return ([x(s, "program spans (host)") for s in tr.host]
            + [x(s, "program spans (device stamps)") for s in tr.device]
            + [{"ph": "C", "name": c.name, "pid": pid,
                "ts": (c.ts_ns - base_ns) / 1e3, "args": {c.name: c.value}}
               for c in tr.counts])


@contextlib.contextmanager
def trace(logdir: str, device=None, rows: int = 4096):
    """Profile the enclosed ops with the recorder on; writes
    ``logdir/trace.json`` (Chrome trace format, viewable in Perfetto or
    chrome://tracing): the profiler's events, and the program's spans and
    counts on the same clock (``chrome_events``).  ``device`` is the
    recorder's (the card where there is one, else the CPU); its ring keeps
    the last ``rows`` frames."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    os.makedirs(logdir, exist_ok=True)
    with recording(device, rows) as rec:
        with profile(activities=activities) as prof:
            yield prof
        tr = rec.flush()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += chrome_events(tr, int(doc.get("baseTimeNanoseconds",
                                                        0)))
    with open(path, "w") as f:
        json.dump(doc, f)
