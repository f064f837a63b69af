"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
readers take.

The traced slice is a run of frames, each inside a ``portbench.frame``
span of the benchmark's own (stream cells), or one whole call inside a
``portbench.call`` span (offline cells).  From the device operations
(kernels, copies, fills; graph replays included, since the profiler sees
the kernels a replay runs) and the host spans it keeps: the union of
device-busy intervals, per frame the device-op time and the number of
device operations, per replay the device time, the
longest idle gaps by what the host was doing, and the device operations
that took most time.  The eager sample's ``vio.*`` spans (the program's
own ``record_function`` ranges, which a replay does not run) give the
device time of each layer.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

FRAME = "portbench.frame"
CALL = "portbench.call"
LONG_GAP_NS = 20_000


def profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof):
    """(device ops [(start_ns, end_ns, name)], host ops [(start_ns, end_ns,
    name)]) of a finished profile, each sorted by start."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name())
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and (e.is_user_annotation() or _annotation(e.name())):
            continue   # a span's shadow on the device timeline, not an op
        (dev if on_device else host).append(rec)
    dev.sort()
    host.sort()
    return dev, host


def _annotation(name: str) -> bool:
    return name in (FRAME, CALL) or name.startswith("vio.")


def _union(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _busy_in(union, starts, lo, hi):
    """Busy ns of the merged ``union`` inside [lo, hi]."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    busy = 0
    while i < len(union) and union[i][0] < hi:
        s, e = max(union[i][0], lo), min(union[i][1], hi)
        if e > s:
            busy += e - s
        i += 1
    return busy


def _label_gaps(union, host, lo, hi):
    """Idle ns between lo and hi by the host op that overlapped each long
    gap most (innermost on ties); short gaps between graph nodes in one
    bucket."""
    ops = [h for h in host if h[2] not in (FRAME, CALL)]
    starts = [h[0] for h in ops]
    out = defaultdict(int)
    prev = lo
    edges = [(s, e) for s, e in union if e > lo and s < hi] + [(hi, hi)]
    for s, e in edges:
        gs, ge = prev, min(s, hi)
        if ge > gs:
            if ge - gs < LONG_GAP_NS:
                out["gaps under 20 us (between device ops)"] += ge - gs
            else:
                best, key = None, None
                j = bisect.bisect_left(starts, ge)
                for h in ops[max(0, j - 2000):j]:
                    ov = min(h[1], ge) - max(h[0], gs)
                    if ov > 0:
                        k = (ov, -(h[1] - h[0]))
                        if key is None or k > key:
                            best, key = h[2], k
                out[f"host: {best}" if best else "host: Python, no profiled op"] += ge - gs
        prev = max(prev, e)
    return out


def _top(d, n=10, scale=1e-9):
    return [[k, v * scale] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def reduce_slice(prof) -> dict:
    """The slice's numbers: busy and window seconds, per-frame device ms
    and op counts (stream), device ms per replay (every
    slice), and the breakdown."""
    dev, host = _events(prof)
    spans = [(s, e) for s, e, n in host if n == FRAME]
    calls = [(s, e) for s, e, n in host if n == CALL]
    bounds = spans or calls
    if not bounds or not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "breakdown": {}, "frames": 0}
    lo, hi = bounds[0][0], bounds[-1][1]
    inside = [d for d in dev if d[0] >= lo and d[0] < hi]
    union = _union([(s, e) for s, e, _ in inside])
    starts = [u[0] for u in union]
    busy = _busy_in(union, starts, lo, hi)
    out = {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9,
           "frames": len(spans)}
    if spans:
        ds = [d[0] for d in inside]
        dev_ms, ops = [], []
        for s, e in spans:
            i, j = bisect.bisect_left(ds, s), bisect.bisect_left(ds, e)
            dev_ms.append(sum(x[1] - x[0] for x in inside[i:j]) * 1e-6)
            ops.append(j - i)
        out.update(frame_device_ms=dev_ms, frame_ops=ops)
    launches = [s for s, e, n in host if "GraphLaunch" in n and lo <= s < hi]
    if launches:
        replayed = [d for d in inside if d[0] >= launches[0]]
        out["replays"] = len(launches)
        out["replay_device_ms"] = (sum(e - s for s, e, _ in replayed) * 1e-6
                                   / len(launches))
    by_name = defaultdict(int)
    for s, e, n in inside:
        by_name[n[:80]] += e - s
    out["breakdown"] = {"device_ops": _top(by_name),
                        "idle_gaps": _top(_label_gaps(union, host, lo, hi))}
    return out


def span_device_ms(prof, steps: int) -> dict:
    """Device ms a step of the kernels (and copies) launched under each
    ``vio.*`` span of an eager sample: the kernels of the span's host
    ops and of all their descendants."""
    out = defaultdict(float)
    for e in prof.events():
        if not e.name.startswith("vio.") or str(e.device_type).endswith("CUDA"):
            continue
        total, stack = 0.0, [e]
        while stack:
            x = stack.pop()
            total += sum(k.duration for k in x.kernels
                         if not _annotation(k.name))
            stack.extend(x.cpu_children)
        out[e.name] += total
    return {k: v * 1e-3 / steps for k, v in out.items()}
