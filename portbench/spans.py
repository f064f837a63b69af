"""The span slice: per-layer device time of the replayed step, the host
glue of ``scan.graphed`` and initialization, measured inside the program
by its recorder (``ekf_vio_tpu_torch/utils/profiling.py``: host spans,
and device stamps that a replay of the captured step re-runs).

``fill(summary)`` runs once per traced run, after the cell's ``drivers/``
module has returned, and adds the slice's numbers to the summary the
per-layer readers take; every reader of a metric below calls it first.
The slice runs in a fresh process (this file run as a script, on the
run's ``--workload`` and ``--seed``), because frames after a stopped
``torch.profiler`` run slower on the host (``graphed.launch`` ~8x) and
the traced run has just stopped two.  ``fill`` runs nothing, and adds
nothing, outside a benchmark run, without a card or where the program has
no recorder (a program older than it); a slice that fails or times out
raises, with its stderr, so the traced run fails rather than leave the
metrics out.

In that process, after a warm-up with the recorder off:

* stream cells: the recorder on, the next session's initialization (one
  ``vio.init``), then ``SLICE_FRAMES`` frames through a fresh
  ``scan.graphed`` step, each timed as the window times a frame (pinned
  host tensors handed over → pose on the host); the first call, which
  captures the stamped graph, is left out; then the same frames with the
  recorder off, for its cost;
* offline cells: ``offline.py``'s profiled call (``profile_frames`` of the
  cell's sequences) with the recorder on, then with it off.

Summary keys added: ``replay_spans_ms`` (mean device ms a replayed step
spends in each ``vio.*`` span, first to last stamp), ``graphed_host_ms``
and ``graphed_host_split_ms`` (host ms of ``graphed.call`` and its
children), ``replay_idle_pct``, ``init_ms`` (host start of ``vio.init``
to its closing device stamp), ``span_frame_ms`` / ``plain_frame_ms``
(stream, recorder on / off), ``span_idle_us`` (a stream frame's idle time
before the replay's first stamp and after its last, split by host span),
``span_call_s`` / ``plain_call_s`` (offline), and ``span_slice`` (what
ran, or why nothing did).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SLICE_FRAMES = 300
WARM_FRAMES = 20
SESSION_SALT = 7      # drivers/stream.py's salt for a session's seed
GLUE = ("graphed.copy_in", "graphed.launch", "graphed.copy_out")
TIMEOUT_S = 600


def _run_args():
    """(workload, seed) this process runs, from ``run.py``'s arguments;
    None outside a benchmark run."""
    p = argparse.ArgumentParser(add_help=False, exit_on_error=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    try:
        a, _ = p.parse_known_args(sys.argv[1:])
    except argparse.ArgumentError:
        return None
    return None if a.workload is None or a.seed is None else (a.workload,
                                                             a.seed)


def fill(summary: dict) -> dict:
    """Add the span slice's numbers to ``summary`` (once; see the module's
    docstring)."""
    if "span_slice" in summary:
        return summary
    summary["span_slice"] = "not run"
    run = _run_args()
    try:
        import torch
        from ekf_vio_tpu_torch.utils import profiling
    except ImportError:
        return summary
    if run is None or not hasattr(profiling, "recording"):
        summary["span_slice"] = "no benchmark run, or no recorder"
        return summary
    if not torch.cuda.is_available():
        return summary
    try:
        p = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            run[0], str(run[1])], cwd=ROOT,
                           capture_output=True, text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode(errors="replace") if isinstance(
            e.stderr, bytes) else e.stderr or ""
        raise RuntimeError(f"the span slice timed out after {TIMEOUT_S} s; "
                           f"its stderr:\n{err[-8000:]}") from None
    sys.stderr.write(p.stderr)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"the span slice failed (exit {p.returncode}, "
                           f"{len(lines)} lines of output); its stderr:\n"
                           f"{p.stderr[-8000:]}")
    summary.update(json.loads(lines[-1]))
    return summary


# ------------------------------------------------------------ reduction


def _frame_spans(tr) -> dict:
    """frame id -> {span name: device ns} of the flushed device spans."""
    out = defaultdict(lambda: defaultdict(int))
    for s in tr.device:
        out[s.frame][s.name] += s.duration_ns
    return out


def _mean_ms(per_frame: list, names=None) -> dict:
    names = names or sorted({n for f in per_frame for n in f})
    return {n: statistics.fmean(f.get(n, 0) for f in per_frame) * 1e-6
            for n in names}


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def stream_numbers(tr, timed: list) -> dict:
    """The stream slice's numbers from a flush ``tr`` and the host-clock
    (start, end) ns of each timed frame: each frame is the
    ``graphed.call`` that started inside it and the device frame it ran."""
    calls = [(i, s) for i, s in enumerate(tr.host) if s.name == "graphed.call"]
    kids = defaultdict(dict)
    for s in tr.host:
        if s.name in GLUE and s.parent >= 0:
            kids[s.parent][s.name] = s
    steps = {s.frame: s for s in tr.device if s.name == "vio.step"}
    dev = _frame_spans(tr)
    per_frame, host, split, idle, lat = [], [], [], [], []
    before = defaultdict(float)
    after = defaultdict(float)
    j = 0
    for t0, t1 in timed:
        while j < len(calls) and calls[j][1].start_ns < t0:
            j += 1
        if j == len(calls) or calls[j][1].start_ns > t1:
            continue
        idx, call = calls[j]
        step = steps.get(call.frame)
        if step is None:
            continue
        per_frame.append(dev[call.frame])
        host.append(call.duration_ns * 1e-6)
        split.append({n: s.duration_ns for n, s in kids[idx].items()})
        lat.append((t1 - t0) * 1e-6)
        idle.append(100.0 * (1.0 - step.duration_ns / (t1 - t0)))
        for side, (a, b) in ((before, (t0, step.start_ns)),
                             (after, (step.end_ns, t1))):
            rest = max(0, b - a)
            for n, s in kids[idx].items():
                ov = _overlap(a, b, s.start_ns, s.end_ns)
                side[n] += ov * 1e-3
                rest -= ov
            side["outside the program"] += rest * 1e-3
    n = len(per_frame)
    if not n:
        return {}
    init = [s for s in tr.host if s.name == "vio.init"]
    init_dev = {s.frame: s for s in tr.device if s.name == "vio.init"}
    out = {"replay_spans_ms": _mean_ms(per_frame),
           "graphed_host_ms": statistics.fmean(host),
           "graphed_host_split_ms": _mean_ms(split, GLUE),
           "replay_idle_pct": statistics.fmean(idle),
           "span_frame_ms": statistics.fmean(lat),
           "span_frames": n,
           "span_idle_us": {"before the first stamp":
                            {k: v / n for k, v in before.items()},
                            "after the last stamp":
                            {k: v / n for k, v in after.items()}}}
    if init and init[0].frame in init_dev:
        out["init_ms"] = (init_dev[init[0].frame].end_ns
                          - init[0].start_ns) * 1e-6
    return out


def offline_numbers(tr) -> dict:
    """The offline slice's numbers: every replayed frame of the call (the
    scan's first, eager, step left out)."""
    steps = sorted(s.frame for s in tr.device if s.name == "vio.step")
    dev = _frame_spans(tr)
    replayed = [dev[f] for f in steps[1:]]
    if not replayed:
        return {}
    out = {"replay_spans_ms": _mean_ms(replayed),
           "span_frames": len(replayed)}
    init = {s.frame: s for s in tr.device if s.name == "vio.init"}
    host = [s for s in tr.host if s.name == "vio.init" and s.frame in init]
    if host:
        out["init_ms"] = (init[host[0].frame].end_ns - host[0].start_ns) * 1e-6
    return out


# ------------------------------------------------------------ the slices


def _stream(h, dev, profiling, frames: int = SLICE_FRAMES,
            warm: int = WARM_FRAMES) -> dict:
    import torch

    from ekf_vio_tpu_torch import engine, scan
    from portbench.traffic.generate import make_session, sub_seed

    cfg, cam = h.vio_config(), h.camera()
    imu = cfg.use_imu
    k0 = cfg.vi_init_frames if imu else 1
    tf = h.traffic
    # the session after the window's sessions: a seed of its own
    made = make_session(h.config, tf, sub_seed(h.seed, SESSION_SALT,
                                                int(tf["sessions"])),
                        k0 + 1 + frames, dev)
    d = {}
    for k, v in made.items():
        d[k] = torch.empty(v.shape, dtype=v.dtype,
                           pin_memory=dev.type == "cuda")
        d[k].copy_(v)
    del made
    gravity = d["gravity_w"].to(dev)

    def to_dev(xs):
        return tuple(x.to(dev, non_blocking=True) for x in xs)

    def frame_in(i):
        if imu:
            return (d["frames"][i], d["times"][i], d["imu_dt"][i - 1],
                    d["imu_gyro"][i - 1], d["imu_accel"][i - 1])
        return (d["frames"][i], d["times"][i])

    def session(n):
        """The session's initialization, its first (capturing) call and
        ``n`` frames, each timed as the window times a frame: their
        host-clock (start, end) ns."""
        if imu:
            body = engine.imu_step_body(cfg, cam, gravity)
            step = scan.graphed(lambda es, *x: body(es, x))
            x = to_dev((d["frames"][:k0], d["times"][:k0],
                        d["imu_dt"][:k0 - 1], d["imu_gyro"][:k0 - 1],
                        d["imu_accel"][:k0 - 1]))
            es = engine.initialize_imu(*x, gravity, cfg, cam, k0, device=dev)
        else:
            step = scan.graphed(lambda es, img, t: engine.step(es, img, t,
                                                               cfg, cam))
            es = engine.initialize(*to_dev(frame_in(0)), cfg, cam,
                                   device=dev)
        es, out = step(es, *to_dev(frame_in(k0)))
        out.base_mu[:7].cpu()
        timed = []
        for i in range(k0 + 1, k0 + 1 + n):
            t0 = time.time_ns()
            es, out = step(es, *to_dev(frame_in(i)))
            out.base_mu[:7].cpu()
            timed.append((t0, time.time_ns()))
        return timed

    session(warm)
    h.sync(dev)
    with profiling.recording(dev) as rec:
        timed = session(frames)
        tr = rec.flush()
    got = stream_numbers(tr, timed)
    got["plain_frame_ms"] = statistics.fmean(
        (b - a) * 1e-6 for a, b in session(frames))
    split = ", ".join(
        f"{side}: " + ", ".join(f"{k} {v!r}" for k, v in parts.items())
        for side, parts in got.get("span_idle_us", {}).items())
    print(f"span slice: {got.get('span_frames', 0)} frames at "
          f"{got.get('span_frame_ms')!r} ms (recorder off "
          f"{got['plain_frame_ms']!r} ms), graphed.call "
          f"{got.get('graphed_host_ms')!r} ms "
          f"{got.get('graphed_host_split_ms')!r}; idle us a frame: {split}",
          file=sys.stderr)
    return got


def _offline(h, dev, profiling) -> dict:
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.parallel import batched_engine
    from portbench.traffic.generate import make_session

    cfg, cam = h.vio_config(), h.camera()
    tf = h.traffic
    frames, t = int(tf["frames"]), int(tf["profile_frames"])
    if tf["driver"] == "fleet":
        data = make_session(h.config, tf, h.seed, frames, dev,
                            lanes=int(tf["lanes"]))

        def call(n=t):
            return batched_engine.run_sequences_batched(
                data["frames"][:, :n], data["times"][:, :n], cfg, cam,
                device=dev)
        warm = 4
    else:
        d = make_session(h.config, tf, h.seed, frames, dev)
        k0 = cfg.vi_init_frames

        def call(n=t):
            return engine.run_sequence_imu(
                d["frames"][:n], d["times"][:n], d["imu_dt"][:n - 1],
                d["imu_gyro"][:n - 1], d["imu_accel"][:n - 1],
                d["gravity_w"], cfg, cam, init_frames=k0, device=dev)
        warm = k0 + 4

    def timed():
        h.sync(dev)
        t0 = time.perf_counter()
        call()
        h.sync(dev)
        return time.perf_counter() - t0

    call(warm)   # as ``offline.run_calls``' set-up
    with profiling.recording(dev, rows=max(4096, t + 8)) as rec:
        on = timed()
        tr = rec.flush()
    got = offline_numbers(tr)
    got.update(span_call_s=on, plain_call_s=timed())
    print(f"span slice: a {t}-frame call {on!r} s with the recorder on, "
          f"{got['plain_call_s']!r} s off; {got.get('span_frames', 0)} "
          f"replayed frames", file=sys.stderr)
    return got


def main(argv) -> int:
    """Run the span slice of cell ``argv[0]`` with seed ``argv[1]`` on the
    card and print its summary keys as one JSON line."""
    import torch

    from ekf_vio_tpu_torch.utils import profiling
    from portbench.harness import Harness, cache_env

    cache_env()
    h = Harness(argv[0], int(argv[1]), 0.0, True, time.perf_counter())
    dev = h.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = h.traffic["driver"]
    got = (_stream(h, dev, profiling) if kind == "stream"
           else _offline(h, dev, profiling))
    print(json.dumps(dict(got, span_slice=kind)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
