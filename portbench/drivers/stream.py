"""``stream``: one camera in a closed loop, one frame in flight.

The estimator thread of a robot: it takes the newest frame as soon as it
has published the last pose.  Each session of ``frames`` frames is made
on the card from its own seed and kept in pinned host memory, as a camera
driver hands frames over.  A session starts with the program's
initialization (mono-inertial: ``engine.initialize_imu`` over
``vi_init_frames`` frames; vision-only: ``engine.initialize`` on frame
0), then calls the compiled step, ``scan.graphed`` over
``engine.imu_step_body`` or ``engine.step`` (the CLI's streaming loop,
without drawing), once a frame.  Set-up runs the first session's
initialization and first, capturing, call; a session that ends inside
the window is followed by the next one, whose initialization is paid in
the window.  A frame's latency runs from the moment its host tensors are
handed over until its pose (``base_mu[:7]``) is on the host.

A traced run profiles the frames that start once ``profile_lead_s`` of
the window is left (the profiler slows what it traces and the frames
after it); the frames before them give the untraced latency that the
per-frame metrics set the traced device time against.

Correctness, after the window: at frames drawn from the seed the plain
reference steps from the program's own state before the frame and its
result is held against the program's state and outputs after it; each
session's initialization is held against the reference's, worked out
from the session's frames alone.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import trace as tr
from portbench.reference import compare
from portbench.reference import vio as ref
from portbench.traffic.generate import sub_seed, make_session

SAMPLE_SALT = 5


def _host_session(h, seed, dev, frames):
    """One session made on the card, then held in pinned host memory."""
    import torch

    s = make_session(h.config, h.traffic, seed, frames, dev)
    out = {}
    for k, v in s.items():
        out[k] = torch.empty(v.shape, dtype=v.dtype,
                             pin_memory=dev.type == "cuda")
        out[k].copy_(v)
    del s
    return out


def run(h, dev):
    import torch

    from ekf_vio_tpu_torch import engine, scan

    cfg, cam = h.vio_config(), h.camera()
    rcfg, rcam = ref.make_cfg(h.config["vio"]), h.ref_camera()
    tf = h.traffic
    frames = int(tf["frames"])
    imu = cfg.use_imu
    k0 = cfg.vi_init_frames if imu else 1
    seeds = [sub_seed(h.seed, 7, i) for i in range(int(tf["sessions"]))]
    h.phase("port imported")
    sessions = [_host_session(h, s, dev, frames) for s in seeds]
    h.phase("sessions made")
    gravity = sessions[0]["gravity_w"].to(dev)
    if imu:
        body = engine.imu_step_body(cfg, cam, gravity)
        eager = lambda es, *x: body(es, x)  # noqa: E731
    else:
        eager = lambda es, img, t: engine.step(es, img, t, cfg, cam)  # noqa: E731
    step = scan.graphed(eager)

    def to_dev(xs):
        return tuple(x.to(dev, non_blocking=True) for x in xs)

    def frame_in(d, i):
        if imu:
            return (d["frames"][i], d["times"][i], d["imu_dt"][i - 1],
                    d["imu_gyro"][i - 1], d["imu_accel"][i - 1])
        return (d["frames"][i], d["times"][i])

    def initialize(d):
        if imu:
            x = to_dev((d["frames"][:k0], d["times"][:k0], d["imu_dt"][:k0 - 1],
                        d["imu_gyro"][:k0 - 1], d["imu_accel"][:k0 - 1]))
            return engine.initialize_imu(*x, gravity, cfg, cam, k0, device=dev)
        x = to_dev((d["frames"][0], d["times"][0]))
        return engine.initialize(*x, cfg, cam, device=dev)

    n_sample = min(int(tf["sample_steps"]), frames - k0 - 1)
    samples = {}

    def sampled(sess, i):
        """Whether frame i of session ``sess`` is compared: ``n_sample``
        frames a session, drawn from the seed.  Frame k0 is a session's
        first step, the first session's being the capturing call of
        set-up, so the draw starts one later."""
        if sess not in samples:
            rng = np.random.default_rng(
                [h.seed & ((1 << 64) - 1), SAMPLE_SALT, sess])
            samples[sess] = set(rng.choice(np.arange(k0 + 1, frames),
                                           n_sample, replace=False).tolist())
        return i in samples[sess]

    # ---------------------------------------------------------- set-up
    inits = []                   # (session, program init state)
    es = initialize(sessions[0])
    inits.append((0, es))
    h.phase("first initialization")
    es, out = step(es, *to_dev(frame_in(sessions[0], k0)))
    out.base_mu[:7].cpu()
    h.setup_done(dev)

    # ---------------------------------------------------------- window
    kept = []                    # (session, frame, pre, post, out)
    lat, failed, done = [], 0, 0
    sess, i = 0, k0 + 1
    prof = prof_done = eager_start = None
    # traced runs profile the frames that start once ``profile_lead_s``
    # of the window is left, so every frame before them runs with no
    # profiler loaded yet; the slice runs to its end past the deadline
    p_first, p_lead = None, float(tf["profile_lead_s"])
    p_count = int(tf["profile_frames"])
    t_start = time.perf_counter()
    deadline = t_start + h.seconds
    t_end = t_start
    while prof is not None or time.perf_counter() < deadline:
        if i >= frames:          # the next seed's session, its init paid here
            sess += 1
            i = k0
            es = initialize(sessions[sess % len(sessions)])
            inits.append((sess, es))
        d = sessions[sess % len(sessions)]
        if h.trace and p_first is None and deadline - time.perf_counter() <= p_lead:
            p_first = done
            eager_start = (sess, i, es)
            prof = tr.profiler(dev)
            prof.__enter__()
        span = torch.profiler.record_function(tr.FRAME) if prof else None
        if span is not None:
            span.__enter__()
        t0 = time.perf_counter()
        pre = es
        es, out = step(es, *to_dev(frame_in(d, i)))
        pose = out.base_mu[:7].cpu()
        t_end = time.perf_counter()
        if span is not None:
            span.__exit__(None, None, None)
            if done + 1 == p_first + p_count:
                prof.__exit__(None, None, None)
                prof_done, prof = prof, None
        lat.append((t_end - t0) * 1e3)
        failed += int(not bool(torch.isfinite(pose).all()))
        if sampled(sess, i):
            kept.append((sess, i, pre, es, out))
        done += 1
        i += 1
    if prof is not None:
        prof.__exit__(None, None, None)
        prof_done = prof
    window = t_end - t_start
    info = h.device_info(dev)
    res = {"attempted": done, "failed": failed, "device": info,
           "metrics": {"stream_fps": done / window,
                       "frame_p95_ms": _p95(lat)}}

    # ---------------------------------------------------------- trace
    if h.trace:
        summary = (tr.reduce_slice(prof_done) if prof_done is not None else
                   {"busy_s": 0.0, "window_s": 0.0, "breakdown": {}, "frames": 0})
        if eager_start is not None:
            summary.update(_eager_sample(h, dev, eager, sessions, frame_in,
                                         eager_start, cfg))
        # the profiler slows the frames it traces: the window's other
        # frames give the latency the per-frame device time is set against
        traced = lat[p_first:] if p_first is not None else []
        untraced = lat[:p_first]
        if traced and untraced:
            summary["traced_frame_ms"] = sum(traced) / len(traced)
            summary["untraced_frame_ms"] = sum(untraced) / len(untraced)
        res["trace"] = summary

    # ---------------------------------------------------------- correct
    del es, out, pre, eager_start, step
    control = getattr(h, "control", False)
    gaps, cgaps = [], []
    for sess_i, init_state in inits:
        d = sessions[sess_i % len(sessions)]
        r = _ref_init(d, dev, rcfg, rcam, k0, imu, gravity, False)
        gaps.append(compare.state_gaps(ref.from_program(init_state), None, r, None))
        if control:
            c = _ref_init(d, dev, rcfg, rcam, k0, imu, gravity, True)
            cgaps.append(compare.state_gaps(c, None, r, None))
    for sess_i, fi, pre, post, out in kept:
        x = [v.to(dev) for v in frame_in(sessions[sess_i % len(sessions)], fi)]
        r, r_out = _ref_step(ref.from_program(pre), x, rcfg, rcam, imu, gravity,
                             False)
        gaps.append(compare.state_gaps(ref.from_program(post), out._asdict(),
                                       r, r_out))
        if control:
            c, c_out = _ref_step(ref.from_program(pre), x, rcfg, rcam, imu,
                                 gravity, True)
            cgaps.append(compare.state_gaps(c, c_out, r, r_out))
    h.hold(gaps, cgaps, steps=len(kept), inits=len(inits))
    return res


def _p95(values):
    from portbench.harness import p95

    return p95(values) if len(values) >= 20 else max(values)


def _ref_step(state, x, rcfg, rcam, imu, gravity, tf32):
    with ref.precision(tf32):
        if imu:
            img, t, idt, gyro, accel = x
            return ref.step(state, img, t, rcfg, rcam, imu=(idt, gyro, accel),
                            gravity_w=gravity)
        return ref.step(state, x[0], x[1], rcfg, rcam)


def _ref_init(d, dev, rcfg, rcam, k0, imu, gravity, tf32):
    with ref.precision(tf32):
        if imu:
            return ref.initialize_imu(
                d["frames"][:k0].to(dev), d["times"][:k0].to(dev),
                d["imu_dt"][:k0 - 1].to(dev), d["imu_gyro"][:k0 - 1].to(dev),
                d["imu_accel"][:k0 - 1].to(dev), gravity, rcfg, rcam, k0)
        return ref.initialize(d["frames"][0].to(dev), d["times"][0].to(dev),
                              rcfg, rcam)


def _eager_sample(h, dev, eager, sessions, frame_in, start, cfg) -> dict:
    """``eager_steps`` calls of the uncompiled step from the state at the
    start of the profiled slice, on the frames that follow it, under the
    profiler: the program's ``vio.*`` spans give each layer's device time.
    The states around each call give the tracking work it had to do
    (``roofline/track.py``)."""
    import torch

    from portbench.roofline import track as roof

    sess, i, es = start
    d = sessions[sess % len(sessions)]
    n = min(int(h.traffic["eager_steps"]), d["frames"].shape[0] - i)
    xs = [[v.to(dev) for v in frame_in(d, i + j)] for j in range(n)]
    es, _ = eager(es, *xs[0])                      # warm the eager path
    states = [es]
    h.sync(dev)
    prof = tr.profiler(dev)
    with prof:
        for x in xs[1:]:
            es, _ = eager(es, *x)
            states.append(es)
    h.sync(dev)
    steps = len(states) - 1
    out = {"eager_steps": steps, "spans_ms": {}}
    if dev.type != "cuda" or steps == 0:
        return out
    out["spans_ms"] = tr.span_device_ms(prof, steps)
    c = h.config["camera"]
    shapes = roof.level_shapes(int(c["height"]), int(c["width"]),
                               cfg.klt_max_pyramid_level, cfg.klt_window_size)

    def px(uv):
        return torch.stack([uv[:, 0] * c["fx"] + c["cx"],
                            uv[:, 1] * c["fy"] + c["cy"]], -1)

    nbytes = flops = 0
    for pre, post in zip(states[:-1], states[1:]):
        a, b = pre.filt, post.filt
        tracked = a.active & b.active & (b.age > 0)
        w = roof.work(px(a.klt_ref), px(b.klt_ref), tracked,
                      int(a.active.sum()), shapes, cfg.klt_window_size)
        nbytes, flops = nbytes + w[0], flops + w[1]
    try:
        out["track_bound_ms"] = roof.bound_s(
            nbytes, flops, torch.cuda.get_device_name(dev)) * 1e3 / steps
    except KeyError:
        pass
    return out
