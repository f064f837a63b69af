#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ekf_vio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py    # run every phase; needs one card

Phases, each raising on failure (a non-zero exit):
 1. device: the card's name and power limit, torch / CUDA / nvcc / triton
    versions; TF32 off.
 2. build: both CUDA kernels from ekf_vio_tpu_torch/csrc with nvcc.
 3. lk_level against its plain twin on the card: bench frames 0 -> 1 at
    160x120 with the 128 seeds ``initialize`` produces (levels 0-2), one
    640x480 level, and an N = 100 case.  Status identical; points within
    2e-3 px, err within 1e-2 and min_eig within rtol 1e-3 where tracked.
 4. fast9 against its plain twin: bitwise on an integer-valued 160x120
    frame, within 1e-4 on the fractional downscaled frame.
 5. timings of each kernel and its twin at the main path's shapes: device
    time (torch.profiler kernel durations) and wall time (CUDA events).
 6. the main path: ``engine.run_sequence`` over the 240 bench frames
    downscaled on the card (one warm-up, best of 3), asserting a finite
    state, more than 10 tracks from frame 5 on, the 'cuda_lk' backend, and
    the launch counts (3 LK levels per step, one FAST call per frame); and
    a 10-frame rollout on the card against the same rollout on the CPU.
 7. a torch.profiler trace of 5 steps: kernels per step, time per layer,
    the device's busy share, the top device ops.
The JSON line before the card line gives each kernel's main-path launch
count and its device time per main-path frame beside its twin's.  The
line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

W_IN, H_IN = 640, 480


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device(card: str) -> None:
    from ekf_vio_tpu_torch import cuda_lib, engine

    engine.use_f32_matmul()
    nvcc = subprocess.run([cuda_lib.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    cutlass = os.path.isdir("/usr/local/cutlass/include")
    print(f"[device] {card} | torch {torch.__version__} | cuda "
          f"{torch.version.cuda} | nvcc: {nvcc} | triton {triton_version} | "
          f"cutlass headers {'present' if cutlass else 'absent'} | "
          f"python {sys.version.split()[0]}")


def phase_build() -> None:
    from ekf_vio_tpu_torch import cuda_lib

    for name in ("lk_level", "fast9"):
        t0 = time.perf_counter()
        path = cuda_lib.build(name)
        cuda_lib.load(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.2f} s -> "
              f"{os.path.relpath(path)}")


def _cam(s: int):
    from ekf_vio_tpu_torch.frontend.camera import Camera

    w, h = W_IN // s, H_IN // s
    return Camera.from_K([[458.0 / s, 0, w / 2], [0, 458.0 / s, h / 2],
                          [0, 0, 1]], w, h)


def _bench_cfg():
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig(max_features=128, min_new_feature_dist=8.0,
                     fast_threshold=30)


def phase_lk(frames_small, frames_full, dev) -> float:
    """Kernel A against its twin on identical inputs.  Returns the max
    |Δpoint| over tracked rows."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, klt, lk_cuda, pyramid

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    es = engine.initialize(frames_small[0], torch.zeros((), device=dev), cfg,
                           cam)
    prev_px = camera.metric_to_pixel(cam, es.filt.klt_ref)
    valid = es.filt.active
    pp = pyramid.build_pyramid(frames_small[0], 3)
    cp = pyramid.build_pyramid(frames_small[1], 3)
    cases = [(f"160x120 level {lvl} n=128", pp[lvl], cp[lvl],
              prev_px / 2 ** lvl, valid, lvl == 0) for lvl in range(3)]
    cases.append(("160x120 level 0 n=100", pp[0], cp[0],
                  prev_px[:100].contiguous(), valid[:100].contiguous(), True))
    # the full-resolution frame with the seeds scaled up: one 640x480 level
    cases.append(("640x480 level 0 n=128", frames_full[0], frames_full[1],
                  prev_px * 4.0, valid, True))
    worst = 0.0
    for name, prev, cur, q, v, gate in cases:
        kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
                  eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen,
                  gate_eig=gate)
        q = q.contiguous()
        g, ok, eig, err = lk_cuda.track_level_cuda(prev, cur, q, q, v, **kw)
        rg, rok, reig, rerr = klt.track_level_plain(prev, cur, q, q, v, **kw)
        torch.cuda.synchronize()
        ok_n, rok_n = ok.cpu().numpy(), rok.cpu().numpy()
        if not (ok_n == rok_n).all():
            raise AssertionError(f"[lk] {name}: status differs at rows "
                                 f"{np.nonzero(ok_n != rok_n)[0].tolist()}")
        if ok_n.sum() < 0.5 * v.sum().item():
            raise AssertionError(f"[lk] {name}: only {ok_n.sum()} tracked")
        m = ok
        dp = (g - rg)[m].abs().max().item()
        de = (err - rerr)[m].abs().max().item()
        rel_eig = ((eig - reig)[m].abs() / reig[m].abs()).max().item()
        print(f"[lk] {name}: tracked {int(ok_n.sum())}/{int(v.sum())}, "
              f"status identical, max|dpoint| {dp:.3e} px, max|derr| "
              f"{de:.3e}, max rel dmin_eig {rel_eig:.3e}")
        if not (dp <= 2e-3 and de <= 1e-2 and rel_eig <= 1e-3):
            raise AssertionError(f"[lk] {name}: outside the bar")
        worst = max(worst, dp)
    return worst


def phase_fast(frames_small, frames_full) -> float:
    """Kernel B against its twin.  Returns the max |Δscore|."""
    from ekf_vio_tpu_torch.frontend import fast, fast_cuda

    cases = [("160x120 integer-valued", torch.round(frames_small[0]), True),
             ("160x120 fractional", frames_small[0], False),
             ("640x480 fractional", frames_full[0], False)]
    worst = 0.0
    for name, img, exact in cases:
        got = fast_cuda.detect_cuda(img.contiguous(), 30.0)
        ref = fast.detect(img, 30.0)
        diff = (got - ref).abs().max().item()
        corners = int((ref > 0).sum().item())
        print(f"[fast] {name}: {corners} corners, max|dscore| {diff:.3e}")
        if corners < 20:
            raise AssertionError(f"[fast] {name}: too few corners")
        if exact and diff != 0.0:
            raise AssertionError(f"[fast] {name}: not bitwise equal")
        if diff > 1e-4:
            raise AssertionError(f"[fast] {name}: outside 1e-4")
        worst = max(worst, diff)
    return worst


def _wall_ms(fn, reps: int) -> float:
    """Mean time per call between CUDA events around ``reps`` calls: the
    cost on the path, including the host issuing the launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps: int) -> float:
    """Mean device time per call: the summed durations of the kernels
    ``reps`` calls launch, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type.name == "CUDA")
    return total_us / 1e3 / reps


def phase_timings(frames_small, dev, card: str) -> dict:
    """Per main-path frame at 160x120 with the 128 seeds of
    ``initialize``: LK's three level launches against the same three
    levels on the plain twin, and one FAST call against its twin.  Returns
    {name: {"device": (kernel, twin), "wall": (kernel, twin)}} in ms."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import (camera, fast, fast_cuda, klt,
                                            lk_cuda, pyramid)

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    es = engine.initialize(frames_small[0], torch.zeros((), device=dev), cfg,
                           cam)
    prev_px = camera.metric_to_pixel(cam, es.filt.klt_ref)
    valid = es.filt.active
    pp = pyramid.build_pyramid(frames_small[0], 3)
    cp = pyramid.build_pyramid(frames_small[1], 3)
    kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
              eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen)
    qs = [(prev_px / 2 ** lvl).contiguous() for lvl in range(3)]

    def lk(level_fn):
        def run():
            for lvl in range(3):
                level_fn(pp[lvl], cp[lvl], qs[lvl], qs[lvl], valid,
                         gate_eig=lvl == 0, **kw)
        return run

    img = frames_small[0].contiguous()
    fns = {"lk_level": (lk(lk_cuda.track_level_cuda),
                        lk(klt.track_level_plain), 200, 10),
           "fast9": (lambda: fast_cuda.detect_cuda(img, 30.0),
                     lambda: fast.detect(img, 30.0), 200, 50)}
    out = {}
    for name, (kernel, twin, k_reps, t_reps) in fns.items():
        out[name] = {
            "device": (_device_ms(kernel, k_reps), _device_ms(twin, t_reps)),
            "wall": (_wall_ms(kernel, k_reps), _wall_ms(twin, t_reps))}
        (kd, td), (kw_, tw) = out[name]["device"], out[name]["wall"]
        print(f"[time] {name} per frame at 160x120, n=128: kernel "
              f"{kd * 1e3:.1f} us device / {kw_ * 1e3:.1f} us wall; plain "
              f"twin {td * 1e3:.1f} us device / {tw * 1e3:.1f} us wall "
              f"({card})")
    return out


def phase_main_path(frames_dev, times_dev, dev, card: str) -> dict:
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, fast_cuda, klt, lk_cuda

    cfg = _bench_cfg()
    s = cfg.inverse_image_scale
    cam = _cam(s)
    small = camera.downscale_image(frames_dev, s).contiguous()
    n = small.shape[0]
    backend = klt.selected_backend(small.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")

    best = float("inf")
    counts = None
    for rep in range(4):  # one warm-up, then best of 3
        lk_cuda.launches = 0
        fast_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = engine.run_sequence(small, times_dev, cfg, cam)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (lk_cuda.launches, fast_cuda.launches)
        if counts != (3 * (n - 1), n):
            raise AssertionError(f"launch counts {counts}, expected "
                                 f"{(3 * (n - 1), n)}")
        if rep:
            best = min(best, dt)
    tracked = outs.num_tracked.cpu().numpy()
    if not torch.isfinite(outs.base_mu).all():
        raise AssertionError("non-finite base state")
    if tracked[5:].min() <= 10:
        raise AssertionError(f"lost tracking: {tracked.tolist()}")
    fps = (n - 1) / best
    print(f"[main] {n} frames 160x120, 128 slots: {fps:.1f} frames/s "
          f"(best of 3: {best * 1e3:.1f} ms) on {card}; tracked min "
          f"{tracked[5:].min()} mean {tracked.mean():.1f}; launches per run: "
          f"lk_level {counts[0]}, fast9 {counts[1]}")

    # a short rollout on the card against the plain twins on the CPU
    k = 10
    _, gpu = engine.run_sequence(small[:k], times_dev[:k], cfg, cam)
    _, cpu = engine.run_sequence(small[:k].cpu(), times_dev[:k].cpu(), cfg,
                                 cam)
    same_tracked = torch.equal(gpu.num_tracked.cpu(), cpu.num_tracked)
    same_active = torch.equal(gpu.num_active.cpu(), cpu.num_active)
    dmu = (gpu.base_mu.cpu() - cpu.base_mu).abs().max().item()
    print(f"[main] {k}-frame rollout, card vs CPU twins: num_tracked equal "
          f"{same_tracked}, num_active equal {same_active}, max|dbase_mu| "
          f"{dmu:.3e}")
    if not (same_tracked and same_active and dmu < 5e-3):
        raise AssertionError("card and CPU rollouts disagree")
    return {"fps": fps, "launches": {"lk_level": counts[0],
                                     "fast9": counts[1]}}


def phase_profile(frames_dev, times_dev, step_ms: float) -> None:
    """torch.profiler over 5 steady-state steps: device kernels per step,
    host and device time of each ``vio.*`` layer, the device's busy share
    of a main-path step (``step_ms``), and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    small = camera.downscale_image(frames_dev[:16], 4).contiguous()
    es = engine.initialize(small[0], times_dev[0], cfg, cam)
    for i in range(1, 10):
        es, _ = engine.step(es, small[i], times_dev[i], cfg, cam)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(10, 15):
            es, _ = engine.step(es, small[i], times_dev[i], cfg, cam)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events of the vio.* spans are annotations spanning the
    # layer on the GPU timeline, not kernels: keep them out of the sums
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.key.startswith("vio.")]
    device_us = sum(e.self_device_time_total for e in kernels) / 5
    print(f"[profile] per step: {sum(e.count for e in kernels) / 5:.0f} "
          f"device kernels, {device_us:.0f} us of kernel time = "
          f"{100 * device_us / (step_ms * 1e3):.1f} % of the {step_ms:.2f} ms "
          f"main-path step")
    layers = [e for e in events
              if e.key.startswith("vio.") and e.cpu_time_total > 0]
    for e in sorted(layers, key=lambda e: -e.cpu_time_total):
        print(f"[profile] {e.key}: host {e.cpu_time_total / 5:.0f} us/step "
              f"(under the profiler), kernels {e.device_time_total / 5:.0f} "
              f"us/step")
    table = events.table(sort_by="self_device_time_total", row_limit=15,
                          max_name_column_width=60)
    print("\n".join("[profile] " + line for line in table.splitlines()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 2
    from ekf_vio_tpu_torch.frontend import camera, fast_cuda, lk_cuda
    from ekf_vio_tpu_torch.sim.frames import make_frames

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    phase_device(card)
    phase_build()

    frames, times = make_frames(seed=0)
    frames_dev = torch.from_numpy(frames).to(dev)
    times_dev = torch.from_numpy(times).to(dev)
    small2 = camera.downscale_image(frames_dev[:2], 4).contiguous()
    lk_err = phase_lk(small2, frames_dev[:2], dev)
    fast_err = phase_fast(small2, frames_dev[:2])
    timings = phase_timings(small2, dev, card)
    main_run = phase_main_path(frames_dev, times_dev, dev, card)
    phase_profile(frames_dev, times_dev, 1e3 / main_run["fps"])

    kernels = [
        {"name": "lk_level", "route": "cuda", "source": lk_cuda.SOURCE,
         "replaces": lk_cuda.REPLACES,
         "launches": main_run["launches"]["lk_level"],
         "max_abs_err": lk_err, "ms": timings["lk_level"]["device"][0],
         "plain_ms": timings["lk_level"]["device"][1]},
        {"name": "fast9", "route": "cuda", "source": fast_cuda.SOURCE,
         "replaces": fast_cuda.REPLACES,
         "launches": main_run["launches"]["fast9"],
         "max_abs_err": fast_err, "ms": timings["fast9"]["device"][0],
         "plain_ms": timings["fast9"]["device"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
