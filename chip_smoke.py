#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ekf_vio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py    # run every phase; needs one card

Phases, each raising on failure (a non-zero exit); no phase's failure is
caught and nothing falls back to the CPU:
 1. device: the card's name and power limit, torch / CUDA / nvcc / triton
    versions; TF32 off.
 2. build: the three CUDA kernels of ekf_vio_tpu_torch/csrc, one nvcc
    each, one after another.
 3. lk_level against its plain twin on the card, one launch per pyramid
    call against ``klt.track_pyramid_plain``: bench frames 0 -> 1 at
    160x120 with the 128 seeds ``initialize`` produces (levels 0-2) and
    the first 100 of them, one 640x480 level, rendered 320x240 frames
    0 -> 1 (levels 0-3) and their level 3 alone; and one launch per level
    (``track_level_cuda``) against ``track_level_plain`` on the same
    frames.  Status identical; points within 2e-3 px, err within 1e-2
    and min_eig within rtol 1e-3 where tracked.
 4. fast9 against its plain twin: bitwise on integer-valued 160x120,
    320x240, 117x203 and 235x301 frames (the last two off the tile grid,
    margin after / before NMS), within 1e-4 on fractional frames.
 5. klt_level against its plain twin: rendered 320x240 frames 0 -> 1 with
    the 128 seeds of ``initialize_imu``'s detection: levels 0-2 at win 17,
    level 0 at win 21, seeds within 17 px of the border, NaN and invalid
    rows, N = 100; the same bar as lk_level.
 6. timings of each kernel and its twin at the main path's shapes: one
    ``track`` call of lk_level at 160x120 (3 levels) and 320x240 (4
    levels), and the same with no iteration, with each level's largest and
    mean number of iterations in which a feature moves; FAST at 160x120
    and 320x240; klt_level's 3 levels of path (b).  Device time (torch.profiler kernel
    durations), wall time (CUDA events), and the roofline bound of the
    same work.
 7. the vision path: ``engine.run_sequence`` over 120 bench frames
    downscaled on the card (one warm-up, best of 3): finite state, more
    than 10 tracks from frame 5 on, the 'cuda_lk' backend, the launch
    counts (lk_level T-1, fast9 T), and a 10-frame rollout on the card
    against the CPU.
 8. path (a): ``engine.run_sequence_imu`` over 120 rendered 320x240
    frames at configs/mono_inertial.yaml's values (one warm-up, best of
    2): 'cuda_lk', lk_level = T-1 and fast9 = T-9 launches, finite
    state, more than 10 tracks from 5 frames after the initialization,
    ATE under 0.01 m, and a 15-frame rollout on the card against the CPU.
 9. path (b): the same with klt_window_size=17: 'cuda_klt', klt_level =
    3(T-1) and lk_level = T-1 launches, finite state, more than 10 tracks.
10. torch.profiler traces of 5 steady-state steps of each path (the
    vision step, the IMU step): kernels per step, time per ``vio.*``
    layer, the device's busy share.
Each path runs with every launch count set to 0 just before it and read
just after.  The JSON line before the card line lists each kernel with
its launches on those runs, its largest error against its twin, its
device time and its twin's at the slice's shapes, and the roofline bound
of that work.  The line before the last is the card's name and power
limit; the last line is {"ok": true, "device": {...}}.  Imports nothing
of JAX.
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
N_MONO = 120          # rendered frames of the mono-inertial paths
PEAK_F32 = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_HBM = 3.35e12    # H100 SXM HBM bytes/s


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
    """One nvcc per kernel, one after another."""
    from ekf_vio_tpu_torch import cuda_lib

    t_all = time.perf_counter()
    for name in ("lk_level", "fast9", "klt_level"):
        t0 = time.perf_counter()
        path = cuda_lib.build(name)
        cuda_lib.load(name)
        print(f"[build] {name}: {time.perf_counter() - t0:.2f} s -> "
              f"{os.path.relpath(path)}")
    print(f"[build] all: {time.perf_counter() - t_all:.2f} s")


def _cam(s: int):
    from ekf_vio_tpu_torch.frontend.camera import Camera

    w, h = W_IN // s, H_IN // s
    return Camera.from_K([[458.0 / s, 0, w / 2], [0, 458.0 / s, h / 2],
                          [0, 0, 1]], w, h)


def _bench_cfg():
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig(max_features=128, min_new_feature_dist=8.0,
                     fast_threshold=30)


def _lk_inputs(frames_small, mono2, dev):
    """The main path's LK inputs: bench frames 0 -> 1 at 160x120 with the
    128 seeds of ``initialize``, and rendered 320x240 frames 0 -> 1 with
    those of ``initialize_imu``'s detection, as {shape: (prev pyramid, cur
    pyramid, level-0 points [128, 2], valid [128])}."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, pyramid

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    es = engine.initialize(frames_small[0], torch.zeros((), device=dev), cfg,
                           cam)
    px = camera.metric_to_pixel(cam, es.filt.klt_ref)
    mpx, mvalid = _mono_seeds(mono2[0], _mono_cfg())
    return {"160x120": (pyramid.build_pyramid(frames_small[0], 3),
                        pyramid.build_pyramid(frames_small[1], 3), px,
                        es.filt.active),
            "320x240": (pyramid.build_pyramid(mono2[0], 3),
                        pyramid.build_pyramid(mono2[1], 3), mpx, mvalid)}


def phase_lk(inputs, frames_full) -> float:
    """Kernel A against its twin on identical inputs: one launch per
    pyramid call, then one per level.  Returns the max |Δpoint| over
    tracked rows."""
    from ekf_vio_tpu_torch.frontend import klt, lk_cuda

    cfg = _bench_cfg()
    pp, cp, px, valid = inputs["160x120"]
    mp, mc, mpx, mvalid = inputs["320x240"]
    # (name, prev pyramid, cur pyramid, level-0 points, valid, lo, hi)
    calls = [("160x120 levels 0-2 n=128", pp, cp, px, valid, 0, 2),
             ("160x120 levels 0-2 n=100", pp, cp, px[:100].contiguous(),
              valid[:100].contiguous(), 0, 2),
             # the full-resolution frame with the seeds scaled up
             ("640x480 level 0 n=128", [frames_full[0]], [frames_full[1]],
              px * 4.0, valid, 0, 0),
             ("320x240 rendered levels 0-3 n=128", mp, mc, mpx, mvalid, 0, 3),
             ("320x240 rendered level 3 alone n=128", mp, mc, mpx, mvalid, 3,
              3)]
    kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
              eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen)
    worst = 0.0
    for name, prev, cur, p0, v, lo, hi in calls:
        got = lk_cuda.track_pyramid_cuda(prev, cur, p0, p0, v, lo=lo, hi=hi,
                                         **kw)
        ref = klt.track_pyramid_plain(prev, cur, p0, p0, v, lo=lo, hi=hi,
                                      **kw)
        worst = max(worst, _level_cases_agree("lk", f"pyramid {name}", got,
                                              ref, v))
    # one launch per level, each seeded at its own points
    for name, prev, cur, p0, v, lo, hi in calls[:-1]:
        for lvl in range(lo, hi + 1):
            q = (p0 / 2 ** lvl).contiguous()
            args = (prev[lvl], cur[lvl], q, q, v)
            got = lk_cuda.track_level_cuda(*args, **kw, gate_eig=lvl == 0)
            ref = klt.track_level_plain(*args, **kw, gate_eig=lvl == 0)
            worst = max(worst, _level_cases_agree(
                "lk", f"{name}: level {lvl} in its own launch", got, ref, v))
    return worst


def phase_fast(frames_small, frames_full, mono2) -> float:
    """Kernel B against its twin, at both margin orders.  Returns the max
    |Δscore|."""
    from ekf_vio_tpu_torch.frontend import fast, fast_cuda

    # sides off the 32 x 8 tile grid, below and above 128x256 px
    odd = []
    for h, w in ((117, 203), (235, 301)):
        crop = frames_full[0][40: 40 + h, 60: 60 + w].contiguous()
        odd += [(f"{h}x{w} crop integer-valued", torch.round(crop), True),
                (f"{h}x{w} crop fractional", crop, False)]
    cases = [("160x120 integer-valued", torch.round(frames_small[0]), True),
             ("160x120 fractional", frames_small[0], False),
             ("640x480 fractional", frames_full[0], False),
             ("320x240 rendered integer-valued", torch.round(mono2[0]), True),
             ("320x240 rendered fractional", mono2[0], False)] + odd
    worst = 0.0
    for name, img, exact in cases:
        thr = 25.0 if "rendered" in name else 30.0
        got = fast_cuda.detect_cuda(img.contiguous(), thr)
        ref = fast.detect(img, thr)
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


def _reset_counts() -> None:
    from ekf_vio_tpu_torch.frontend import fast_cuda, klt_cuda, lk_cuda

    lk_cuda.launches = fast_cuda.launches = klt_cuda.launches = 0


def _counts() -> dict:
    from ekf_vio_tpu_torch.frontend import fast_cuda, klt_cuda, lk_cuda

    return {"lk_level": lk_cuda.launches, "fast9": fast_cuda.launches,
            "klt_level": klt_cuda.launches}


def phase_main_path(frames_dev, times_dev, dev, card: str) -> dict:
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import (camera, fast_cuda, klt, klt_cuda,
                                            lk_cuda)

    cfg = _bench_cfg()
    s = cfg.inverse_image_scale
    cam = _cam(s)
    small = camera.downscale_image(frames_dev, s).contiguous()
    n = small.shape[0]
    backend = klt.selected_backend(small.shape[1:], cfg.max_features, cfg,
                                   small.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")

    best = float("inf")
    counts = None
    for rep in range(4):  # one warm-up, then best of 3
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = engine.run_sequence(small, times_dev, cfg, cam)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (lk_cuda.launches, fast_cuda.launches)
        all_counts = _counts()
        if counts != (n - 1, n):
            raise AssertionError(f"launch counts {counts}, expected "
                                 f"{(n - 1, n)}")
        if klt_cuda.launches:
            raise AssertionError("klt_level ran on the vision path")
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
                                 cam, device="cpu")
    same_tracked = torch.equal(gpu.num_tracked.cpu(), cpu.num_tracked)
    same_active = torch.equal(gpu.num_active.cpu(), cpu.num_active)
    dmu = (gpu.base_mu.cpu() - cpu.base_mu).abs().max().item()
    print(f"[main] {k}-frame rollout, card vs CPU twins: num_tracked equal "
          f"{same_tracked}, num_active equal {same_active}, max|dbase_mu| "
          f"{dmu:.3e}")
    if not (same_tracked and same_active and dmu < 5e-3):
        raise AssertionError("card and CPU rollouts disagree")
    return {"fps": fps, "launches": all_counts}


# --------------------------------------------------------------------------
# The mono-inertial slice: configs/mono_inertial.yaml on rendered 320x240
# --------------------------------------------------------------------------


def _mono_cfg(win: int = 21):
    """configs/mono_inertial.yaml's values, built in code (the card's
    machine may lack PyYAML)."""
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig(num_features=100, max_features=128, use_imu=True,
                     triangulate_new_features=True, vi_init_frames=10,
                     klt_measurement_variance_px=0.001, q_feature=1e-7,
                     min_new_feature_dist=10.0, fast_threshold=25,
                     inverse_image_scale=2, klt_window_size=win)


def _mono_seeds(img, cfg):
    """initialize_imu's frame-0 detection: (px [128, 2], valid [128])."""
    from ekf_vio_tpu_torch.frontend import replenish

    n = cfg.max_features
    return replenish.replenish(
        img, torch.zeros(n, 2, device=img.device),
        torch.zeros(n, dtype=torch.bool, device=img.device), cfg, n)


def _mono_cam(seq):
    from ekf_vio_tpu_torch.frontend.camera import Camera

    h, w = seq.frames.shape[1:]
    return Camera.from_K(seq.K, w, h)


def _level_cases_agree(tag, name, got, ref, valid) -> float:
    """The kernel bar on one level: status identical, the same finiteness,
    points within 2e-3 px, err within 1e-2 and min_eig within rtol 1e-3
    where tracked.  Returns max |Δpoint| over tracked rows."""
    g, ok, eig, err = got
    rg, rok, reig, rerr = ref
    torch.cuda.synchronize()
    ok_n, rok_n = ok.cpu().numpy(), rok.cpu().numpy()
    if not (ok_n == rok_n).all():
        raise AssertionError(f"[{tag}] {name}: status differs at rows "
                             f"{np.nonzero(ok_n != rok_n)[0].tolist()}")
    if not torch.equal(torch.isfinite(g), torch.isfinite(rg)):
        raise AssertionError(f"[{tag}] {name}: finiteness differs")
    tracked = ok & valid
    if tracked.sum() < 0.5 * valid.sum():
        raise AssertionError(f"[{tag}] {name}: only {int(tracked.sum())} "
                             f"of {int(valid.sum())} tracked")
    dp = (g - rg)[tracked].abs().max().item()
    de = (err - rerr)[tracked].abs().max().item()
    rel_eig = ((eig - reig)[tracked].abs() / reig[tracked].abs()).max().item()
    print(f"[{tag}] {name}: tracked {int(tracked.sum())}/{int(valid.sum())}, "
          f"status identical, max|dpoint| {dp:.3e} px, max|derr| {de:.3e}, "
          f"max rel dmin_eig {rel_eig:.3e}")
    if not (dp <= 2e-3 and de <= 1e-2 and rel_eig <= 1e-3):
        raise AssertionError(f"[{tag}] {name}: outside the bar")
    return dp


def phase_klt(mono2) -> float:
    """klt_level against its twin on the slice's inputs.  Returns the max
    |Δpoint| over tracked rows."""
    from ekf_vio_tpu_torch.frontend import klt, klt_cuda, pyramid

    cfg = _mono_cfg(17)
    px, valid = _mono_seeds(mono2[0], cfg)
    pp = pyramid.build_pyramid(mono2[0], 3)
    cp = pyramid.build_pyramid(mono2[1], 3)
    cases = [(f"win 17 level {lvl} n=128", lvl, 17, px / 2 ** lvl, valid)
             for lvl in range(3)]
    cases.append(("win 21 level 0 n=128", 0, 21, px, valid))
    border = px.clone()
    border[:6] = torch.tensor([[2.5, 2.5], [316.0, 120.0], [150.0, 236.5],
                               [10.2, 200.7], [305.3, 8.9], [40.0, 16.0]],
                              device=px.device)
    vb = valid.clone()
    vb[:6] = True
    cases.append(("win 17 level 0, 6 seeds within 17 px of the border",
                  0, 17, border, vb))
    nan = px.clone()
    nan[5] = float("nan")
    vn = valid.clone()
    vn[[5, 9, 11]] = False
    cases.append(("win 17 level 0, NaN and invalid rows", 0, 17, nan, vn))
    cases.append(("win 17 level 0 n=100", 0, 17, px[:100].contiguous(),
                  valid[:100].contiguous()))
    worst = 0.0
    for name, lvl, win, q, v in cases:
        q = q.contiguous()
        g0 = q.clone()
        if "NaN" in name:
            g0[9] = float("nan")
        kw = dict(win=win, iters=cfg.klt_iterations, eps=cfg.klt_eps,
                  min_eigen=cfg.klt_min_eigen if lvl == 0 else -1.0)
        got = klt_cuda.track_level_cuda(pp[lvl], cp[lvl], q, g0, v, **kw)
        ref = klt.track_level_klt_plain(pp[lvl], cp[lvl], q, g0, v, **kw)
        worst = max(worst, _level_cases_agree("klt", name, got, ref, v))
    return worst


def _union_bytes(h: int, w: int, corners, size: int) -> int:
    """Bytes of the distinct f32 pixels in size x size squares at the
    integer top-left corners [M, 2] (x, y), rows and columns clamped into
    the image."""
    ar = torch.arange(size, device=corners.device)
    ys = (corners[:, 1, None] + ar).clamp(0, h - 1)
    xs = (corners[:, 0, None] + ar).clamp(0, w - 1)
    mask = torch.zeros(h, w, dtype=torch.bool, device=corners.device)
    mask[ys[:, :, None], xs[:, None, :]] = True
    return int(mask.sum()) * 4


def _level_work(prev, q, path, win: int):
    """(bytes, flops, moves) that one LK level must move and do for these
    inputs, and each feature's number of iterations in which it moves,
    given ``path`` [iters + 1, N, 2], each feature's position after 0, 1,
    ... iterations.  A win x win window at a fractional centre reads
    (win + 1)^2 taps.  Bytes: the distinct prev pixels under the taps and
    their Scharr halo, the distinct cur pixels under the taps at every
    position a feature takes, the per-feature inputs and outputs.  Flops
    per feature: Scharr at the taps (12 a tap: smooth, then difference, in
    x and y); the template and gradient windows (6 a window pixel each,
    the bilinear blend separated) and the Hessian (6); the final residual
    (9); and 11 a window pixel (window 6, residual 1, two products 4) for
    each iteration in which the feature is live, that is, moves."""
    h, w = prev.shape
    n = q.shape[0]
    half = (win - 1) // 2

    def corners(pts, lo):
        pts = torch.nan_to_num(pts).clamp(-2 * win, max(h, w) + 2 * win)
        return torch.floor(pts).long() - lo

    nbytes = (_union_bytes(h, w, corners(q, half + 1), win + 3)
              + _union_bytes(h, w, corners(path.reshape(-1, 2), half),
                             win + 1)
              + n * (8 + 8 + 1) + n * (8 + 1 + 4 + 4))
    moves = ((path[1:] != path[:-1]).any(-1)
             & torch.isfinite(path[1:]).all(-1)).sum(0)
    ww = win * win
    flops = n * (12 * (win + 1) ** 2 + 33 * ww) + 11 * ww * int(moves.sum())
    return nbytes, flops, moves


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _pyramid_work(pp, cp, px, valid, cfg, lo: int, hi: int):
    """(bytes, flops, {level: moves}) of one lk_level pyramid call, the
    guesses chained through the levels as the kernel chains them; each
    level's path is read off the plain twin stopped after 0, 1, ... iters
    iterations, and ``moves`` are the iterations in which each feature
    valid at that level moves."""
    from ekf_vio_tpu_torch.frontend import klt

    win = cfg.klt_window_size
    g, ok = px / float(2 ** hi), valid
    nbytes = flops = 0
    moves = {}
    for lvl in range(hi, lo - 1, -1):
        q = px / float(2 ** lvl)
        runs = [klt.track_level_plain(pp[lvl], cp[lvl], q, g, ok, win=win,
                                      iters=k, eps=cfg.klt_eps,
                                      min_eigen=cfg.klt_min_eigen,
                                      gate_eig=lvl == 0)
                for k in range(cfg.klt_iterations + 1)]
        b, f, m = _level_work(pp[lvl], q, torch.stack([r[0] for r in runs]),
                              win)
        nbytes, flops = nbytes + b, flops + f
        moves[lvl] = m[ok]
        g, ok = runs[-1][:2]
        if lvl > lo:
            g = g * 2.0
    return nbytes, flops, moves


def _timed(fn, reps: int):
    """(device ms, wall ms) per call."""
    return _device_ms(fn, reps), _wall_ms(fn, reps)


def _in_turns(variants: dict, reps: int) -> dict:
    """(device ms, wall ms) of each variant, measured in turns A B B A and
    averaged over its two turns."""
    keys = list(variants)
    got = {k: [] for k in keys}
    for k in keys + keys[::-1]:
        got[k].append(_timed(variants[k], reps))
    return {k: tuple(sum(x) / 2 for x in zip(*v)) for k, v in got.items()}


def _us(ms: float) -> str:
    return f"{ms * 1e3:.1f} us"


def phase_timings(inputs, card: str) -> dict:
    """Each kernel against its twin at the main path's shapes: one
    lk_level ``track`` call (160x120: 3 levels, the vision path; 320x240: 4
    levels, path (a)), and the same call with no iteration (its fixed
    part), one FAST call at both sizes, and klt_level's 3 levels of path
    (b).  Device and wall time, and the roofline bound of the same work.
    Returns {name: {shape: {...}}} in ms."""
    from ekf_vio_tpu_torch.frontend import (fast, fast_cuda, klt, klt_cuda,
                                            lk_cuda)

    cfg = _bench_cfg()
    kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
              eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen)
    out = {"lk_level": {}, "fast9": {}, "klt_level": {}}
    for shape, hi in (("160x120", 2), ("320x240", 3)):
        pp, cp, px, valid = inputs[shape]
        nbytes, flops, moves = _pyramid_work(pp, cp, px, valid, cfg, 0, hi)
        for lvl, m in moves.items():
            print(f"[time] lk_level {shape} level {lvl}: a feature moves in "
                  f"at most {int(m.max())} iterations, {m.float().mean():.2f} "
                  f"on average ({m.numel()} features)")
        times = _in_turns({
            "kernel": lambda: lk_cuda.track_pyramid_cuda(
                pp, cp, px, px, valid, lo=0, hi=hi, **kw),
            # the prologue and the gathers alone
            "0 iterations": lambda: lk_cuda.track_pyramid_cuda(
                pp, cp, px, px, valid, lo=0, hi=hi, **dict(kw, iters=0))},
            200)
        plain = _timed(lambda: klt.track_pyramid_plain(
            pp, cp, px, px, valid, lo=0, hi=hi, **kw), 5)
        out["lk_level"][shape] = _entry(times, plain, _bound(nbytes, flops))
    for shape, thr in (("160x120", 30.0), ("320x240", 25.0)):
        img = inputs[shape][0][0].contiguous()
        h, w = img.shape
        times = {"kernel": _timed(lambda: fast_cuda.detect_cuda(img, thr),
                                  200)}
        plain = _timed(lambda: fast.detect(img, thr), 50)
        # per pixel: 16 ring differences, 16 |d| - t, 16 tests of |d| > t
        # (the sign of d tells bright from dark), the 16 arc sums as one
        # sliding 9-sum around the ring (8 + 2 x 15), 15 maxima over the
        # arcs, 8 NMS comparisons: 109
        out["fast9"][shape] = _entry(times, plain,
                                     _bound(2 * h * w * 4, h * w * 109))

    # klt_level: path (b)'s levels 0-2 at win 17, one launch each
    kcfg = _mono_cfg(17)
    pp, cp = inputs["320x240"][:2]
    px, valid = _mono_seeds(pp[0], kcfg)
    qs = [(px / 2 ** lvl).contiguous() for lvl in range(3)]
    kkw = dict(win=17, iters=kcfg.klt_iterations, eps=kcfg.klt_eps)

    def levels(fn):
        def run():
            for lvl in range(3):
                fn(pp[lvl], cp[lvl], qs[lvl], qs[lvl], valid, **kkw,
                   min_eigen=kcfg.klt_min_eigen if lvl == 0 else -1.0)
        return run

    nbytes = flops = 0
    for lvl in range(3):
        path = torch.stack([klt.track_level_klt_plain(
            pp[lvl], cp[lvl], qs[lvl], qs[lvl], valid, **dict(kkw, iters=k),
            min_eigen=kcfg.klt_min_eigen if lvl == 0 else -1.0)[0]
            for k in range(kcfg.klt_iterations + 1)])
        b, f, _ = _level_work(pp[lvl], qs[lvl], path, 17)
        nbytes, flops = nbytes + b, flops + f
    out["klt_level"]["320x240"] = _entry(
        {"kernel": _timed(levels(klt_cuda.track_level_cuda), 200)},
        _timed(levels(klt.track_level_klt_plain), 5), _bound(nbytes, flops))
    out["klt_level"]["320x240"]["launches_per_call"] = 3

    for name, by_shape in out.items():
        for shape, t in by_shape.items():
            variants = "; ".join(
                f"{k}: {_us(d)} device / {_us(wl)} wall"
                for k, (d, wl) in t["variants"].items())
            print(f"[time] {name} per call at {shape}, n=128 "
                  f"({t['launches_per_call']} launch"
                  f"{'es' if t['launches_per_call'] > 1 else ''}): kernel "
                  f"{_us(t['device'][0])} device / {_us(t['wall'][0])} wall "
                  f"[{variants}]; plain twin {_us(t['device'][1])} device / "
                  f"{_us(t['wall'][1])} wall; bound {t['bound_ms'] * 1e3:.3f} "
                  f"us ({t['bound_by']}) ({card})")
    return out


def _entry(times: dict, plain, bound) -> dict:
    """One kernel's timing record: the kernel's (device, wall) beside the
    twin's, every variant's, and the bound."""
    return {"device": (times["kernel"][0], plain[0]),
            "wall": (times["kernel"][1], plain[1]),
            "variants": times,
            "bound_ms": bound[0], "bound_by": bound[1],
            "launches_per_call": 1}


def _ate(seq, outs, start: int) -> float:
    from ekf_vio_tpu_torch.io.trajectory import ate_rmse

    p_est = outs.base_mu[:, 0:3].cpu().numpy()
    return ate_rmse(seq.times[start:], p_est, seq.times, seq.gt_pos)


def phase_mono_path(seq, win: int, card: str) -> dict:
    """``run_sequence_imu`` over the rendered sequence on the card (one
    warm-up, best of 2), with its backend and launch counts asserted."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import klt

    cfg = _mono_cfg(win)
    cam = _mono_cam(seq)
    k0 = cfg.vi_init_frames
    n = seq.frames.shape[0]
    h, w = seq.frames.shape[1:]
    want_backend = "cuda_lk" if win == 21 else "cuda_klt"
    backend = klt.selected_backend((h, w), cfg.max_features, cfg, "cuda")
    if backend != want_backend:
        raise AssertionError(f"tracker backend: {backend}")
    want = ({"lk_level": n - 1, "fast9": n - k0 + 1, "klt_level": 0}
            if win == 21 else
            {"lk_level": n - 1, "fast9": n - k0 + 1, "klt_level": 3 * (n - 1)})
    args = (seq.frames, seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
            seq.gravity_w)
    dev_args = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                     for a in args)
    best = float("inf")
    for rep in range(3):  # one warm-up, then best of 2
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        es, outs = engine.run_sequence_imu(*dev_args, cfg, cam,
                                           init_frames=k0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _counts()
        if counts != want:
            raise AssertionError(f"launch counts {counts}, expected {want}")
        if rep:
            best = min(best, dt)
    tracked = outs.num_tracked.cpu().numpy()
    if not (torch.isfinite(outs.base_mu).all()
            and torch.isfinite(es.filt.Sigma).all()):
        raise AssertionError("non-finite state")
    if tracked[5:].min() <= 10:
        raise AssertionError(f"lost tracking: {tracked.tolist()}")
    ate = _ate(seq, outs, k0)
    fps = (n - 1) / best
    tag = "a" if win == 21 else "b"
    print(f"[path {tag}] run_sequence_imu, {n} rendered frames 320x240, "
          f"128 slots, win {win}, backend {backend}: {fps:.1f} frames/s "
          f"(best of 2: {best * 1e3:.1f} ms) on {card}; tracked min "
          f"{tracked[5:].min()} mean {tracked.mean():.1f}; ATE "
          f"{ate * 1e3:.2f} mm; launches {counts}")
    if win == 21 and not ate < 0.01:
        raise AssertionError(f"ATE {ate:.4f} m is not under 0.01 m")
    return {"fps": fps, "launches": counts, "ate": ate,
            "step_ms": 1e3 * best / (n - 1)}


def phase_mono_cpu_rollout(seq) -> None:
    """A 15-frame mono-inertial rollout on the card against the same on
    the CPU (plain twins): every count equal, base_mu within 5e-3 (GPU
    matmul order and reduction order compound over the steps)."""
    from ekf_vio_tpu_torch import engine

    cfg = _mono_cfg()
    cam = _mono_cam(seq)
    k = 15
    args = tuple(a[:m] for a, m in ((seq.frames, k), (seq.times, k),
                                     (seq.imu_dt, k - 1),
                                     (seq.imu_gyro, k - 1),
                                     (seq.imu_accel, k - 1))) + (
        seq.gravity_w,)
    _, gpu = engine.run_sequence_imu(*args, cfg, cam,
                                     init_frames=cfg.vi_init_frames)
    _, cpu = engine.run_sequence_imu(*args, cfg, cam,
                                     init_frames=cfg.vi_init_frames,
                                     device="cpu")
    same_tracked = torch.equal(gpu.num_tracked.cpu(), cpu.num_tracked)
    same_active = torch.equal(gpu.num_active.cpu(), cpu.num_active)
    dmu = (gpu.base_mu.cpu() - cpu.base_mu).abs().max().item()
    print(f"[path a] {k}-frame rollout, card vs CPU twins: num_tracked "
          f"{gpu.num_tracked.tolist()} vs {cpu.num_tracked.tolist()}, "
          f"num_active equal {same_active}, max|dbase_mu| {dmu:.3e}")
    if not (same_tracked and same_active and dmu < 5e-3):
        raise AssertionError("card and CPU mono-inertial rollouts disagree")


def phase_mono_profile(seq, step_ms: float) -> None:
    """torch.profiler over 5 steady-state IMU steps of path (a)."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.core import imu

    cfg = _mono_cfg()
    cam = _mono_cam(seq)
    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(seq, k))).cuda()
         for k in ("frames", "times", "imu_dt", "imu_gyro", "imu_accel",
                   "gravity_w")}
    k0 = cfg.vi_init_frames
    es = engine.initialize_imu(t["frames"], t["times"], t["imu_dt"],
                               t["imu_gyro"], t["imu_accel"], t["gravity_w"],
                               cfg, cam, k0)

    def steps(es, lo, hi):
        for i in range(lo, hi):
            batch = imu.ImuSample(t["imu_dt"][i - 1], t["imu_gyro"][i - 1],
                                  t["imu_accel"][i - 1])
            es, _ = engine.step(es, t["frames"][i], t["times"][i], cfg, cam,
                                imu_batch=batch, gravity_w=t["gravity_w"])
        return es

    es = steps(es, k0, k0 + 5)
    _profile_steps(lambda: steps(es, k0 + 5, k0 + 10), step_ms, "imu step")


def _profile_steps(run, step_ms: float, what: str) -> None:
    """torch.profiler over ``run`` (5 steps): device kernels per step,
    host and device time of each ``vio.*`` layer, the device's busy share
    of a step of ``step_ms``, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device-side events of the vio.* spans are annotations spanning the
    # layer on the GPU timeline, not kernels: keep them out of the sums
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not e.key.startswith("vio.")]
    device_us = sum(e.self_device_time_total for e in kernels) / 5
    print(f"[profile {what}] per step: "
          f"{sum(e.count for e in kernels) / 5:.0f} device kernels, "
          f"{device_us:.0f} us of kernel time = "
          f"{100 * device_us / (step_ms * 1e3):.1f} % of the {step_ms:.2f} ms "
          f"step")
    layers = [e for e in events
              if e.key.startswith("vio.") and e.cpu_time_total > 0]
    for e in sorted(layers, key=lambda e: -e.cpu_time_total):
        print(f"[profile {what}] {e.key}: host {e.cpu_time_total / 5:.0f} "
              f"us/step (under the profiler), kernels "
              f"{e.device_time_total / 5:.0f} us/step")
    table = events.table(sort_by="self_device_time_total", row_limit=12,
                          max_name_column_width=60)
    print("\n".join(f"[profile {what}] " + line
                    for line in table.splitlines()))


def phase_profile(frames_dev, times_dev, step_ms: float) -> None:
    """torch.profiler over 5 steady-state steps of the vision path."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    small = camera.downscale_image(frames_dev[:16], 4).contiguous()
    es = engine.initialize(small[0], times_dev[0], cfg, cam,
                           device=small.device)
    for i in range(1, 10):
        es, _ = engine.step(es, small[i], times_dev[i], cfg, cam)

    def run():
        e = es
        for i in range(10, 15):
            e, _ = engine.step(e, small[i], times_dev[i], cfg, cam)

    _profile_steps(run, step_ms, "vision step")


def _kernel_entry(name, module, route, launches, err, by_shape) -> dict:
    """The kernel's line: times and bound at 320x240 (the mono-inertial
    slice, every kernel runs there), and every shape timed under
    ``by_shape``."""
    t = by_shape["320x240"]
    return {"name": name, "route": route, "source": module.SOURCE,
            "replaces": module.REPLACES, "launches": launches,
            "max_abs_err": err, "ms": t["device"][0],
            "plain_ms": t["device"][1], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "wall_ms": t["wall"][0], "plain_wall_ms": t["wall"][1],
            "launches_per_call": t["launches_per_call"],
            "by_shape": by_shape}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found", file=sys.stderr)
        return 2
    from ekf_vio_tpu_torch.frontend import (camera, fast_cuda, klt_cuda,
                                            lk_cuda)
    from ekf_vio_tpu_torch.sim import rendered
    from ekf_vio_tpu_torch.sim.frames import make_frames

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    phase_device(card)
    phase_build()

    frames, times = make_frames(seed=0, n_frames=120)
    frames_dev = torch.from_numpy(frames).to(dev)
    times_dev = torch.from_numpy(times).to(dev)
    small2 = camera.downscale_image(frames_dev[:2], 4).contiguous()
    seq = rendered.generate(num_frames=N_MONO)
    mono2 = torch.from_numpy(seq.frames[:2]).to(dev)
    inputs = _lk_inputs(small2, mono2, dev)
    lk_err = phase_lk(inputs, frames_dev[:2])
    fast_err = phase_fast(small2, frames_dev[:2], mono2)
    klt_err = phase_klt(mono2)
    timings = phase_timings(inputs, card)

    vision = phase_main_path(frames_dev, times_dev, dev, card)
    path_a = phase_mono_path(seq, 21, card)
    phase_mono_cpu_rollout(seq)
    path_b = phase_mono_path(seq, 17, card)
    phase_profile(frames_dev, times_dev, 1e3 / vision["fps"])
    phase_mono_profile(seq, path_a["step_ms"])

    runs = {"vision": vision["launches"], "path_a": path_a["launches"],
            "path_b": path_b["launches"]}
    for name in ("lk_level", "fast9", "klt_level"):
        if not any(r.get(name, 0) for r in runs.values()):
            raise AssertionError(f"{name} was never launched on a path")
    total = {name: sum(r.get(name, 0) for r in runs.values())
             for name in ("lk_level", "fast9", "klt_level")}
    kernels = [
        _kernel_entry("lk_level", lk_cuda, "cuda", total["lk_level"], lk_err,
                      timings["lk_level"]),
        _kernel_entry("fast9", fast_cuda, "cuda", total["fast9"], fast_err,
                      timings["fast9"]),
        _kernel_entry("klt_level", klt_cuda, "cuda", total["klt_level"],
                      klt_err, timings["klt_level"]),
    ]
    for k in kernels:
        k["launches_by_path"] = {p: r.get(k["name"], 0)
                                 for p, r in runs.items()}
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
