#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ekf_vio_tpu_torch) on one CUDA card.

    python3 chip_smoke.py    # run every phase; needs one card

Phases, each raising on failure (a non-zero exit); no phase's failure is
caught and nothing falls back to the CPU.  Every rollout of the port runs
as one captured CUDA graph of its step, replayed once a frame
(``ekf_vio_tpu_torch/scan.py``).  Each path (vision, (a)-(h), (j), the
simulator, the CLI's streaming loop) runs graphed and eager (every
``scan.scan`` as the Python loop over the step) in turns, graph, eager,
graph, eager, on the same inputs: the launch counts
of every run, every count of the results equal, every float no further
from the eager result than a second eager run is; frames/s of both and
the host time of each capture on a line of its own.
 1. device: the card's name and power limit, torch / CUDA / nvcc / triton
    versions; TF32 off.
 2. build: the three CUDA kernels of ekf_vio_tpu_torch/csrc, one nvcc
    each, all started together.
 3. lk_level against its plain version on the card, one launch per
    pyramid call against ``klt.track_pyramid_plain``: bench frames 0 -> 1
    at 160x120 with the 128 seeds ``initialize`` produces (levels 0-2) and
    the first 100 of them, one 640x480 level, rendered 320x240 frames
    0 -> 1 (levels 0-3) and their level 3 alone, bench frames at 320x240
    with the 512 slots of path (c); and one launch per level
    (``track_level_cuda``) against ``track_level_plain`` on the same
    frames.  Status identical; points within 2e-3 px, err within 1e-2
    and min_eig within rtol 1e-3 where tracked.
 4. fast9 against its plain version: bitwise on integer-valued 160x120,
    320x240, 117x203 and 235x301 frames (the last two off the tile grid,
    margin after / before NMS), within 1e-4 on fractional frames.
 5. klt_level against its plain version on rendered 320x240 frames 0 -> 1
    with the 128 seeds of ``initialize_imu``'s detection: one launch per
    pyramid call (levels 2-0) against ``klt.track_pyramid_klt_plain`` at
    win 17 (N = 128, seeds within 17 px of the border, NaN and invalid
    rows, N = 100) and win 21, then one launch per level against
    ``track_level_klt_plain``; the same bar as lk_level.
 6. lanes: each kernel with a lane axis, one launch for B lanes against B
    one-lane launches (bitwise equal) and against the plain version with
    lanes (the bars of phases 3-5): lk_level at B = 16 on bench frames
    b -> b + 1 at 160x120 with 128 seeds each (one lane NaN, one all
    invalid), klt_level at B = 4 on rendered 320x240 frames (win 17, one
    lane all invalid), fast9 at B = 16 (160x120, one NaN lane) and B = 4
    (320x240), integer-valued and fractional.
 7. timings of each kernel and its plain version at the paths' shapes:
    one ``track`` call of lk_level at 160x120 (3 levels), 320x240 (4
    levels) and 320x240 with 512 slots, and of klt_level's 3 levels of
    path (b) (N = 128 and 512), each also with no iteration, with each
    level's largest and mean number of iterations in which a feature
    moves; FAST at 160x120 and 320x240 (rendered and bench frames); the
    lane shapes of paths (e) and (f) on the lanes those paths give the
    kernels (lk_level and fast9 at B = 16, klt_level at B = 4, bound = the
    lanes' summed work); the device
    kernels of one path (b) ``klt.track`` call; the QR of the square-root
    update's pre-array at 128 and 512 slots.  Device time (torch.profiler
    kernel durations), wall time (CUDA events), and the roofline bound of
    the same work.
 8. the vision path: ``engine.run_sequence`` over 120 bench frames
    downscaled on the card: finite state, more
    than 10 tracks from frame 5 on, the 'cuda_lk' backend, the launch
    counts (lk_level T-1, fast9 T), and a 10-frame rollout on the card
    against the CPU.
 9. path (a): ``engine.run_sequence_imu`` over 120 rendered 320x240
    frames at configs/mono_inertial.yaml's values: 'cuda_lk', lk_level =
    T-1 and fast9 = T-9 launches, finite
    state, more than 10 tracks from 5 frames after the initialization,
    ATE under 0.01 m, and a 15-frame rollout on the card against the CPU.
10. path (b): the same with klt_window_size=17: 'cuda_klt', klt_level =
    T-1 and lk_level = T-1 launches, finite state, more than 10 tracks.
11. path (c): ``engine.run_sequence`` at configs/fast_with_insight.yaml
    with bench.py's overrides (400 features, 512 slots, D = 1558) over
    120 bench frames at 320x240: 'cuda_lk',
    lk_level = T-1 and fast9 = T launches, finite state, more than 250
    tracks on average from frame 10 on, Σ finite, min diag >= -1e-5,
    asymmetry under 1e-3.
12. path (d): path (a) with ``square_root_form=True`` (the state carries
    the Cholesky factor): the backend, launch counts and gates of path
    (a), ``check_sigma`` on the squared final factor, and a 15-frame
    rollout on the card against the CPU.
13. path (e): ``parallel/batched_engine.run_sequences_batched`` over
    B = 16 lanes (bench frames of seeds 0-15) of 120 frames at 160x120,
    128 slots: 'cuda_lk', lk_level = T-1 and
    fast9 = T launches for all lanes together, every lane finite with
    more than 10 tracks from frame 5 on, and a 10-frame batched rollout
    equal in every lane's num_tracked and num_active to a one-lane
    ``run_sequence`` on the card.
14. the aggregate frames/s curve of the batched path at B = 1, 4, 16, 64
    (60 frames each, graphed): per-lane and aggregate frames/s, launches
    per batched step; then B = 128 and 256 lanes (30 frames) as one batch
    against two chunks of half the lanes, what ``MICROBATCH`` is set by,
    and the peak of device memory.
15. path (f): ``run_sequences_batched`` over B = 4 rendered sequences
    (seeds 0-3) of 60 frames with klt_window_size=17: 'cuda_klt',
    klt_level = lk_level = T-1 and fast9 = T launches, every lane finite.
16. the simulator on the card: the six reference scenarios (covariance
    form), then scenario 6 at 128 slots for 100 steps in both forms, each
    with min diag >= -1e-5, asymmetry < 1e-3, final feat_err < 1e-3.
17. the CLI in subprocesses on the card: ``python -m ekf_vio_tpu_torch run
    --synthetic 60``, ``run --rendered 40 --config
    configs/mono_inertial.yaml`` (ATE under 0.01 m) and ``run --euroc`` on
    a 12-frame ASL tree the phase writes; the frame loader's route; native/
    unchanged; then the streaming loop in this process (``--insight-dir``,
    the compiled step ``scan.graphed(engine.step)`` replayed a frame, each
    frame read back for drawing between replays), graphed against eager.
18. torch.profiler traces of 5 steady-state steps of the vision path, of
    paths (a), (c) and (d), of the batched step at B = 16 and of path
    (g)'s sharded step, run eagerly: kernels per step, time per ``vio.*``
    layer (host-side spans, which a replay does not run), the device's
    busy share.
19. the distributed layer on one card: a NCCL process group of one rank
    (tcp://127.0.0.1 store, ``multihost.initialize_distributed``) and the
    (1, 1) ('data', 'state') mesh of ``mesh.make_mesh``.  Path (g):
    ``sharded_engine.run_sequence`` at path (c)'s configuration (512
    slots, D = 1558) over 60 bench frames (the step and its NCCL
    collectives in one graph):
    bench.py's asserts, Σ checks on the merged state, 'cuda_lk', lk_level
    = T-1 and fast9 = T launches, a 10-frame sharded rollout equal to the
    dense ``run_sequence`` in every count (base_mu within 5e-3), and the
    same 10 frames with two-view depths, whose back-track makes lk_level
    = 2(T-1) on both engines.
20. path (h): ``sharded_engine.run_sequence_imu`` at path (a)'s
    configuration over 40 rendered frames, VI initialization included:
    'cuda_lk', lk_level = T-1 and fast9 = T-9 launches, ATE under 0.01 m,
    mean_nis 0 on every frame.
21. BASELINE.json config 5: ``sharded_predict`` + ``sharded_update`` at
    256 slots (every 4th unmeasured) against the dense pair, both timed
    with CUDA events; the collectives of a profiler trace
    (``evidence.collective_inventory``) and ``evidence.memory_analysis``.
22. path (j): the mesh step of ``batched.make_batched_filter_step(cfg,
    mesh)`` on 4 lanes against the mesh-less step, each compiled step
    (``scan.graphed``) against its eager form, the ms a step of
    ``scaling_efficiency_probe``, and ``run_sequences_sharded`` over 4
    lanes of 30 frames equal to ``run_sequences_batched`` in every count.
23. two ranks on the one card: two processes (``chip_smoke.py
    --two-ranks``) on a gloo group with CUDA tensors (NCCL puts no two
    ranks on one GPU), mesh (1, 2): one sharded engine step and one
    sharded update, merged, against ns = 1 at f32 roundoff; the update
    of the ns = 2 stepped state on both sides, with the base_mu gap that
    the step's roundoff leaves after each kind of update (gloo runs
    eagerly: its collectives run on host threads).
24. torch.profiler over 5 replayed steps of each path's compiled rollout
    (vision, (a)-(h), (j), the CLI's streaming step, the simulator in both
    forms) and the wall time of 5 more replays without it, each replay
    timed alone between synchronisations: device ops and time a step, the
    busy share, and each kernel's
    launches a replayed step by its name in the trace, the witness that
    the graph launched it (lk_level and fast9 once a step; klt_level once
    on (b) and (f)).
Every path runs with every launch count set to 0 just before it and read
just after.  The kernels count their own launches on the card
(``csrc/launch_count.cuh``), so a replay's launches are counted where
they run; the ``kernels`` line holds the counts of the graphed runs.
A ``[graphs]`` JSON line holds each path's graph and eager frames/s,
capture times and replayed profile.  The JSON line before the card line
lists each kernel with
its launches on those runs (per path under ``launches_by_path``), its
largest error against its plain version, its device time and its plain
version's at the slice's shapes (every shape under ``by_shape``, the lane
shapes included), and the roofline bound of that work.  The line before
the last is the card's name and power limit; the last line is {"ok":
true, "device": {...}}.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
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
KERNELS = ("lk_level", "fast9", "klt_level")
N512 = "320x240 n=512"  # the shape key of path (c)'s inputs


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
    """One nvcc per kernel, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from ekf_vio_tpu_torch import cuda_lib

    def build(name):
        t0 = time.perf_counter()
        return name, cuda_lib.build(name), time.perf_counter() - t0

    t_all = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, path, dt in pool.map(build, KERNELS):
            cuda_lib.load(name)
            print(f"[build] {name}: {dt:.2f} s -> {os.path.relpath(path)}")
    print(f"[build] all, in parallel: {time.perf_counter() - t_all:.2f} s")


def _cam(s: int):
    from ekf_vio_tpu_torch.frontend.camera import Camera

    w, h = W_IN // s, H_IN // s
    return Camera.from_K([[458.0 / s, 0, w / 2], [0, 458.0 / s, h / 2],
                          [0, 0, 1]], w, h)


def _bench_cfg():
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig(max_features=128, min_new_feature_dist=8.0,
                     fast_threshold=30)


def _fwi_cfg():
    """configs/fast_with_insight.yaml with bench.py's overrides: 400
    features, 512 slots, frames / 2."""
    from ekf_vio_tpu_torch.config import VIOConfig

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "fast_with_insight.yaml")
    cfg = VIOConfig.from_yaml(path).replace(min_new_feature_dist=8.0,
                                            fast_threshold=30)
    if (cfg.num_features, cfg.max_features,
            cfg.inverse_image_scale) != (400, 512, 2):
        raise AssertionError(f"fast_with_insight profile: {cfg}")
    return cfg


def _lk_inputs(frames_small, mono2, dev, frames_half):
    """The main path's LK inputs: bench frames 0 -> 1 at 160x120 with the
    128 seeds of ``initialize``, rendered 320x240 frames 0 -> 1 with
    those of ``initialize_imu``'s detection, and bench frames 0 -> 1 at
    320x240 with the 512 slots of path (c)'s ``initialize``, as {shape:
    (prev pyramid, cur pyramid, level-0 points [N, 2], valid [N])}."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, pyramid

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    es = engine.initialize(frames_small[0], torch.zeros((), device=dev), cfg,
                           cam)
    px = camera.metric_to_pixel(cam, es.filt.klt_ref)
    mpx, mvalid = _mono_seeds(mono2[0], _mono_cfg())
    fcfg = _fwi_cfg()
    fcam = _cam(fcfg.inverse_image_scale)
    fes = engine.initialize(frames_half[0], torch.zeros((), device=dev), fcfg,
                            fcam)
    return {"160x120": (pyramid.build_pyramid(frames_small[0], 3),
                        pyramid.build_pyramid(frames_small[1], 3), px,
                        es.filt.active),
            "320x240": (pyramid.build_pyramid(mono2[0], 3),
                        pyramid.build_pyramid(mono2[1], 3), mpx, mvalid),
            N512: (pyramid.build_pyramid(frames_half[0], 3),
                   pyramid.build_pyramid(frames_half[1], 3),
                   camera.metric_to_pixel(fcam, fes.filt.klt_ref),
                   fes.filt.active)}


def phase_lk(inputs, frames_full) -> float:
    """Kernel A against its twin on identical inputs: one launch per
    pyramid call, then one per level.  Returns the max |Δpoint| over
    tracked rows."""
    from ekf_vio_tpu_torch.frontend import klt, lk_cuda

    cfg = _bench_cfg()
    pp, cp, px, valid = inputs["160x120"]
    mp, mc, mpx, mvalid = inputs["320x240"]
    fp, fc, fpx, fvalid = inputs[N512]
    # (name, prev pyramid, cur pyramid, level-0 points, valid, lo, hi)
    calls = [("160x120 levels 0-2 n=128", pp, cp, px, valid, 0, 2),
             ("160x120 levels 0-2 n=100", pp, cp, px[:100].contiguous(),
              valid[:100].contiguous(), 0, 2),
             # the full-resolution frame with the seeds scaled up
             ("640x480 level 0 n=128", [frames_full[0]], [frames_full[1]],
              px * 4.0, valid, 0, 0),
             ("320x240 rendered levels 0-3 n=128", mp, mc, mpx, mvalid, 0, 3),
             ("320x240 bench levels 0-3 n=512", fp, fc, fpx, fvalid, 0, 3),
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

    for module in (lk_cuda, fast_cuda, klt_cuda):
        module.reset_launches()


def _counts() -> dict:
    from ekf_vio_tpu_torch.frontend import fast_cuda, klt_cuda, lk_cuda

    return {"lk_level": lk_cuda.launches(), "fast9": fast_cuda.launches(),
            "klt_level": klt_cuda.launches()}


# --------------------------------------------------------------------------
# Compiled rollouts: graph against eager, replayed profiles
# --------------------------------------------------------------------------

# each path's graph-vs-eager record and replayed profile, for the JSON line
GRAPHS: dict = {}
# the kernels' names in a profiler trace (csrc/*.cu), by wrapper
KERNEL_SYMBOLS = {"lk_level": "lk_pyramid_kernel", "fast9": "fast9_kernel",
                  "klt_level": "klt_pyramid_kernel"}


@contextlib.contextmanager
def _eager():
    """The eager loop over the step: every rollout's ``scan.scan`` is
    ``scan.loop`` and ``scan.graphed`` the function itself, as the port
    ran before its rollouts were compiled."""
    from ekf_vio_tpu_torch import scan

    saved = scan.scan, scan.graphed
    scan.scan, scan.graphed = scan.loop, (lambda fn: fn)
    try:
        yield
    finally:
        scan.scan, scan.graphed = saved


def _gap(a, b) -> float:
    """The largest |a - b| over the float leaves of two results (NaN
    against NaN counts 0); inf if any other leaf differs."""
    from torch.utils import _pytree

    worst = 0.0
    for x, y in zip(_pytree.tree_leaves(a), _pytree.tree_leaves(b),
                    strict=True):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            d = torch.where(x.isnan() & y.isnan(), 0.0, (x - y).abs())
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        elif not (torch.equal(x, y) if isinstance(x, torch.Tensor)
                  else x == y):
            return float("inf")
    return worst


def _graph_vs_eager(tag: str, run, frames: int, want, card: str) -> dict:
    """``run()`` graphed and eager in turns (graph, eager, graph, eager) on
    the same inputs, every launch count set to 0 just before each run and
    read just after: each run's counts equal ``want``; the graphed results
    agree with the first eager one (every integer and bool leaf equal,
    every float leaf no further from it than the second eager result is:
    0 where the eager rollout is deterministic); frames/s of each mode
    (``frames`` over the better of its two runs); the host time of each
    capture on its own line.  Returns the last graphed result with the
    numbers and the launch counts of the graphed runs."""
    from ekf_vio_tpu_torch import scan

    out = {"graph": [], "eager": []}
    secs = {"graph": [], "eager": []}
    capture_ms = []
    counts = {}
    for mode in ("graph", "eager", "graph", "eager"):
        _reset_counts()
        with _eager() if mode == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
        counts[mode] = _counts()
        if counts[mode] != want:
            raise AssertionError(f"[{tag}] {mode} launch counts "
                                 f"{counts[mode]}, expected {want}")
        if mode == "graph":
            capture_ms.append(1e3 * scan.last["capture_s"])
        out[mode].append(res)
    eager_gap = _gap(out["eager"][1], out["eager"][0])
    gap = max(_gap(g, out["eager"][0]) for g in out["graph"])
    if not gap <= eager_gap:
        raise AssertionError(f"[{tag}] graph and eager differ: {gap:.3e}, "
                             f"eager and eager {eager_gap:.3e}")
    fps = {m: frames / min(v) for m, v in secs.items()}
    turns = " / ".join(f"{1e3 * secs[m][i]:.1f}" for i in (0, 1)
                       for m in ("graph", "eager"))
    print(f"[{tag}] compiled rollout: graph {fps['graph']:.1f} frames/s, "
          f"eager {fps['eager']:.1f} frames/s ({frames} frames; in turns "
          f"graph / eager / graph / eager {turns} ms) on {card}; graph vs "
          f"eager max|d| {gap:.3e} (eager vs eager {eager_gap:.3e}); "
          f"launches of each graphed run {counts['graph']}, of each eager "
          f"run {counts['eager']}")
    print(f"[{tag}] capture (host): "
          f"{' / '.join(f'{ms:.1f}' for ms in capture_ms)} ms")
    GRAPHS[tag] = {"graph_fps": fps["graph"], "eager_fps": fps["eager"],
                   "capture_ms": capture_ms, "gap": gap,
                   "eager_gap": eager_gap, "seconds": secs}
    return {"result": out["graph"][-1], "fps": fps["graph"],
            "eager_fps": fps["eager"], "counts": counts["graph"],
            "step_ms": 1e3 * min(secs["graph"]) / frames,
            "eager_step_ms": 1e3 * min(secs["eager"]) / frames}


class _ProfiledGraph:
    """A captured graph whose replays skip+1 .. skip+5 run under
    torch.profiler and replays skip+6 .. skip+10 without it, each replay
    timed alone between synchronisations (the host work a loop does
    between replays stays out)."""

    def __init__(self, graph, rec: dict):
        self.graph, self.rec = graph, rec

    def replay(self):
        rec = self.rec
        rec["n"] += 1
        k = rec["n"] - rec["skip"]
        if not 1 <= k <= 10:
            self.graph.replay()
            return
        if k == 1:
            rec["prof"].start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.graph.replay()
        torch.cuda.synchronize()
        rec["profiled_s" if k <= 5 else "plain_s"] += time.perf_counter() - t0
        if k == 5:
            rec["prof"].stop()


def _profile_replays(tag: str, run, per_step: dict, skip: int = 5) -> dict:
    """torch.profiler over 5 replays of ``run``'s captured step (replays
    skip+1 .. skip+5): device ops (kernels and copies) per step and their
    time; the step's wall time from the next 5 replays, without the
    profiler, and the device's busy share of it; the witness that the
    kernels ran inside the graph: each kernel's launches per replayed
    step in the trace, by its name, equal ``per_step``."""
    from torch.profiler import ProfilerActivity, profile

    from ekf_vio_tpu_torch import scan

    rec = {"n": 0, "skip": skip, "profiled_s": 0.0, "plain_s": 0.0,
           "prof": profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])}
    real = scan._capture
    scan._capture = lambda fn: _ProfiledGraph(real(fn), rec)
    try:
        run()
    finally:
        scan._capture = real
    if rec["n"] < skip + 10:
        raise AssertionError(f"[replay profile {tag}] {rec['n']} replays, "
                             f"fewer than {skip + 10}")
    ops = [e for e in rec["prof"].key_averages()
           if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in ops) / 5
    step_us = rec["plain_s"] * 1e6 / 5
    seen = {name: sum(e.count for e in ops if sym in e.key) / 5
            for name, sym in KERNEL_SYMBOLS.items()}
    kernel_us = {name: sum(e.self_device_time_total for e in ops
                           if sym in e.key) / 5
                 for name, sym in KERNEL_SYMBOLS.items()}
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[replay profile {tag}] per replayed step: "
          f"{sum(e.count for e in ops) / 5:.0f} device ops, "
          f"{device_us:.0f} us of device time = "
          f"{100 * device_us / step_us:.1f} % of the {step_us / 1e3:.3f} ms "
          f"step (under the profiler {rec['profiled_s'] * 200:.3f} ms); "
          f"kernels in the trace a step {seen}, their us a step "
          f"{ {k: round(v, 1) for k, v in kernel_us.items()} }; top: "
          + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 5:.0f} us"
              for e in top))
    if seen != per_step:
        raise AssertionError(f"[replay profile {tag}] kernels a replayed "
                             f"step {seen}, expected {per_step}")
    prof = {"ops_per_step": sum(e.count for e in ops) / 5,
            "device_us": device_us, "step_ms": step_us / 1e3,
            "profiled_step_ms": rec["profiled_s"] * 200,
            "busy": device_us / step_us, "kernels_per_step": seen,
            "kernel_us": kernel_us,
            "top": [(e.key[:60], e.self_device_time_total / 5)
                    for e in top]}
    GRAPHS.setdefault(tag, {})["replay_profile"] = prof
    return prof


def phase_main_path(frames_dev, times_dev, dev, card: str) -> dict:
    """The vision path: ``run_sequence`` (a captured graph of the step,
    replayed once a frame) against the eager loop, in turns."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, klt

    cfg = _bench_cfg()
    s = cfg.inverse_image_scale
    cam = _cam(s)
    small = camera.downscale_image(frames_dev, s).contiguous()
    n = small.shape[0]
    backend = klt.selected_backend(small.shape[1:], cfg.max_features, cfg,
                                   small.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")
    want = {"lk_level": n - 1, "fast9": n, "klt_level": 0}
    ge = _graph_vs_eager(
        "main", lambda: engine.run_sequence(small, times_dev, cfg, cam),
        n - 1, want, card)
    _, outs = ge["result"]
    all_counts = ge["counts"]
    tracked = outs.num_tracked.cpu().numpy()
    if not torch.isfinite(outs.base_mu).all():
        raise AssertionError("non-finite base state")
    if tracked[5:].min() <= 10:
        raise AssertionError(f"lost tracking: {tracked.tolist()}")
    fps = ge["fps"]
    print(f"[main] {n} frames 160x120, 128 slots: {fps:.1f} frames/s "
          f"graphed on {card}; tracked min {tracked[5:].min()} mean "
          f"{tracked.mean():.1f}; launches per run: lk_level "
          f"{all_counts['lk_level']}, fast9 {all_counts['fast9']}")

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
    return {"fps": fps, "launches": all_counts, "step_ms": ge["step_ms"],
            "eager_step_ms": ge["eager_step_ms"]}


def phase_fwi_path(frames_dev, times_dev, card: str) -> dict:
    """Path (c): ``run_sequence`` at the fast_with_insight point (400
    features, 512 slots, D = 1558, frames / 2) on the card, graphed
    against eager in turns, with bench.py's asserts for that point."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, klt

    cfg = _fwi_cfg()
    s = cfg.inverse_image_scale
    cam = _cam(s)
    small = camera.downscale_image(frames_dev, s).contiguous()
    n = small.shape[0]
    backend = klt.selected_backend(small.shape[1:], cfg.max_features, cfg,
                                   small.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")
    want = {"lk_level": n - 1, "fast9": n, "klt_level": 0}
    ge = _graph_vs_eager(
        "path c", lambda: engine.run_sequence(small, times_dev, cfg, cam),
        n - 1, want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    tracked = outs.num_tracked.cpu().numpy()
    sig = es.filt.Sigma
    if not (torch.isfinite(outs.base_mu).all() and torch.isfinite(sig).all()):
        raise AssertionError("non-finite state")
    if not tracked[10:].mean() > 250:
        raise AssertionError(f"tracked only {tracked[10:].mean():.0f}")
    min_diag = torch.diagonal(sig).min().item()
    asym = (sig - sig.T).abs().max().item()
    if not (min_diag >= -1e-5 and asym < 1e-3):
        raise AssertionError(f"check_sigma: min diag {min_diag}, asymmetry "
                             f"{asym}")
    fps = ge["fps"]
    print(f"[path c] run_sequence, {n} bench frames {small.shape[2]}x"
          f"{small.shape[1]}, {cfg.max_features} slots (D = {cfg.state_dim}), "
          f"backend {backend}: {fps:.1f} frames/s graphed on {card}; "
          f"tracked mean from frame 10 {tracked[10:].mean():.1f}, min "
          f"{tracked[10:].min()}; min diag {min_diag:.3e}, asymmetry "
          f"{asym:.3e}; launches {counts}")
    return {"fps": fps, "launches": counts, "step_ms": ge["step_ms"],
            "eager_step_ms": ge["eager_step_ms"]}


# --------------------------------------------------------------------------
# The mono-inertial slice: configs/mono_inertial.yaml on rendered 320x240
# --------------------------------------------------------------------------


def _mono_cfg(win: int = 21, sqrt: bool = False):
    """configs/mono_inertial.yaml's values, built in code (the card's
    machine may lack PyYAML)."""
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig(num_features=100, max_features=128, use_imu=True,
                     triangulate_new_features=True, vi_init_frames=10,
                     klt_measurement_variance_px=0.001, q_feature=1e-7,
                     min_new_feature_dist=10.0, fast_threshold=25,
                     inverse_image_scale=2, klt_window_size=win,
                     square_root_form=sqrt)


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


def _klt_point_cases(px, valid):
    """The seed sets klt_level is held on: (name, level-0 points, level-0
    guesses, valid)."""
    border = px.clone()
    border[:6] = torch.tensor([[2.5, 2.5], [316.0, 120.0], [150.0, 236.5],
                               [10.2, 200.7], [305.3, 8.9], [40.0, 16.0]],
                              device=px.device)
    vb = valid.clone()
    vb[:6] = True
    nan = px.clone()
    nan[5] = float("nan")
    nan_guess = nan.clone()
    nan_guess[9] = float("nan")
    vn = valid.clone()
    vn[[5, 9, 11]] = False
    return [("n=128", px, px, valid),
            ("6 seeds within 17 px of the border", border, border, vb),
            ("NaN and invalid rows", nan, nan_guess, vn),
            ("n=100", px[:100].contiguous(), px[:100].contiguous(),
             valid[:100].contiguous())]


def phase_klt(mono2) -> float:
    """klt_level against its plain version on the slice's inputs: one
    launch per pyramid call (levels 2-0) against
    ``klt.track_pyramid_klt_plain``, then one launch per level against
    ``track_level_klt_plain``.  Returns the max |Δpoint| over tracked
    rows."""
    from ekf_vio_tpu_torch.frontend import klt, klt_cuda, pyramid

    cfg = _mono_cfg(17)
    px, valid = _mono_seeds(mono2[0], cfg)
    pp = pyramid.build_pyramid(mono2[0], 3)
    cp = pyramid.build_pyramid(mono2[1], 3)
    points = _klt_point_cases(px, valid)
    kw = dict(iters=cfg.klt_iterations, eps=cfg.klt_eps)
    worst = 0.0
    # every level of a track call in one launch
    for win, cases in ((17, points), (21, points[:1])):
        for name, p0, g0, v in cases:
            args = (pp, cp, p0, g0, v)
            pkw = dict(kw, lo=0, hi=2, win=win, min_eigen=cfg.klt_min_eigen)
            before = klt_cuda.launches()
            got = klt_cuda.track_pyramid_cuda(*args, **pkw)
            if klt_cuda.launches() != before + 1:
                raise AssertionError("a pyramid call is not one launch")
            ref = klt.track_pyramid_klt_plain(*args, **pkw)
            worst = max(worst, _level_cases_agree(
                "klt", f"pyramid win {win} levels 2-0, {name}", got, ref, v))
    # one launch per level, each seeded at its own points
    cases = [(f"win 17 level {lvl}, n=128", lvl, 17) + points[0][1:]
             for lvl in range(3)]
    cases.append(("win 21 level 0, n=128", 0, 21) + points[0][1:])
    cases += [(f"win 17 level 0, {name}", 0, 17, p0, g0, v)
              for name, p0, g0, v in points[1:]]
    for name, lvl, win, p0, g0, v in cases:
        args = (pp[lvl], cp[lvl], (p0 / 2 ** lvl).contiguous(),
                (g0 / 2 ** lvl).contiguous(), v)
        lkw = dict(kw, win=win,
                   min_eigen=cfg.klt_min_eigen if lvl == 0 else -1.0)
        got = klt_cuda.track_level_cuda(*args, **lkw)
        ref = klt.track_level_klt_plain(*args, **lkw)
        worst = max(worst, _level_cases_agree("klt", name, got, ref, v))
    return worst


def _bits(t):
    """A tensor's bit pattern: float32 as int32 (NaN included), else as
    is, for bitwise comparison."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bitwise_equal(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _lanes_agree(tag, name, got, ref, valid) -> float:
    """The kernel bar of ``_level_cases_agree`` over every lane of a
    lane-shaped result: status identical, the same finiteness, points
    within 2e-3 px, err within 1e-2, min_eig within rtol 1e-3 where
    tracked.  Returns max |dpoint| over the tracked rows."""
    g, ok, eig, err = got
    rg, rok, reig, rerr = ref
    torch.cuda.synchronize()
    if not torch.equal(ok, rok):
        raise AssertionError(f"[{tag}] {name}: status differs in lanes "
                             f"{torch.nonzero((ok != rok).any(-1)).tolist()}")
    if not torch.equal(torch.isfinite(g), torch.isfinite(rg)):
        raise AssertionError(f"[{tag}] {name}: finiteness differs")
    tracked = ok & valid
    dp = (g - rg)[tracked].abs().max().item()
    de = (err - rerr)[tracked].abs().max().item()
    rel_eig = ((eig - reig)[tracked].abs() / reig[tracked].abs()).max().item()
    print(f"[{tag}] {name}: tracked per lane "
          f"{tracked.sum(-1).tolist()} of {valid.sum(-1).tolist()}, status "
          f"identical, max|dpoint| {dp:.3e} px, max|derr| {de:.3e}, max rel "
          f"dmin_eig {rel_eig:.3e}")
    if not (dp <= 2e-3 and de <= 1e-2 and rel_eig <= 1e-3):
        raise AssertionError(f"[{tag}] {name}: outside the bar")
    return dp


def _lane_inputs(frames_dev, seq, dev) -> dict:
    """The lane shapes the batched paths give the kernels, as {key:
    (prev pyramid, cur pyramid, points [B, N, 2], valid [B, N])} of
    lane-shaped levels [B, H, W]: lk_level at B = 16 on bench frames
    b -> b + 1 at 160x120 (each lane's frames shifted by half a pixel
    from the last lane's) with the 128 seeds of ``initialize`` on frame b,
    lane 14's points NaN and lane 15's all invalid; klt_level at B = 4 on
    rendered 320x240 frames b -> b + 1 with the 128 seeds of
    ``initialize_imu``'s detection (win 17), lane 3 all invalid."""
    from ekf_vio_tpu_torch.frontend import camera, pyramid

    small = camera.downscale_image(frames_dev[:17], 4).contiguous()
    mono = torch.from_numpy(seq.frames[:5]).to(dev)
    out = {}
    for key, imgs, cfg, lanes in (("160x120 B=16", small, _bench_cfg(), 16),
                                  ("320x240 B=4", mono, _mono_cfg(17), 4)):
        seeds = [_mono_seeds(imgs[b], cfg) for b in range(lanes)]
        px = torch.stack([p for p, _ in seeds])
        valid = torch.stack([v for _, v in seeds])
        valid[-1] = False
        if lanes == 16:
            px[14] = float("nan")
        out[key] = (pyramid.build_pyramid(imgs[:lanes], 3),
                    pyramid.build_pyramid(imgs[1:lanes + 1], 3),
                    px.contiguous(), valid.contiguous())
    return out


def _path_lane_inputs(lanes16, seqs4) -> dict:
    """The lane shapes paths (e) and (f) give the kernels on their first
    tracked frame, for the timings: lk_level at B = 16 on each path (e)
    lane's frames 0 -> 1 (bench frames of seeds 0-15 at 160x120) with the
    seeds ``initialize`` gives it, and klt_level at B = 4 on each path (f)
    lane's rendered 320x240 frames 0 -> 1 (seeds 0-3, win 17) with the
    seeds of path (f)'s ``initialize``; every lane as healthy as on the
    path (no NaN or invalid lane).  Same layout as ``_lane_inputs``."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, pyramid

    mono = torch.from_numpy(np.stack([q.frames[:2] for q in seqs4])).cuda()
    out = {}
    for key, imgs, cfg, cam in (
            ("160x120 B=16", lanes16[:, :2], _bench_cfg(),
             _cam(_bench_cfg().inverse_image_scale)),
            ("320x240 B=4", mono, _path_f_cfg(), _mono_cam(seqs4[0]))):
        seeds = [engine.initialize(x[0], torch.zeros((), device=x.device),
                                   cfg, cam).filt for x in imgs]
        px = torch.stack([camera.metric_to_pixel(cam, f.klt_ref)
                          for f in seeds])
        valid = torch.stack([f.active for f in seeds])
        out[key] = (pyramid.build_pyramid(imgs[:, 0].contiguous(), 3),
                    pyramid.build_pyramid(imgs[:, 1].contiguous(), 3),
                    px.contiguous(), valid.contiguous())
    return out


def phase_lanes(lane_inputs, frames_dev, seq) -> dict:
    """Each kernel with a lane axis: one launch of B lanes against B
    one-lane launches (bitwise equal) and against the plain version with
    lanes (the bars of phases 3-5).  Returns {kernel: max error}."""
    from ekf_vio_tpu_torch.frontend import (camera, fast, fast_cuda, klt,
                                            klt_cuda, lk_cuda)

    worst = {}
    for kernel, module, plain, key, cfg, hi in (
            ("lk_level", lk_cuda, klt.track_pyramid_plain, "160x120 B=16",
             _bench_cfg(), 2),
            ("klt_level", klt_cuda, klt.track_pyramid_klt_plain,
             "320x240 B=4", _mono_cfg(17), 2)):
        pp, cp, px, valid = lane_inputs[key]
        kw = dict(lo=0, hi=hi, win=cfg.klt_window_size,
                  iters=cfg.klt_iterations, eps=cfg.klt_eps,
                  min_eigen=cfg.klt_min_eigen)
        before = module.launches()
        got = module.track_pyramid_cuda(pp, cp, px, px, valid, **kw)
        if module.launches() != before + 1:
            raise AssertionError(f"[lanes] {kernel}: {key} is not one launch")
        singles = [module.track_pyramid_cuda(
            [x[b] for x in pp], [x[b] for x in cp], px[b], px[b], valid[b],
            **kw) for b in range(px.shape[0])]
        same = _bitwise_equal(got, [torch.stack(o) for o in zip(*singles)])
        print(f"[lanes] {kernel} {key}: one launch vs {px.shape[0]} "
              f"one-lane launches bitwise equal: {same}")
        if not same:
            raise AssertionError(f"[lanes] {kernel}: lanes differ from "
                                 f"one-lane launches")
        ref = plain(pp, cp, px, px, valid, **kw)
        worst[kernel] = _lanes_agree("lanes", f"{kernel} {key} vs the plain "
                                     f"version with lanes", got, ref, valid)
    # fast9: 16 lanes of 160x120 bench frames (lane 15 NaN) and 4 of
    # rendered 320x240 frames (the other margin order), integer-valued
    # (bitwise) and fractional (within 1e-4)
    small = camera.downscale_image(frames_dev[:16], 4).contiguous()
    small[15] = float("nan")
    mono = torch.from_numpy(seq.frames[:4]).to(small.device)
    fw = 0.0
    for name, stack, thr in (("160x120 B=16", small, 30.0),
                             ("320x240 B=4", mono, 25.0)):
        for exact, imgs in ((True, torch.round(stack)), (False, stack)):
            before = fast_cuda.launches()
            got = fast_cuda.detect_cuda(imgs.contiguous(), thr)
            if fast_cuda.launches() != before + 1:
                raise AssertionError("[lanes] fast9 is not one launch")
            singles = torch.stack([fast_cuda.detect_cuda(x.contiguous(), thr)
                                   for x in imgs])
            ref = fast.detect(imgs, thr)
            same = _bitwise_equal([got], [singles])
            diff = (got - ref).abs().max().item()
            corners = (ref > 0).sum((-1, -2)).tolist()
            print(f"[lanes] fast9 {name} "
                  f"{'integer-valued' if exact else 'fractional'}: one "
                  f"launch vs one-frame launches bitwise equal: {same}; "
                  f"corners per lane {corners}; max|dscore| vs the plain "
                  f"version {diff:.3e}")
            if not same or (exact and diff != 0.0) or diff > 1e-4:
                raise AssertionError(f"[lanes] fast9 {name}: outside the bar")
            fw = max(fw, diff)
    worst["fast9"] = fw
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


def _level_work(prev, q, path, win: int, live):
    """(bytes, flops, moves) that one LK level must move and do for these
    inputs, and each live feature's number of iterations in which it
    moves, given ``path`` [iters + 1, N, 2], each feature's position after
    0, 1, ... iterations, and ``live`` [N], the rows this level tracks
    (valid and ok at every coarser level); the other rows need only their
    inputs read and outputs written.  A win x win window at a fractional
    centre reads (win + 1)^2 taps.  Bytes: the distinct prev pixels under
    the live rows' taps and their Scharr halo, the distinct cur pixels
    under the taps at every position a live feature takes, every row's
    inputs and outputs.  Flops per live feature: Scharr at the taps (12 a
    tap: smooth, then difference, in x and y); the template and gradient
    windows (6 a window pixel each, the bilinear blend separated) and the
    Hessian (6); the final residual (9); and 11 a window pixel (window 6,
    residual 1, two products 4) for each iteration in which it moves."""
    h, w = prev.shape
    n = q.shape[0]
    half = (win - 1) // 2
    q, path = q[live], path[:, live]

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
    flops = (q.shape[0] * (12 * (win + 1) ** 2 + 33 * ww)
             + 11 * ww * int(moves.sum()))
    return nbytes, flops, moves


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_HBM, flops / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _pyramid_work(pp, cp, px, valid, cfg, lo: int, hi: int,
                  kind: str = "lk"):
    """(bytes, flops, {level: moves}) of one pyramid call of lk_level
    (``kind`` "lk") or klt_level ("klt"), the guesses chained through the
    levels as the kernel chains them; each level's path is read off the
    plain version stopped after 0, 1, ... iters iterations, and ``moves``
    are the iterations in which each feature valid at that level moves."""
    from ekf_vio_tpu_torch.frontend import klt

    win = cfg.klt_window_size

    def level(lvl, q, g, ok, k):
        kw = dict(win=win, iters=k, eps=cfg.klt_eps)
        if kind == "lk":
            return klt.track_level_plain(
                pp[lvl], cp[lvl], q, g, ok, **kw,
                min_eigen=cfg.klt_min_eigen, gate_eig=lvl == 0)[:2]
        g, inb = klt.track_level_klt_plain(
            pp[lvl], cp[lvl], q, g, ok, **kw,
            min_eigen=cfg.klt_min_eigen if lvl == 0 else -1.0)[:2]
        return g, ok & inb

    g, ok = px / float(2 ** hi), valid
    nbytes = flops = 0
    moves = {}
    for lvl in range(hi, lo - 1, -1):
        q = px / float(2 ** lvl)
        runs = [level(lvl, q, g, ok, k)
                for k in range(cfg.klt_iterations + 1)]
        b, f, moves[lvl] = _level_work(
            pp[lvl], q, torch.stack([r[0] for r in runs]), win, ok)
        nbytes, flops = nbytes + b, flops + f
        g, ok = runs[-1]
        if lvl > lo:
            g = g * 2.0
    return nbytes, flops, moves


def _device_kernels(fn, reps: int = 200) -> float:
    """The number of device kernels one call of ``fn`` launches, counted
    over ``reps`` calls (a profile that follows another one drops
    about a dozen kernel events at its start, so a short one reads low)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA") / reps


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


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def phase_timings(inputs, path_lanes, card: str) -> dict:
    """Each kernel against its plain version at the paths' shapes: one
    lk_level ``track`` call (160x120: 3 levels, the vision path; 320x240:
    4 levels, path (a); 320x240 with 512 slots, path (c)) and one
    klt_level ``track`` call (3 levels of path (b); the same seeds padded
    to 512 slots), each also with no iteration (its fixed part), and one
    FAST call at each frame.  Device and wall time, and the roofline bound
    of the same work.  Then the device kernels of one path (b)
    ``klt.track`` call and the QR of the square-root update's pre-array.
    Last, each kernel at the lane shapes of the batched paths (one launch
    for B lanes, on the lanes those paths give it), with the bound of the
    lanes' summed chained work.  Returns
    {name: {shape: {...}}} in ms."""
    from ekf_vio_tpu_torch.frontend import (fast, fast_cuda, klt, klt_cuda,
                                            lk_cuda)

    cfg = _bench_cfg()
    kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
              eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen)
    out = {"lk_level": {}, "fast9": {}, "klt_level": {}}

    def pyramid_times(name, module, plain_fn, shape, args, hi, kw, kind,
                      wcfg):
        nbytes, flops, moves = _pyramid_work(*args, wcfg, 0, hi, kind)
        for lvl, m in moves.items():
            print(f"[time] {name} {shape} level {lvl}: a feature moves in "
                  f"at most {int(m.max())} iterations, {m.float().mean():.2f} "
                  f"on average ({m.numel()} features)")
        pp, cp, px, valid = args
        times = _in_turns({
            "kernel": lambda: module.track_pyramid_cuda(
                pp, cp, px, px, valid, lo=0, hi=hi, **kw),
            # the prologue and the gathers alone
            "0 iterations": lambda: module.track_pyramid_cuda(
                pp, cp, px, px, valid, lo=0, hi=hi, **dict(kw, iters=0))},
            200)
        plain = _timed(lambda: plain_fn(pp, cp, px, px, valid, lo=0, hi=hi,
                                        **kw), 5)
        out[name][shape] = _entry(times, plain, _bound(nbytes, flops))
        out[name][shape]["n"] = px.shape[0]

    for shape, hi in (("160x120", 2), ("320x240", 3), (N512, 3)):
        pyramid_times("lk_level", lk_cuda, klt.track_pyramid_plain, shape,
                      inputs[shape], hi, kw, "lk", cfg)
    for shape, thr in (("160x120", 30.0), ("320x240", 25.0), (N512, 30.0)):
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
        out["fast9"][shape]["n"] = inputs[shape][2].shape[0]

    # klt_level: path (b)'s levels 0-2 at win 17 in one launch, at its 128
    # slots and on the 512 slots of path (c)'s frames
    kcfg = _mono_cfg(17)
    kkw = dict(kw, win=17)
    pp, cp = inputs["320x240"][:2]
    px, valid = _mono_seeds(pp[0], kcfg)
    pyramid_times("klt_level", klt_cuda, klt.track_pyramid_klt_plain,
                  "320x240", (pp, cp, px, valid), 2, kkw, "klt", kcfg)
    pyramid_times("klt_level", klt_cuda, klt.track_pyramid_klt_plain, N512,
                  inputs[N512], 2, kkw, "klt", kcfg)

    # the lane shapes on the lanes the paths give the kernels: lk_level
    # and fast9 at B = 16 (path (e)), klt_level at B = 4 (path (f)); the
    # bound is the sum of every lane's chained work.  The plain versions
    # loop over the lanes, so only their wall time is taken here (one
    # call; a profile of their ~10^4 kernels costs more than it tells)
    for name, module, plain_fn, key, kind, wcfg in (
            ("lk_level", lk_cuda, klt.track_pyramid_plain, "160x120 B=16",
             "lk", cfg),
            ("klt_level", klt_cuda, klt.track_pyramid_klt_plain,
             "320x240 B=4", "klt", kcfg)):
        lp, lc, lpx, lvalid = path_lanes[key]
        lanes = lpx.shape[0]
        nbytes = flops = 0
        for b in range(lanes):
            nb, fl, _ = _pyramid_work([x[b] for x in lp], [x[b] for x in lc],
                                      lpx[b], lvalid[b], wcfg, 0, 2, kind)
            nbytes, flops = nbytes + nb, flops + fl
        lkw = dict(kw, win=wcfg.klt_window_size)
        times = {
            "kernel": _timed(lambda: module.track_pyramid_cuda(
                lp, lc, lpx, lpx, lvalid, lo=0, hi=2, **lkw), 200),
            "0 iterations": _timed(lambda: module.track_pyramid_cuda(
                lp, lc, lpx, lpx, lvalid, lo=0, hi=2, **dict(lkw, iters=0)),
                200)}
        plain = (None, _wall_ms(lambda: plain_fn(lp, lc, lpx, lpx, lvalid,
                                                 lo=0, hi=2, **lkw), 1))
        out[name][key] = _entry(times, plain, _bound(nbytes, flops))
        out[name][key]["n"] = lpx.shape[1]
        out[name][key]["lanes"] = lanes
        out[name][key]["valid_per_lane"] = lvalid.sum(-1).tolist()
    stack = path_lanes["160x120 B=16"][0][0]
    lanes, h, w = stack.shape
    times = {"kernel": _timed(lambda: fast_cuda.detect_cuda(stack, 30.0),
                              200)}
    plain = (None, _wall_ms(lambda: fast.detect(stack, 30.0), 1))
    out["fast9"]["160x120 B=16"] = _entry(
        times, plain, _bound(2 * lanes * h * w * 4, lanes * h * w * 109))
    out["fast9"]["160x120 B=16"]["n"] = 128
    out["fast9"]["160x120 B=16"]["lanes"] = lanes

    # what a level adds to the fixed part: its share of the hoisted
    # prologue and its dependent cur-patch gather
    for hi in range(3):
        d, wl = _timed(lambda: klt_cuda.track_pyramid_cuda(
            pp, cp, px, px, valid, lo=0, hi=hi, **dict(kkw, iters=0)), 200)
        print(f"[time] klt_level with no iteration, levels 0-{hi}, n=128: "
              f"{_us(d)} device / {_us(wl)} wall ({card})")

    for name, by_shape in out.items():
        for shape, t in by_shape.items():
            variants = "; ".join(
                f"{k}: {_us(d)} device / {_us(wl)} wall"
                for k, (d, wl) in t["variants"].items())
            print(f"[time] {name} per call at {shape.split(' n=')[0]}, "
                  f"n={t['n']} a lane (1 launch): "
                  f"kernel {_us(t['device'][0])} device / "
                  f"{_us(t['wall'][0])} wall [{variants}]; plain version "
                  f"{_us(t['device'][1])} device / {_us(t['wall'][1])} wall; "
                  f"bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) "
                  f"({card})")

    # the device kernels of one klt.track call on path (b) and path (a)
    for win in (17, 21):
        tcfg = _mono_cfg(win)
        n_k = _device_kernels(lambda: klt.track(pp, cp, px, px, valid, tcfg))
        print(f"[time] klt.track at 320x240, n=128, win {win}: {round(n_k)} "
              f"device kernels per call ({n_k:.2f} recorded)")

    # the QR of the square-root update's pre-array, (2N + D)^2, a library
    # call (cuSOLVER) as in the JAX package
    for slots in (128, 512):
        side = 2 * slots + 22 + 3 * slots
        a = torch.randn(side, side, device=px.device)
        dev_ms, wall_ms = _timed(lambda: torch.linalg.qr(a, mode="r"), 5)
        print(f"[time] torch.linalg.qr(mode='r') of the update's pre-array, "
              f"{side}x{side} ({slots} slots): {dev_ms:.3f} ms device / "
              f"{wall_ms:.3f} ms wall ({card})")
        out.setdefault("qr", {})[f"{side}x{side}"] = (dev_ms, wall_ms)
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


def phase_mono_path(seq, win: int, card: str, sqrt: bool = False) -> dict:
    """``run_sequence_imu`` over the rendered sequence on the card, graphed
    against eager in turns, with its backend and launch counts asserted:
    path (a) (win 21), (b) (win 17) or (d) (win 21, square-root form)."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.core import filter as ekf
    from ekf_vio_tpu_torch.core import sqrt_filter
    from ekf_vio_tpu_torch.frontend import klt

    cfg = _mono_cfg(win, sqrt)
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
            {"lk_level": n - 1, "fast9": n - k0 + 1, "klt_level": n - 1})
    args = (seq.frames, seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
            seq.gravity_w)
    dev_args = tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                     for a in args)
    tag = "d" if sqrt else "a" if win == 21 else "b"
    ge = _graph_vs_eager(
        f"path {tag}", lambda: engine.run_sequence_imu(*dev_args, cfg, cam,
                                                       init_frames=k0),
        n - 1, want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    tracked = outs.num_tracked.cpu().numpy()
    if not (torch.isfinite(outs.base_mu).all()
            and torch.isfinite(es.filt.Sigma).all()):
        raise AssertionError("non-finite state")
    if tracked[5:].min() <= 10:
        raise AssertionError(f"lost tracking: {tracked.tolist()}")
    ate = _ate(seq, outs, k0)
    fps = ge["fps"]
    if sqrt:  # the state carries the factor: audit its square
        min_diag, asym = (float(x) for x in ekf.check_sigma(
            sqrt_filter.to_covariance(es.filt)))
        print(f"[path d] square-root form: check_sigma of L L^T: min diag "
              f"{min_diag:.3e}, asymmetry {asym:.3e}")
        if not (min_diag >= -1e-5 and asym < 1e-3):
            raise AssertionError("the squared factor fails check_sigma")
    print(f"[path {tag}] run_sequence_imu, {n} rendered frames 320x240, "
          f"128 slots, win {win}, backend {backend}: {fps:.1f} frames/s "
          f"graphed (VI init included) on {card}; tracked min "
          f"{tracked[5:].min()} mean {tracked.mean():.1f}; ATE "
          f"{ate * 1e3:.2f} mm; launches {counts}")
    if win == 21 and not ate < 0.01:
        raise AssertionError(f"ATE {ate:.4f} m is not under 0.01 m")
    return {"fps": fps, "launches": counts, "ate": ate,
            "step_ms": ge["step_ms"], "eager_step_ms": ge["eager_step_ms"]}


def phase_mono_cpu_rollout(seq, sqrt: bool = False) -> None:
    """A 15-frame mono-inertial rollout on the card against the same on
    the CPU (plain versions): every count equal, base_mu within 5e-3 (GPU
    matmul order and reduction order compound over the steps; in
    square-root form also cuSOLVER's QR against LAPACK's)."""
    from ekf_vio_tpu_torch import engine

    cfg = _mono_cfg(sqrt=sqrt)
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
    print(f"[path {'d' if sqrt else 'a'}] {k}-frame rollout, card vs CPU: "
          f"num_tracked "
          f"{gpu.num_tracked.tolist()} vs {cpu.num_tracked.tolist()}, "
          f"num_active equal {same_active}, max|dbase_mu| {dmu:.3e}")
    if not (same_tracked and same_active and dmu < 5e-3):
        raise AssertionError("card and CPU mono-inertial rollouts disagree")


def phase_mono_profile(seq, step_ms: float, sqrt: bool = False) -> None:
    """torch.profiler over 5 steady-state IMU steps of path (a), or of
    path (d) with ``sqrt``."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.core import imu

    cfg = _mono_cfg(sqrt=sqrt)
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
    _profile_steps(lambda: steps(es, k0 + 5, k0 + 10), step_ms,
                   "sqrt imu step" if sqrt else "imu step")


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


def phase_profile(frames_dev, times_dev, step_ms: float, cfg,
                  what: str) -> None:
    """torch.profiler over 5 steady-state steps of a vision-only path."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera

    cam = _cam(cfg.inverse_image_scale)
    small = camera.downscale_image(frames_dev[:16],
                                   cfg.inverse_image_scale).contiguous()
    es = engine.initialize(small[0], times_dev[0], cfg, cam,
                           device=small.device)
    for i in range(1, 10):
        es, _ = engine.step(es, small[i], times_dev[i], cfg, cam)

    def run():
        e = es
        for i in range(10, 15):
            e, _ = engine.step(e, small[i], times_dev[i], cfg, cam)

    _profile_steps(run, step_ms, what)


# --------------------------------------------------------------------------
# Batched lanes: parallel/batched_engine.run_sequences_batched
# --------------------------------------------------------------------------


def _bench_lanes(frames_dev, n_seeds: int, n_frames: int, dev):
    """[n_seeds, n_frames, 120, 160] bench frames of seeds 0..n_seeds-1
    (``make_frames``), each downscaled on the card as it is made, and
    their times."""
    from ekf_vio_tpu_torch.frontend import camera
    from ekf_vio_tpu_torch.sim.frames import make_frames

    lanes = [camera.downscale_image(frames_dev[:n_frames], 4)]
    for seed in range(1, n_seeds):
        f, _ = make_frames(seed=seed, n_frames=n_frames)
        lanes.append(camera.downscale_image(torch.from_numpy(f).to(dev), 4))
    times = torch.arange(n_frames, dtype=torch.float32, device=dev) / 20.0
    return torch.stack(lanes).contiguous(), times.expand(n_seeds, -1)


def _batched_run(images, times, cfg, cam, microbatch: int):
    """(seconds, estate, outs, launch counts) of one
    ``run_sequences_batched`` call, the counts set to 0 just before."""
    from ekf_vio_tpu_torch.parallel import batched_engine

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    es, outs = batched_engine.run_sequences_batched(
        images, times, cfg, cam, microbatch=microbatch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, es, outs, _counts()


def _check_lanes(tag, es, outs, min_from: int = 5) -> None:
    """Every lane finite, with more than 10 tracks from frame 5 on."""
    if not (torch.isfinite(outs.base_mu).all()
            and torch.isfinite(es.filt.Sigma).all()):
        raise AssertionError(f"[{tag}] non-finite state in a lane")
    low = outs.num_tracked[:, min_from:].min(1).values
    if not (low > 10).all():
        raise AssertionError(f"[{tag}] lanes lost tracking: min tracks per "
                             f"lane {low.tolist()}")


def phase_batched_path(lanes, times, card: str) -> dict:
    """Path (e): ``run_sequences_batched`` over B = 16 lanes of 120 bench
    frames at 160x120, 128 slots, graphed against eager in turns: 'cuda_lk',
    lk_level = T-1 and fast9 = T launches for all lanes together, every
    lane finite with more than 10 tracks from frame 5 on; then a 10-frame
    batched rollout against a one-lane ``run_sequence`` of each lane on
    the card (equal num_tracked and num_active)."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import klt
    from ekf_vio_tpu_torch.parallel import batched_engine

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    b, n = lanes.shape[:2]
    backend = klt.selected_backend(lanes.shape[2:], cfg.max_features, cfg,
                                   lanes.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")
    want = {"lk_level": n - 1, "fast9": n, "klt_level": 0}
    ge = _graph_vs_eager(
        "path e", lambda: batched_engine.run_sequences_batched(
            lanes, times, cfg, cam, microbatch=b), b * (n - 1), want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    best = 1e-3 * ge["step_ms"] * b * (n - 1)
    _check_lanes("path e", es, outs)
    tracked = outs.num_tracked[:, 5:].float()
    print(f"[path e] run_sequences_batched, {b} lanes x {n} bench frames "
          f"160x120, 128 slots, backend {backend}: {b * (n - 1) / best:.1f} "
          f"frames/s in all, {(n - 1) / best:.1f} a lane graphed "
          f"({best * 1e3:.1f} ms) on {card}; tracked from frame 5 min "
          f"{int(tracked.min())} mean {tracked.mean():.1f}; launches "
          f"{counts}")
    k = 10
    _, _, short, _ = _batched_run(lanes[:, :k].contiguous(), times[:, :k],
                                  cfg, cam, b)
    bad = []
    for lane in range(b):
        _, one = engine.run_sequence(lanes[lane, :k], times[lane, :k], cfg,
                                     cam)
        if not (torch.equal(one.num_tracked, short.num_tracked[lane])
                and torch.equal(one.num_active, short.num_active[lane])):
            bad.append(lane)
    print(f"[path e] {k}-frame batched rollout vs one-lane run_sequence per "
          f"lane: num_tracked and num_active equal in "
          f"{b - len(bad)}/{b} lanes")
    if bad:
        raise AssertionError(f"[path e] lanes {bad} differ from their "
                             f"one-lane rollouts")
    return {"fps": b * (n - 1) / best, "launches": counts,
            "step_ms": 1e3 * best / (n - 1),
            "eager_step_ms": ge["eager_step_ms"] * b}


def _many_lanes(lanes16, b: int, n: int):
    """b lanes of n bench frames: lane k is seed k % 16 from frame
    4 (k // 16), so up to 256 lanes differ; and their times."""
    lanes = torch.stack([lanes16[k % 16, 4 * (k // 16): 4 * (k // 16) + n]
                         for k in range(b)]).contiguous()
    times = (torch.arange(n, dtype=torch.float32, device=lanes16.device)
             / 20.0).expand(b, -1)
    return lanes, times


def phase_batch_curve(lanes16, card: str, n: int = 60,
                      sizes=(1, 4, 16, 64)) -> dict:
    """Aggregate frames/s of ``run_sequences_batched`` at B = 1, 4, 16, 64
    over 60 frames (one warm-up, then one timed run each; no chunking):
    per-lane and aggregate frames/s and launches per batched step."""
    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    lanes64, times = _many_lanes(lanes16, max(sizes), n)
    curve = {}
    for b in sizes:
        _batched_run(lanes64[:b], times[:b], cfg, cam, b)  # warm-up
        dt, es, outs, counts = _batched_run(lanes64[:b], times[:b], cfg, cam,
                                            b)
        _check_lanes(f"curve B={b}", es, outs)
        if counts["lk_level"] != n - 1 or counts["fast9"] != n:
            raise AssertionError(f"[curve] B={b}: launch counts {counts}")
        curve[b] = {"aggregate_fps": b * (n - 1) / dt,
                    "lane_fps": (n - 1) / dt, "step_ms": 1e3 * dt / (n - 1)}
        print(f"[curve] B={b}: {curve[b]['aggregate_fps']:.1f} frames/s in "
              f"all, {curve[b]['lane_fps']:.1f} a lane, "
              f"{curve[b]['step_ms']:.2f} ms a batched step ({n} frames, "
              f"160x120, 128 slots) on {card}; launches per batched step: "
              f"lk_level {counts['lk_level'] / (n - 1):.0f}, fast9 "
              f"{(counts['fast9'] - 1) / (n - 1):.0f}")
    return curve


def phase_microbatch(lanes16, card: str, n: int = 30,
                     pairs=((128, 64), (256, 128))) -> dict:
    """What sets ``MICROBATCH``: B lanes as one batch against two chunks
    of B / 2 run one after the other (``run_sequences_batched``'s
    microbatch rule, a graph captured for each chunk), at B = 128 and 256
    over 30 frames, in turns chunks, one batch, one batch, chunks after a
    short warm-up of each shape, with the peak of device memory;
    every lane finite with more than 10 tracks, launch counts one of each
    kernel per batched step of each chunk.  Returns {B: {microbatch: ms a
    frame of all B lanes}}."""
    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    out, peak = {}, {}
    for b, half in pairs:
        lanes, times = _many_lanes(lanes16, b, n)
        for mb in (half, b):  # warm-up of both shapes
            _batched_run(lanes[:, :5].contiguous(), times[:, :5], cfg, cam, mb)
        got = {half: [], b: []}
        for mb in (half, b, b, half):
            torch.cuda.reset_peak_memory_stats()
            dt, es, outs, counts = _batched_run(lanes, times, cfg, cam, mb)
            peak[(b, mb)] = torch.cuda.max_memory_allocated()
            _check_lanes(f"microbatch B={b} chunks of {mb}", es, outs)
            k = b // mb
            if counts["lk_level"] != k * (n - 1) or counts["fast9"] != k * n:
                raise AssertionError(f"[microbatch] B={b} chunks of {mb}: "
                                     f"launch counts {counts}")
            got[mb].append(1e3 * dt / (n - 1))
        out[b] = {mb: sum(v) / len(v) for mb, v in got.items()}
        print(f"[microbatch] B={b} over {n} frames: one batch "
              f"{out[b][b]:.2f} ms a frame of all lanes "
              f"({b / out[b][b] * 1e3:.1f} frames/s; turns "
              f"{', '.join(f'{x:.2f}' for x in got[b])}), two chunks of "
              f"{half} {out[b][half]:.2f} ms ({b / out[b][half] * 1e3:.1f} "
              f"frames/s; turns {', '.join(f'{x:.2f}' for x in got[half])})"
              f"; one batch / chunks {out[b][b] / out[b][half]:.3f} on {card}")
        print(f"[microbatch] B={b}: torch.cuda.max_memory_allocated "
              f"{peak[(b, b)] / 2 ** 20:.1f} MiB as one batch, "
              f"{peak[(b, half)] / 2 ** 20:.1f} MiB in chunks of {half} "
              f"(graphed; Sigma alone {b * cfg.state_dim ** 2 * 4 / 2 ** 20:.1f}"
              f" MiB a copy)")
        out[b]["peak_mib"] = peak[(b, b)] / 2 ** 20
    return out


def phase_batched_profile(lanes16, step_ms: float) -> None:
    """torch.profiler over 5 steady-state batched steps at B = 16."""
    from ekf_vio_tpu_torch import engine

    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    times = torch.arange(16, dtype=torch.float32,
                         device=lanes16.device) / 20.0
    init = torch.func.vmap(lambda im, t: engine.initialize(im, t, cfg, cam))
    step = torch.func.vmap(lambda es, im, t: engine.step(es, im, t, cfg, cam))
    es = init(lanes16[:, 0], times[0].expand(16))
    for i in range(1, 10):
        es, _ = step(es, lanes16[:, i], times[i].expand(16))

    def run():
        e = es
        for i in range(10, 15):
            e, _ = step(e, lanes16[:, i], times[i].expand(16))

    _profile_steps(run, step_ms, "batched step B=16")


def _path_f_cfg():
    """Path (f): path (b)'s window in vision mode."""
    return _mono_cfg(17).replace(triangulate_new_features=False)


def phase_batched_klt(seqs, card: str) -> dict:
    """Path (f): ``run_sequences_batched`` over B = 4 lanes of rendered
    320x240 sequences (seeds 0-3), 60 frames, klt_window_size=17 (vision
    mode: no second tracker call), graphed against eager in turns:
    'cuda_klt', klt_level = lk_level = T-1
    and fast9 = T launches, every lane finite with more than 10 tracks
    from frame 5 on."""
    from ekf_vio_tpu_torch.frontend import klt
    from ekf_vio_tpu_torch.parallel import batched_engine

    cfg = _path_f_cfg()
    cam = _mono_cam(seqs[0])
    images = torch.from_numpy(np.stack([q.frames for q in seqs])).cuda()
    times = torch.from_numpy(np.stack([q.times for q in seqs])).cuda()
    b, n = images.shape[:2]
    backend = klt.selected_backend(images.shape[2:], cfg.max_features, cfg,
                                   images.device)
    if backend != "cuda_klt":
        raise AssertionError(f"tracker backend: {backend}")
    want = {"lk_level": n - 1, "fast9": n, "klt_level": n - 1}
    ge = _graph_vs_eager(
        "path f", lambda: batched_engine.run_sequences_batched(
            images, times, cfg, cam, microbatch=b), b * (n - 1), want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    best = 1e-3 * ge["step_ms"] * b * (n - 1)
    _check_lanes("path f", es, outs)
    print(f"[path f] run_sequences_batched, {b} lanes x {n} rendered frames "
          f"320x240, win 17, backend {backend}: {b * (n - 1) / best:.1f} "
          f"frames/s in all graphed ({best * 1e3:.1f} ms) on {card}; "
          f"tracked from "
          f"frame 5 min {int(outs.num_tracked[:, 5:].min())}; launches "
          f"{counts}")
    return {"fps": b * (n - 1) / best, "launches": counts}


def phase_simulator(card: str) -> None:
    """The closed-loop simulator on the card: the six reference scenarios
    (covariance form), then scenario 6 at 128 slots for 100 steps in both
    forms, graphed against eager in turns, each held to min diag >= -1e-5,
    asymmetry < 1e-3 and a final feat_err under 1e-3."""
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.sim import simulator

    def check(name, telem):
        min_diag, asym, pos_err, feat_err = (t.cpu() for t in telem)
        print(f"[sim] {name}: min diag {float(min_diag.min()):.3e}, "
              f"asymmetry {float(asym.max()):.3e}, final pos_err "
              f"{float(pos_err[-1]):.4e} m, final feat_err "
              f"{float(feat_err[-1]):.3e} ({card})")
        if not (float(min_diag.min()) >= -1e-5 and float(asym.max()) < 1e-3
                and float(feat_err[-1]) < 1e-3):
            raise AssertionError(f"[sim] {name}: outside the bar")

    t0 = time.perf_counter()
    for k, (scn, _, _, telem) in enumerate(
            simulator.run_reference_scenarios()):
        check(f"scenario {k + 1} ({scn.feature_count} features, "
              f"{len(telem[0])} steps)", telem)
    none = {"lk_level": 0, "fast9": 0, "klt_level": 0}
    for sq in (False, True):
        cfg = VIOConfig(max_features=128, square_root_form=sq)
        form = "square-root" if sq else "covariance"
        ge = _graph_vs_eager(
            f"sim {form}", lambda cfg=cfg: simulator.run_scenario(
                simulator.REFERENCE_SCENARIOS[5], cfg, 100,
                generator=torch.Generator().manual_seed(0)), 100, none, card)
        check(f"scenario 6, 128 slots, 100 steps, {form} form",
              ge["result"][2])
    print(f"[sim] all in {time.perf_counter() - t0:.1f} s")


def _write_asl_tree(root: str, n: int) -> str:
    """A format-faithful EuRoC mav0 tree of ``n`` 752x480 frames (bench
    texture, 1 px a frame), nanosecond stamps past float64's exact range,
    200 Hz stationary IMU and ground truth.  Returns the mav0 path."""
    from ekf_vio_tpu_torch.viz.insight import write_png

    mav0 = os.path.join(root, "mav0")
    cam_dir = os.path.join(mav0, "cam0", "data")
    os.makedirs(cam_dir)
    os.makedirs(os.path.join(mav0, "imu0"))
    os.makedirs(os.path.join(mav0, "state_groundtruth_estimate0"))
    t0, frame_ns, imu_ns = 1403636579763555584, 50_000_000, 5_000_000
    rng = np.random.RandomState(0)
    import scipy.ndimage as ndi

    tex = ndi.gaussian_filter(rng.uniform(0, 255, (480, 752 + n)), 2.0)
    tex = (tex - tex.min()) / np.ptp(tex) * 255.0
    lines = ["#timestamp [ns],filename"]
    for i in range(n):
        ts = t0 + i * frame_ns
        write_png(os.path.join(cam_dir, f"{ts}.png"),
                  tex[:, i: i + 752].astype(np.uint8))
        lines.append(f"{ts},{ts}.png")
    with open(os.path.join(mav0, "cam0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    imu = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
    imu += [f"{t0 + (k + 1) * imu_ns},0.0,0.0,0.0,0.0,0.0,9.81"
            for k in range(n * frame_ns // imu_ns)]
    with open(os.path.join(mav0, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu) + "\n")
    gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v,v,v,bw,bw,bw,ba,ba,ba"]
    gt += [f"{t0 + i * frame_ns},{0.001 * i},0,0,1,0,0,0,0,0,0,0,0,0,0,0,0"
           for i in range(n)]
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(gt) + "\n")
    return mav0


def _cli(*runs) -> list:
    """``python -m ekf_vio_tpu_torch run <args>`` for each ``runs`` entry,
    all in subprocesses on the card at once; a non-zero exit fails the
    run.  Returns their summary JSONs."""
    t0 = time.perf_counter()
    # the host's cores shared out, so the runs' CPU thread pools do not
    # oversubscribe them
    threads = str(max(1, (os.cpu_count() or 1) // len(runs)))
    env = dict(os.environ, OMP_NUM_THREADS=threads, MKL_NUM_THREADS=threads)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ekf_vio_tpu_torch", "run", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__))) for args in runs]
    outs = [p.communicate() for p in procs]
    summaries = []
    for args, p, (out, err) in zip(runs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"[cli] {' '.join(args)} exited "
                                 f"{p.returncode}:\n{err[-3000:]}")
        summaries.append(json.loads(out[out.index("{"):]))
        print(f"[cli] run {' '.join(args)}: {json.dumps(summaries[-1])}")
    print(f"[cli] {len(runs)} runs side by side: "
          f"{time.perf_counter() - t0:.1f} s")
    return summaries


def _tree_digest(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(os.listdir(path)):
        h.update(name.encode())
        with open(os.path.join(path, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def phase_cli_io(card: str) -> None:
    """The CLI on the card in subprocesses (--synthetic 60; --rendered 40
    at configs/mono_inertial.yaml with ATE under 0.01 m; --euroc on a
    12-frame ASL tree this phase writes), the frame loader's route, and
    native/ unchanged."""
    import tempfile

    from ekf_vio_tpu_torch.io import euroc, frame_loader

    here = os.path.dirname(os.path.abspath(__file__))
    native = os.path.join(here, "native")
    before = _tree_digest(native)
    with tempfile.TemporaryDirectory() as tmp:
        mav0 = _write_asl_tree(tmp, 12)
        seq = euroc.load_sequence(mav0)
        loader = frame_loader.FrameLoader(seq.image_paths[:2])
        route = loader.route
        loader.close()
        why = ("native/frameloader.cpp built" if route == "native"
               else "g++ or libpng missing: the stdlib PNG reader")
        print(f"[io] FrameLoader.route = {route} ({why})")
        synthetic, rendered, asl = _cli(
            ("--synthetic", "60"),
            ("--rendered", "40", "--config",
             os.path.join(here, "configs", "mono_inertial.yaml")),
            ("--euroc", mav0))
    if synthetic["frames"] != 60 or synthetic["mode"] != "vision-only":
        raise AssertionError(f"[cli] synthetic summary {synthetic}")
    if rendered["mode"] != "imu" or not rendered["ate_rmse_m"] < 0.01:
        raise AssertionError(f"[cli] rendered summary {rendered}")
    if asl["frames"] != 12:
        raise AssertionError(f"[cli] euroc summary {asl}")
    if _tree_digest(native) != before:
        raise AssertionError("[io] native/ changed")
    print(f"[io] native/ unchanged ({card})")
    phase_cli_streaming(card)


def phase_cli_streaming(card: str) -> dict:
    """The CLI's streaming loop in this process: ``run --rendered 40
    --config configs/mono_inertial.yaml --insight-dir DIR`` runs the
    compiled step (``scan.graphed(engine.step)``, one replay a frame) and
    reads each frame back for drawing between replays; graphed against
    eager in turns: the summaries equal but for the CLI's frames/s,
    lk_level = T-1 and fast9 = T-9 launches, ATE under 0.01 m."""
    import io
    import tempfile

    from ekf_vio_tpu_torch import cli

    here = os.path.dirname(os.path.abspath(__file__))
    n, k0 = 40, _mono_cfg().vi_init_frames
    cli_fps = []

    def run():
        with tempfile.TemporaryDirectory() as tmp:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["run", "--rendered", str(n), "--config",
                               os.path.join(here, "configs",
                                            "mono_inertial.yaml"),
                               "--insight-dir", tmp, "--log-every", "0"])
            pngs = len(os.listdir(tmp))
        out = buf.getvalue()
        summary = json.loads(out[out.index("{"):])
        if rc != 0 or pngs != n - k0:
            raise AssertionError(f"[cli streaming] rc {rc}, {pngs} frames "
                                 f"drawn")
        cli_fps.append(summary.pop("fps"))
        return summary

    want = {"lk_level": n - 1, "fast9": n - k0 + 1, "klt_level": 0}
    ge = _graph_vs_eager("cli streaming", run, n - k0, want, card)
    summary = ge["result"]
    if summary["mode"] != "imu" or not summary["ate_rmse_m"] < 0.01:
        raise AssertionError(f"[cli streaming] summary {summary}")
    fps = {"graph": max(cli_fps[0::2]), "eager": max(cli_fps[1::2])}
    GRAPHS["cli streaming"]["cli_fps"] = fps
    print(f"[cli streaming] the CLI's own frames/s (the step and its "
          f"sync, drawing excluded): graph {fps['graph']:.1f}, eager "
          f"{fps['eager']:.1f}; ATE {summary['ate_rmse_m']} m; summary "
          f"{json.dumps(summary)} ({card})")
    return fps


# --------------------------------------------------------------------------
# The distributed layer: parallel/mesh, sharded_filter, sharded_engine,
# evidence, the mesh halves of batched / batched_engine
# --------------------------------------------------------------------------


N_SHARDED = 60        # frames of the sharded path (c)
N_SHARDED_MONO = 40   # rendered frames of the sharded mono-inertial path


def phase_dist_init(card: str):
    """The process group (NCCL, one rank, a tcp://127.0.0.1 store on a
    free port, through ``multihost.initialize_distributed``) and the
    (1, 1) mesh on the card."""
    import torch.distributed as dist

    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod
    from ekf_vio_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    info = multihost.initialize_distributed()
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}, not nccl")
    mesh = mesh_mod.make_mesh(1, 1)
    if mesh.device_type != "cuda":
        raise AssertionError(f"mesh on {mesh.device_type}")
    print(f"[dist] {info}, backend nccl, mesh {tuple(mesh.mesh.shape)} "
          f"('data', 'state') on {card}: {time.perf_counter() - t0:.2f} s")
    return mesh


def _sharded_check_sigma(tag, es, mesh) -> None:
    from ekf_vio_tpu_torch.core import filter as ekf
    from ekf_vio_tpu_torch.parallel import sharded_filter as sf

    filt = sf.merge_state(es.filt, mesh)
    if not torch.isfinite(filt.Sigma).all():
        raise AssertionError(f"[{tag}] non-finite Sigma")
    min_diag, asym = (float(x) for x in ekf.check_sigma(filt))
    print(f"[{tag}] merged Sigma: min diag {min_diag:.3e}, asymmetry "
          f"{asym:.3e}")
    if not (min_diag >= -1e-5 and asym < 1e-3):
        raise AssertionError(f"[{tag}] check_sigma: min diag {min_diag}, "
                             f"asymmetry {asym}")


def _same_rollout(tag, sharded, dense) -> None:
    """Every tracked / active count equal, base_mu within the rollout
    drift bar of tests/test_torch_engine.py (5e-3)."""
    same_t = torch.equal(sharded.num_tracked, dense.num_tracked)
    same_a = torch.equal(sharded.num_active, dense.num_active)
    dmu = (sharded.base_mu - dense.base_mu).abs().max().item()
    print(f"[{tag}] sharded vs dense rollout: num_tracked equal {same_t}, "
          f"num_active equal {same_a}, max|dbase_mu| {dmu:.3e}")
    if not (same_t and same_a and dmu < 5e-3):
        raise AssertionError(f"[{tag}] sharded and dense rollouts differ")


def phase_sharded_fwi(frames_dev, times_dev, card: str, mesh,
                      dense_fps: float) -> dict:
    """Path (g): ``sharded_engine.run_sequence`` at path (c)'s
    configuration (fast_with_insight, 512 slots, D = 1558) on the (1, 1)
    NCCL mesh over 60 frames, graphed (the step and its collectives in one
    captured graph) against eager in turns: bench.py's asserts
    (finite state, more than 10 tracks from frame 5 on, more than 250 on
    average from frame 10), Σ checks on the merged state, 'cuda_lk',
    lk_level = T-1 and fast9 = T launches; a 10-frame sharded rollout
    against the dense ``run_sequence`` on the card; and the same 10
    frames with two-view depths (vision mode), whose back-track is a
    second lk_level launch a frame: lk_level = 2(T-1) on both engines."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera, klt
    from ekf_vio_tpu_torch.parallel import sharded_engine as se

    cfg = _fwi_cfg()
    s = cfg.inverse_image_scale
    cam = _cam(s)
    small = camera.downscale_image(frames_dev[:N_SHARDED], s).contiguous()
    times = times_dev[:N_SHARDED]
    n = small.shape[0]
    backend = klt.selected_backend(small.shape[1:], cfg.max_features, cfg,
                                   small.device)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")
    want = {"lk_level": n - 1, "fast9": n, "klt_level": 0}
    ge = _graph_vs_eager(
        "path g", lambda: se.run_sequence(small, times, cfg, cam, mesh),
        n - 1, want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    tracked = outs.num_tracked.cpu().numpy()
    if not torch.isfinite(outs.base_mu).all():
        raise AssertionError("[path g] non-finite base state")
    if tracked[5:].min() <= 10 or not tracked[10:].mean() > 250:
        raise AssertionError(f"[path g] tracking: {tracked.tolist()}")
    _sharded_check_sigma("path g", es, mesh)
    fps = ge["fps"]
    print(f"[path g] sharded_engine.run_sequence, {n} bench frames "
          f"{small.shape[2]}x{small.shape[1]}, {cfg.max_features} slots "
          f"(D = {cfg.state_dim}), mesh (1, 1) NCCL, backend {backend}: "
          f"{fps:.1f} frames/s graphed against dense path (c) "
          f"{dense_fps:.1f} frames/s in this call, on {card}; "
          f"tracked mean from frame 10 {tracked[10:].mean():.1f}, min "
          f"{tracked[10:].min()}; launches {counts}")

    k = 10
    _, sh = se.run_sequence(small[:k], times[:k], cfg, cam, mesh)
    _, de = engine.run_sequence(small[:k], times[:k], cfg, cam)
    _same_rollout("path g", sh, de)

    tcfg = cfg.replace(triangulate_new_features=True)
    want_t = {"lk_level": 2 * (k - 1), "fast9": k, "klt_level": 0}
    _reset_counts()
    _, sh = se.run_sequence(small[:k], times[:k], tcfg, cam, mesh)
    tri_counts = _counts()
    _reset_counts()
    _, de = engine.run_sequence(small[:k], times[:k], tcfg, cam)
    if not tri_counts == _counts() == want_t:
        raise AssertionError(f"[path g] two-view depths: launch counts "
                             f"{tri_counts}, dense {_counts()}, expected "
                             f"{want_t}")
    print(f"[path g] {k} frames with two-view depths (the back-track): "
          f"launches {tri_counts} on the sharded and the dense engine")
    _same_rollout("path g, two-view depths", sh, de)
    return {"fps": fps, "launches": counts, "launches_backtrack": tri_counts,
            "step_ms": ge["step_ms"], "eager_step_ms": ge["eager_step_ms"]}


def phase_sharded_mono(seq, card: str, mesh) -> dict:
    """Path (h): ``sharded_engine.run_sequence_imu`` at path (a)'s
    configuration (128 slots, 21-px window) over the first 40 rendered
    frames, VI initialization included, graphed against eager in turns:
    'cuda_lk', lk_level = T-1 (the VI initialization's chained tracks,
    then one a frame: in IMU mode the step makes no back-track, as the
    JAX step) and fast9 = T-9 launches, finite state, more than 10 tracks
    from 5 frames after the initialization, ATE under 0.01 m, mean_nis 0
    on every frame (the reference defect)."""
    from ekf_vio_tpu_torch.frontend import klt
    from ekf_vio_tpu_torch.io.trajectory import ate_rmse
    from ekf_vio_tpu_torch.parallel import sharded_engine as se

    cfg = _mono_cfg(21)
    cam = _mono_cam(seq)
    k0 = cfg.vi_init_frames
    n = N_SHARDED_MONO
    h, w = seq.frames.shape[1:]
    want = {"lk_level": n - 1, "fast9": n - k0 + 1, "klt_level": 0}
    from ekf_vio_tpu_torch.parallel.mesh import mesh_device

    dev = mesh_device(mesh)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        seq.frames[:n], seq.times[:n], seq.imu_dt[:n - 1],
        seq.imu_gyro[:n - 1], seq.imu_accel[:n - 1], seq.gravity_w))
    backend = klt.selected_backend((h, w), cfg.max_features, cfg, dev)
    if backend != "cuda_lk":
        raise AssertionError(f"tracker backend: {backend}")
    ge = _graph_vs_eager(
        "path h", lambda: se.run_sequence_imu(*args, cfg, cam, mesh,
                                              init_frames=k0),
        n - 1, want, card)
    es, outs = ge["result"]
    counts = ge["counts"]
    tracked = outs.num_tracked.cpu().numpy()
    if not torch.isfinite(outs.base_mu).all():
        raise AssertionError("[path h] non-finite base state")
    if tracked[5:].min() <= 10:
        raise AssertionError(f"[path h] lost tracking: {tracked.tolist()}")
    if not (outs.mean_nis == 0).all():
        raise AssertionError("[path h] mean_nis is not the reference's 0")
    _sharded_check_sigma("path h", es, mesh)
    ate = ate_rmse(seq.times[k0:n], outs.base_mu[:, :3].cpu().numpy(),
                   seq.times, seq.gt_pos)
    fps = ge["fps"]
    print(f"[path h] sharded_engine.run_sequence_imu, {n} rendered frames "
          f"320x240, 128 slots, mesh (1, 1) NCCL, backend {backend}: "
          f"{fps:.1f} frames/s graphed (VI init included) on "
          f"{card}; tracked min {tracked[5:].min()} mean {tracked.mean():.1f}"
          f"; ATE {ate * 1e3:.2f} mm; mean_nis 0 on every frame; launches "
          f"{counts}")
    if not ate < 0.01:
        raise AssertionError(f"[path h] ATE {ate:.4f} m is not under 0.01 m")
    return {"fps": fps, "launches": counts, "ate": ate}


def phase_config5(card: str, mesh) -> dict:
    """BASELINE.json config 5 on the card: 256 slots (D = 790), every slot
    active, every 4th unmeasured (benchmarks/scaling_dryrun.py:50-63);
    ``sharded_predict`` + ``sharded_update`` on the (1, 1) mesh against
    the dense predict + update (Σ within 1e-4 absolute, about 4.5 times
    the 2.2e-5 a sound run showed; the means within 2e-5, the update bar
    of tests/test_torch_sharded.py), both timed with CUDA events in
    turns; the c10d
    collectives of a profiler trace (more than 0) and this rank's Σ
    bytes."""
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.core import filter as ekf
    from ekf_vio_tpu_torch.parallel import evidence
    from ekf_vio_tpu_torch.parallel import sharded_filter as sf
    from ekf_vio_tpu_torch.parallel.mesh import mesh_device

    cfg = VIOConfig(max_features=sf.aligned_feature_capacity(256, 1))
    n = cfg.max_features
    dev = mesh_device(mesh)
    uv = torch.rand(n, 2, generator=torch.Generator().manual_seed(0)) * 2 - 1
    st = ekf.add_features(ekf.init_state(cfg, device=dev), cfg, uv.to(dev),
                          torch.ones(n, dtype=torch.bool, device=dev))
    mc = (torch.eye(2, device=dev) * 1e-5).expand(n, 2, 2)
    z = st.feat_mu[:, :2] + 0.01
    passed = torch.arange(n, device=dev) % 4 != 0
    s0 = sf.split_state(st, mesh)

    def sharded():
        s = sf.sharded_predict(s0, cfg, 0.05, mesh)
        return sf.sharded_update(s, cfg, z, mc, passed, mesh)

    def dense():
        d = ekf.predict(st, cfg, 0.05)
        return ekf.update_with_feature_positions(d, cfg, z, mc, passed)

    m, d = sf.merge_state(sharded(), mesh), dense()
    sig_err = (m.Sigma - d.Sigma).abs().max().item()
    sig_scale = d.Sigma.abs().max().item()
    mu_err = max((m.base_mu - d.base_mu).abs().max().item(),
                 (m.feat_mu - d.feat_mu).abs().max().item())
    times = {k: [] for k in ("sharded", "dense")}
    for k in ("sharded", "dense", "dense", "sharded"):
        times[k].append(_wall_ms(sharded if k == "sharded" else dense, 20))
    ms = {k: sum(v) / 2 for k, v in times.items()}
    inv = evidence.collective_inventory(sharded)
    mem = evidence.memory_analysis(s0)
    print(f"[config 5] {n} slots (D = {cfg.state_dim}), every 4th slot "
          f"unmeasured: sharded_predict + sharded_update {ms['sharded']:.3f} "
          f"ms, dense predict + update {ms['dense']:.3f} ms (CUDA events, "
          f"20 calls, in turns) on {card}; max|dSigma| {sig_err:.3e} "
          f"(scale {sig_scale:.3e}), max|dmu| {mu_err:.3e}; "
          f"collectives {inv}; memory {mem}")
    if not (sig_err < 1e-4 and mu_err < 2e-5):
        raise AssertionError("[config 5] sharded and dense disagree")
    if not inv["total"] > 0:
        raise AssertionError("[config 5] no collective in the trace")
    return {"ms": ms, "collectives": inv, "memory": mem}


def phase_mesh_batching(lanes16, card: str, mesh) -> dict:
    """Path (j): the mesh step of ``make_batched_filter_step(cfg, mesh)``
    on 4 lanes at 128 slots against the mesh-less step (mean rtol 1e-5
    atol 1e-5, Σ rtol 1e-4 atol 5e-5); each compiled step (a graph
    replayed a call, the mesh step's all-gather inside it) against its
    eager form; ``scaling_efficiency_probe``'s ms a step, and the mesh
    and mesh-less steps, graphed and eager, timed in turns;
    ``run_sequences_sharded`` over 4 lanes of 30 bench frames
    equal to ``run_sequences_batched`` in every count, lk_level = T-1 and
    fast9 = T launches for all lanes together."""
    from ekf_vio_tpu_torch.parallel import batched, batched_engine
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod

    cfg = _bench_cfg()
    dev = mesh_mod.mesh_device(mesh)
    state = batched.init_batched_state(
        cfg, 4, generator=torch.Generator().manual_seed(0), device=dev)
    z = state.feat_mu[:, :, :2] + 0.01
    meshless = batched.make_batched_filter_step(cfg)
    ref = meshless(state, z, 0.05)
    specs = mesh_mod.filter_state_shardings(mesh, True)
    local = mesh_mod.local_blocks(state, specs, mesh)
    z_l = mesh_mod.local_blocks(z, ("data", None, None), mesh)
    mesh_step = batched.make_batched_filter_step(cfg, mesh)
    got = mesh_mod.gather_blocks(mesh_step(local, z_l, 0.05), specs, mesh)
    for k, rtol, atol in (("base_mu", 1e-5, 1e-5), ("feat_mu", 1e-5, 1e-5),
                          ("Sigma", 1e-4, 5e-5)):
        a, b = getattr(got, k), getattr(ref, k)
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"[path j] mesh step {k}: max diff "
                                 f"{(a - b).abs().max().item():.3e}")
    # the compiled steps (scan.graphed: the first call captures, later
    # calls replay) against the eager ones
    with _eager():
        eager_steps = {"mesh": batched.make_batched_filter_step(cfg, mesh),
                       "meshless": batched.make_batched_filter_step(cfg)}
    args = {"mesh": (local, z_l, 0.05), "meshless": (state, z, 0.05)}
    steps = {"mesh": mesh_step, "meshless": meshless}
    for k in ("mesh", "meshless"):
        e1 = eager_steps[k](*args[k])
        e2 = eager_steps[k](*args[k])
        g = steps[k](*args[k])  # a replay: both were called before
        gap, eager_gap = _gap(g, e1), _gap(e2, e1)
        print(f"[path j] {k} step, graph vs eager max|d| {gap:.3e} (eager "
              f"vs eager {eager_gap:.3e})")
        if not gap <= eager_gap:
            raise AssertionError(f"[path j] {k} step: graph and eager "
                                 f"differ")
    probe_s = batched.scaling_efficiency_probe(cfg, mesh, 4, steps=10)
    variants = [(k, m) for k in ("mesh", "meshless")
                for m in ("graph", "eager")]
    times = {v: [] for v in variants}
    for k, m in variants + variants[::-1]:
        fn = steps[k] if m == "graph" else eager_steps[k]
        times[(k, m)].append(_wall_ms(lambda: fn(*args[k]), 10))
    ms = {v: sum(t) / 2 for v, t in times.items()}
    step_ms = {"mesh": ms[("mesh", "graph")],
               "meshless": ms[("meshless", "graph")]}
    GRAPHS["path j"] = {f"{k}_{m}_ms": t for (k, m), t in ms.items()}

    cam = _cam(cfg.inverse_image_scale)
    lanes = lanes16[:4, :30].contiguous()
    n = lanes.shape[1]
    times = (torch.arange(n, dtype=torch.float32, device=dev)
             / 20.0).expand(4, -1)
    want = {"lk_level": n - 1, "fast9": n, "klt_level": 0}
    _reset_counts()
    es, outs = batched_engine.run_sequences_sharded(lanes, times, cfg, cam,
                                                    mesh)
    counts = _counts()
    if counts != want:
        raise AssertionError(f"[path j] launch counts {counts}, expected "
                             f"{want}")
    _check_lanes("path j", es, outs)
    _, ref_outs = batched_engine.run_sequences_batched(lanes, times, cfg, cam)
    if not (torch.equal(outs.num_tracked, ref_outs.num_tracked)
            and torch.equal(outs.num_active, ref_outs.num_active)):
        raise AssertionError("[path j] run_sequences_sharded and "
                             "run_sequences_batched differ")
    dmu = (outs.base_mu - ref_outs.base_mu).abs().max().item()
    print(f"[path j] mesh step (4 lanes, 128 slots) equal to the mesh-less "
          f"step at the bars; scaling_efficiency_probe {probe_s * 1e3:.3f} "
          f"ms a step on {card}; CUDA events, 10 steps, in turns: mesh step "
          f"graphed {ms[('mesh', 'graph')]:.3f} ms, eager "
          f"{ms[('mesh', 'eager')]:.3f} ms; mesh-less graphed "
          f"{ms[('meshless', 'graph')]:.3f} ms, eager "
          f"{ms[('meshless', 'eager')]:.3f} ms; run_sequences_sharded 4 "
          f"lanes x {n} frames "
          f"equal to run_sequences_batched in every count (max|dbase_mu| "
          f"{dmu:.3e}); launches {counts}")
    return {"launches": counts, "probe_ms": probe_s * 1e3,
            "step_ms": step_ms}


def phase_sharded_profile(frames_dev, times_dev, step_ms: float,
                          mesh) -> None:
    """torch.profiler over 5 steady-state steps of path (g)."""
    from ekf_vio_tpu_torch.frontend import camera
    from ekf_vio_tpu_torch.parallel import sharded_engine as se

    cfg = _fwi_cfg()
    cam = _cam(cfg.inverse_image_scale)
    small = camera.downscale_image(frames_dev[:16],
                                   cfg.inverse_image_scale).contiguous()
    es = se.initialize(small[0], times_dev[0], cfg, cam, mesh)
    for i in range(1, 10):
        es, _ = se.step(es, small[i], times_dev[i], cfg, cam, mesh)

    def run():
        e = es
        for i in range(10, 15):
            e, _ = se.step(e, small[i], times_dev[i], cfg, cam, mesh)

    _profile_steps(run, step_ms, "sharded 512-slot vision step")


def phase_replay_profiles(frames_dev, times_dev, seq, seqs4, lanes16,
                          mesh) -> None:
    """torch.profiler over 5 replayed steps (replays 6-10) of each path's
    compiled rollout, on its first frames, and the wall time of replays
    11-15: device ops and time a step, the busy share, and the kernels by
    name in the trace (the witness that the graph launched them)."""
    import tempfile

    from ekf_vio_tpu_torch import cli, engine
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.frontend import camera
    from ekf_vio_tpu_torch.parallel import batched, batched_engine
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod
    from ekf_vio_tpu_torch.parallel import sharded_engine as se
    from ekf_vio_tpu_torch.sim import simulator

    n = 17  # frame 0, the eager frame 1, then 15 replays
    one = {"lk_level": 1, "fast9": 1, "klt_level": 0}
    both = {"lk_level": 1, "fast9": 1, "klt_level": 1}
    none = {"lk_level": 0, "fast9": 0, "klt_level": 0}
    bcfg, fcfg = _bench_cfg(), _fwi_cfg()
    small = camera.downscale_image(frames_dev[:n], 4).contiguous()
    half = camera.downscale_image(frames_dev[:n], 2).contiguous()
    t = times_dev[:n]
    k0 = _mono_cfg().vi_init_frames
    mono = tuple(torch.from_numpy(np.ascontiguousarray(a[:m])).cuda()
                 for a, m in ((seq.frames, k0 + n), (seq.times, k0 + n),
                              (seq.imu_dt, k0 + n - 1),
                              (seq.imu_gyro, k0 + n - 1),
                              (seq.imu_accel, k0 + n - 1),
                              (seq.gravity_w, 3)))
    mcam = _mono_cam(seq)
    _profile_replays("main", lambda: engine.run_sequence(
        small, t, bcfg, _cam(4)), one)
    _profile_replays("path c", lambda: engine.run_sequence(
        half, t, fcfg, _cam(2)), one)
    for tag, win, sq, per in (("path a", 21, False, one),
                              ("path b", 17, False, both),
                              ("path d", 21, True, one)):
        _profile_replays(tag, lambda win=win, sq=sq: engine.run_sequence_imu(
            *mono, _mono_cfg(win, sq), mcam, init_frames=k0), per)
    _profile_replays("path e", lambda: batched_engine.run_sequences_batched(
        lanes16[:, :n].contiguous(), t.expand(16, -1), bcfg, _cam(4)), one)
    f_imgs = torch.from_numpy(np.stack([q.frames[:n] for q in seqs4])).cuda()
    f_t = torch.from_numpy(np.stack([q.times[:n] for q in seqs4])).cuda()
    _profile_replays("path f", lambda: batched_engine.run_sequences_batched(
        f_imgs, f_t, _path_f_cfg(), mcam), both)
    with tempfile.TemporaryDirectory() as tmp:
        _profile_replays("cli streaming", lambda: cli._run_streaming(
            mono[0], mono[1], _mono_cfg(), mcam, mono[2:5], tmp, 0,
            gravity_w=mono[5]), one)
    for sq in (False, True):
        _profile_replays(
            f"sim {'square-root' if sq else 'covariance'}",
            lambda sq=sq: simulator.run_scenario(
                simulator.REFERENCE_SCENARIOS[5],
                VIOConfig(max_features=128, square_root_form=sq), n,
                generator=torch.Generator().manual_seed(0)), none)
    _profile_replays("path g", lambda: se.run_sequence(
        half, t, fcfg, _cam(2), mesh), one)
    _profile_replays("path h", lambda: se.run_sequence_imu(
        *mono, _mono_cfg(), mcam, mesh, init_frames=k0), one)
    state = batched.init_batched_state(
        bcfg, 4, generator=torch.Generator().manual_seed(0),
        device=mesh_mod.mesh_device(mesh))
    local = mesh_mod.local_blocks(
        state, mesh_mod.filter_state_shardings(mesh, True), mesh)
    z = mesh_mod.local_blocks(state.feat_mu[:, :, :2] + 0.01,
                              ("data", None, None), mesh)

    def mesh_steps():
        step = batched.make_batched_filter_step(bcfg, mesh)
        s = local
        for _ in range(n):
            s = step(s, z, 0.05)

    _profile_replays("path j", mesh_steps, none)


def _two_rank_step(mesh, dev):
    """One sharded engine step on bench frames 0 -> 1 at 160x120 (128
    slots).  Returns (the tracked count, the merged stepped state)."""
    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera
    from ekf_vio_tpu_torch.parallel import sharded_engine as se
    from ekf_vio_tpu_torch.parallel import sharded_filter as sf
    from ekf_vio_tpu_torch.sim.frames import make_frames

    engine.use_f32_matmul()
    cfg = _bench_cfg()
    cam = _cam(cfg.inverse_image_scale)
    frames, times = make_frames(seed=0, n_frames=2)
    small = camera.downscale_image(torch.from_numpy(frames).to(dev),
                                   4).contiguous()
    times = torch.from_numpy(times).to(dev)
    es0 = se.initialize(small[0], times[0], cfg, cam, mesh)
    es1, out = se.step(es0, small[1], times[1], cfg, cam, mesh)
    return out.num_tracked, sf.merge_state(es1.filt, mesh)


def _two_rank_update(stepped, mesh):
    """One update of the dense state ``stepped`` (every 3rd slot
    unmeasured, z = μ_uv + 0.01): sharded on ``mesh``, merged, or the
    dense ``update_with_feature_positions`` when ``mesh`` is None."""
    from ekf_vio_tpu_torch.core import filter as ekf
    from ekf_vio_tpu_torch.parallel import sharded_filter as sf

    cfg = _bench_cfg()
    n, dev = cfg.max_features, stepped.Sigma.device
    mc = (torch.eye(2, device=dev) * 1e-5).expand(n, 2, 2)
    passed = (torch.arange(n, device=dev) % 3 != 0) & stepped.active
    z = stepped.feat_mu[:, :2] + 0.01
    if mesh is None:
        return ekf.update_with_feature_positions(stepped, cfg, z, mc, passed)
    return sf.merge_state(sf.sharded_update(sf.split_state(stepped, mesh),
                                            cfg, z, mc, passed, mesh), mesh)


def _np_filter(tag: str, filt) -> dict:
    from ekf_vio_tpu_torch import interop

    return {f"{tag}_{k}": v
            for k, v in interop.filter_state_to_numpy(filt).items()}


def _two_rank_main(rank: int, port: int, workdir: str) -> None:
    """One of the two gloo ranks on the card (``--two-ranks``): the step,
    the update of the ns = 1 stepped state and the update of its own."""
    import torch.distributed as dist

    from ekf_vio_tpu_torch import interop
    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mesh = mesh_mod.make_mesh(1, 2, device="cuda")
    stepped_ns1 = interop.filter_state_from_numpy(
        dict(np.load(os.path.join(workdir, "stepped.npz"))), dev)
    tracked, stepped = _two_rank_step(mesh, dev)
    res = {"num_tracked": tracked.cpu().numpy(),
           **_np_filter("step", stepped),
           **_np_filter("update", _two_rank_update(stepped_ns1, mesh)),
           **_np_filter("update_own", _two_rank_update(stepped, mesh))}
    if rank == 0:
        np.savez(os.path.join(workdir, "two_ranks.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def phase_two_ranks(card: str, mesh) -> dict:
    """Two processes on the one card, gloo (NCCL puts no two ranks on one
    GPU; gloo carries CUDA tensors for every collective the layer uses),
    mesh (1, 2): one sharded engine step and one sharded update, merged,
    against the same on the (1, 1) NCCL mesh of this process: tracked
    count and active equal, means within 2e-5, Σ within 5e-4 after the
    step and 5e-5 after the update (the bars of
    tests/test_torch_sharded.py), the update run on this process's
    stepped state on both sides.

    Each side's update of its own stepped state differs by more (the
    update amplifies the step's roundoff).  The witness that this is the
    inputs' roundoff and not a fault of the ns = 2 update: the ns = 2
    update of the ns = 2 stepped state equals the ns = 1 update of that
    same state at the update bars, and the ns = 1 update and the dense
    update show the same gap between the two stepped states as the
    ns = 2 update does.  The gaps are printed."""
    import tempfile

    from ekf_vio_tpu_torch import interop
    from ekf_vio_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    tracked, stepped = _two_rank_step(mesh, dev)
    want = {"num_tracked": tracked.cpu().numpy(),
            **_np_filter("step", stepped),
            **_np_filter("update", _two_rank_update(stepped, mesh))}
    port = multihost.free_port()
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "stepped.npz"),
                 **interop.filter_state_to_numpy(stepped))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--two-ranks",
             str(r), str(port), workdir], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        errs = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            if p.returncode != 0:
                errs.append(f"rank {r} rc {p.returncode}: {err[-2000:]}")
        if errs:
            raise AssertionError("[two ranks] " + "\n".join(errs))
        got = dict(np.load(os.path.join(workdir, "two_ranks.npz")))

    def bar(k):
        if k.endswith("_Sigma"):
            return 5e-4 if k.startswith("step") else 5e-5
        return 2e-5

    def compare(tag, a, b, keys):
        worst = {}
        for k in keys:
            if k in ("num_tracked",) or k.endswith(("_active", "_age")):
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"[two ranks] {tag} {k} differs")
                continue
            worst[k] = float(np.abs(a[k] - b[k]).max())
            if not worst[k] <= bar(k):
                raise AssertionError(f"[two ranks] {tag} {k}: max diff "
                                     f"{worst[k]:.3e} over {bar(k)}")
        return worst

    fields = ("base_mu", "feat_mu", "active", "Sigma")
    worst = compare("ns=2 vs ns=1", got, want, ["num_tracked"] + [
        f"{t}_{k}" for t in ("step", "update") for k in fields])
    # the witness: the ns = 1 update (and the dense one) of the ns = 2
    # stepped state
    stepped_ns2 = interop.filter_state_from_numpy(
        {k[5:]: v for k, v in got.items() if k.startswith("step_")}, dev)
    own_ns1 = _np_filter("update", _two_rank_update(stepped_ns2, mesh))
    own_ns2 = {"update" + k[len("update_own"):]: v for k, v in got.items()
               if k.startswith("update_own_")}
    worst_own = compare("own step, ns=2 vs ns=1 update", own_ns2, own_ns1,
                        [f"update_{k}" for k in fields])
    dense1 = _two_rank_update(stepped, None)
    dense2 = _two_rank_update(stepped_ns2, None)

    def gap(a, b):
        return float(np.abs(a - b).max())

    gaps = {
        "step_base_mu": worst["step_base_mu"],
        "step_Sigma": worst["step_Sigma"],
        "ns2_update": gap(own_ns2["update_base_mu"], want["update_base_mu"]),
        "ns1_update": gap(own_ns1["update_base_mu"], want["update_base_mu"]),
        "dense_update": (dense2.base_mu - dense1.base_mu).abs().max().item(),
    }
    print(f"[two ranks] 2 gloo processes on {card}, mesh (1, 2), one "
          f"sharded step (num_tracked {int(got['num_tracked'])}) and one "
          f"sharded update, merged, against ns = 1 (NCCL): counts and "
          f"active equal, max diffs {json.dumps(worst)}; each side's "
          f"update of the ns = 2 stepped state, ns = 2 vs ns = 1: "
          f"{json.dumps(worst_own)}; base_mu gap between the updates of "
          f"the ns = 2 and the ns = 1 stepped states, by update: "
          f"{json.dumps(gaps)}; {time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "own": worst_own, "gaps": gaps}


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

    def elapsed(what: str) -> None:
        print(f"[elapsed] {what}: {time.perf_counter() - t_start:.1f} s")

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    phase_device(card)
    phase_build()

    frames, times = make_frames(seed=0, n_frames=120)
    frames_dev = torch.from_numpy(frames).to(dev)
    times_dev = torch.from_numpy(times).to(dev)
    small2 = camera.downscale_image(frames_dev[:2], 4).contiguous()
    half2 = camera.downscale_image(frames_dev[:2], 2).contiguous()
    seq = rendered.generate(num_frames=N_MONO)
    mono2 = torch.from_numpy(seq.frames[:2]).to(dev)
    inputs = _lk_inputs(small2, mono2, dev, half2)
    lk_err = phase_lk(inputs, frames_dev[:2])
    fast_err = phase_fast(small2, frames_dev[:2], mono2)
    klt_err = phase_klt(mono2)
    lane_err = phase_lanes(_lane_inputs(frames_dev, seq, dev), frames_dev,
                           seq)
    elapsed("kernel checks")
    lanes16, lane_times = _bench_lanes(frames_dev, 16, 120, dev)
    seqs4 = [rendered.generate(num_frames=60, seed=s) for s in range(4)]
    timings = phase_timings(inputs, _path_lane_inputs(lanes16, seqs4), card)
    elapsed("kernel timings")

    vision = phase_main_path(frames_dev, times_dev, dev, card)
    path_a = phase_mono_path(seq, 21, card)
    phase_mono_cpu_rollout(seq)
    path_b = phase_mono_path(seq, 17, card)
    path_c = phase_fwi_path(frames_dev, times_dev, card)
    path_d = phase_mono_path(seq, 21, card, sqrt=True)
    phase_mono_cpu_rollout(seq, sqrt=True)
    elapsed("paths vision, (a)-(d)")
    path_e = phase_batched_path(lanes16, lane_times, card)
    curve = phase_batch_curve(lanes16, card)
    chunks = phase_microbatch(lanes16, card)
    path_f = phase_batched_klt(seqs4, card)
    elapsed("batched paths (e), (f) and the B-curve")
    mesh = phase_dist_init(card)
    path_g = phase_sharded_fwi(frames_dev, times_dev, card, mesh,
                               path_c["fps"])
    path_h = phase_sharded_mono(seq, card, mesh)
    config5 = phase_config5(card, mesh)
    path_j = phase_mesh_batching(lanes16, card, mesh)
    two_ranks = phase_two_ranks(card, mesh)
    elapsed("distributed layer (g)-(j)")
    phase_simulator(card)
    phase_cli_io(card)
    elapsed("simulator, CLI and I/O")
    phase_profile(frames_dev, times_dev, vision["eager_step_ms"], _bench_cfg(),
                  "vision step")
    phase_mono_profile(seq, path_a["eager_step_ms"])
    phase_profile(frames_dev, times_dev, path_c["eager_step_ms"], _fwi_cfg(),
                  "512-slot vision step")
    phase_mono_profile(seq, path_d["eager_step_ms"], sqrt=True)
    phase_batched_profile(lanes16, path_e["eager_step_ms"])
    phase_sharded_profile(frames_dev, times_dev, path_g["eager_step_ms"],
                          mesh)
    elapsed("eager per-layer profiles")
    phase_replay_profiles(frames_dev, times_dev, seq, seqs4, lanes16, mesh)
    elapsed("replayed profiles")

    runs = {"vision": vision["launches"], "path_a": path_a["launches"],
            "path_b": path_b["launches"], "path_c": path_c["launches"],
            "path_d": path_d["launches"], "path_e": path_e["launches"],
            "path_f": path_f["launches"], "path_g": path_g["launches"],
            "path_g_two_view": path_g["launches_backtrack"],
            "path_h": path_h["launches"], "path_j": path_j["launches"]}
    for name in KERNELS:
        if not any(r.get(name, 0) for r in runs.values()):
            raise AssertionError(f"{name} was never launched on a path")
    total = {name: sum(r.get(name, 0) for r in runs.values())
             for name in KERNELS}
    kernels = [
        _kernel_entry("lk_level", lk_cuda, "cuda", total["lk_level"],
                      max(lk_err, lane_err["lk_level"]), timings["lk_level"]),
        _kernel_entry("fast9", fast_cuda, "cuda", total["fast9"],
                      max(fast_err, lane_err["fast9"]), timings["fast9"]),
        _kernel_entry("klt_level", klt_cuda, "cuda", total["klt_level"],
                      max(klt_err, lane_err["klt_level"]),
                      timings["klt_level"]),
    ]
    for k in kernels:
        k["launches_by_path"] = {p: r.get(k["name"], 0)
                                 for p, r in runs.items()}
    print("[curve] " + json.dumps({"batch_curve": curve,
                                   "one_batch_vs_chunks": chunks}))
    print("[distributed] " + json.dumps({
        "path_g_fps": path_g["fps"], "path_c_fps": path_c["fps"],
        "path_h_fps": path_h["fps"], "path_h_ate_m": path_h["ate"],
        "config5_ms": config5["ms"], "config5_memory": config5["memory"],
        "mesh_probe_ms": path_j["probe_ms"],
        "mesh_step_ms": path_j["step_ms"], "two_ranks": two_ranks}))
    print("[graphs] " + json.dumps(GRAPHS))
    torch.distributed.destroy_process_group()
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--two-ranks"]:  # a rank of phase_two_ranks
        _two_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
