"""Command-line entry point of the port: run | sim | info.

Port of ``ekf_vio_tpu/cli.py`` (the analog of the reference's node
binary, src/ekfvio_node.cpp:14-21) with the same subcommands, flags and
summary JSON, plus ``--device`` (default ``cuda``; ``--device cpu`` runs
the plain PyTorch versions of the kernels on the CPU):

    python -m ekf_vio_tpu_torch run --synthetic 120 --out traj.tum
    python -m ekf_vio_tpu_torch run --rendered 40 \\
        --config configs/mono_inertial.yaml --insight-dir /tmp/insight
    python -m ekf_vio_tpu_torch run --euroc MH_01_easy --imu
    python -m ekf_vio_tpu_torch sim
    python -m ekf_vio_tpu_torch info

``--checkpoint`` writes the final filter state with ``io/checkpoint.py``
(``save_npz``: the JAX package's npz layout, which its ``load_npz``
reads), ``--profile`` a ``torch.profiler`` Chrome trace with
``utils/profiling.py``, and ``--insight-dir`` runs the compiled step
(``scan.graphed(engine.step)``, one CUDA graph replayed a frame on the
card) frame by frame and writes annotated PNGs without OpenCV.  Without
it, the rollout is ``engine.run_sequence[_imu]``'s ``scan``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np


def _make_synthetic(n_frames: int, w=640, h=480, shift=2.0, seed=0):
    """Textured plane under lateral camera motion (no dataset needed)."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    big = rng.uniform(0, 255, (h + 64, w + 64 + int(shift * n_frames) + 8))
    big = ndi.gaussian_filter(big, 2.0)
    big = (big - big.min()) / (np.ptp(big) + 1e-9) * 255.0
    big = big.astype(np.float32)
    frames = np.stack(
        [big[32: 32 + h,
             32 + int(round(shift * i)): 32 + int(round(shift * i)) + w]
         for i in range(n_frames)])
    times = np.arange(n_frames, dtype=np.float32) / 20.0
    return frames, times


def _load_config(path: str | None):
    from ekf_vio_tpu_torch.config import VIOConfig

    return VIOConfig.from_yaml(path) if path else VIOConfig()


def _write_tum(path: str, times, base_mu):
    """TUM format: t x y z qx qy qz qw (state quat is [w,x,y,z])."""
    p = np.asarray(base_mu)[:, 0:3]
    q = np.asarray(base_mu)[:, 3:7]
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(
                f"{float(times[i]):.6f} {p[i,0]:.6f} {p[i,1]:.6f} "
                f"{p[i,2]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} "
                f"{q[i,0]:.6f}\n")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_run(args) -> int:
    import torch

    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend.camera import Camera
    from ekf_vio_tpu_torch.utils.profiling import FrameTimer, trace

    dev = engine.resolve_device(args.device)
    cfg = _load_config(args.config)
    s = cfg.inverse_image_scale
    summary = {"config": args.config or "defaults"}
    # mono-inertial mode comes from the profile (cfg.use_imu); --imu
    # forces it on, --no-imu forces vision-only
    want_imu = (cfg.use_imu or args.imu) and not args.no_imu

    imu = gt = gravity = None
    if args.euroc:
        from ekf_vio_tpu_torch.io import euroc

        mav0 = (args.euroc if os.path.isdir(args.euroc)
                else euroc.find_euroc(args.euroc))
        if mav0 is None:
            print(f"error: EuRoC sequence '{args.euroc}' not found under "
                  f"{euroc.SEARCH_PATHS}", file=sys.stderr)
            return 2
        seq = euroc.load_sequence(mav0, name=args.euroc)
        count = args.frames or len(seq.image_paths)
        frames, K = euroc.load_images(seq, count=count, inverse_scale=s)
        times = seq.image_times[:count]
        if want_imu:
            # batch width from the profile's nominal IMU rate and the
            # sequence's frame cadence (zero-dt rows are padding)
            frame_dt = float(np.median(np.diff(times))) if count > 1 else 0.05
            max_per = max(int(np.ceil(cfg.imu_rate_hz * frame_dt)) + 2, 4)
            imu = euroc.imu_between_frames(seq, count=count,
                                           max_per_frame=max_per)
        gt = (seq.gt_times, seq.gt_pos)
        summary["sequence"] = args.euroc
    elif args.rendered:
        from ekf_vio_tpu_torch.sim import rendered

        seq = rendered.generate(num_frames=args.rendered)
        frames, times, K = seq.frames, seq.times, seq.K
        if want_imu:
            imu = (seq.imu_dt, seq.imu_gyro, seq.imu_accel)
            gravity = seq.gravity_w
        gt = (seq.times, seq.gt_pos)
        summary["sequence"] = f"rendered[{args.rendered}]"
    else:
        from ekf_vio_tpu_torch.io.euroc import resize_linear

        n = args.synthetic or 120
        frames_full, times = _make_synthetic(n)
        frames = np.stack([resize_linear(f, (f.shape[1] // s,
                                             f.shape[0] // s))
                           for f in frames_full])
        K = np.array(
            [[458.0 / s, 0, frames.shape[2] / 2],
             [0, 458.0 / s, frames.shape[1] / 2], [0, 0, 1]], np.float32)
        summary["sequence"] = f"synthetic[{n}]"

    h, w = frames.shape[1:]
    cam = Camera.from_K(K, w, h)
    imgs = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(dev)
    ts = torch.from_numpy(np.ascontiguousarray(times, np.float32)).to(dev)
    if imu is not None:
        imu = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                     ).to(dev) for a in imu)
        if gravity is None:
            from ekf_vio_tpu_torch.core.imu import estimate_gravity_world

            gravity = estimate_gravity_world(imu[2][0])
        gravity = torch.as_tensor(gravity, dtype=torch.float32).to(dev)

    ctx = trace(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
        if args.insight_dir:
            estate, outs, fps = _run_streaming(
                imgs, ts, cfg, cam, imu, args.insight_dir, args.log_every,
                gravity_w=gravity)
        else:
            timer = FrameTimer()
            with timer.frame():
                if imu is not None:
                    estate, outs = engine.run_sequence_imu(
                        imgs, ts, *imu, gravity, cfg, cam,
                        init_frames=cfg.vi_init_frames, device=dev)
                else:
                    estate, outs = engine.run_sequence(imgs, ts, cfg, cam,
                                                       device=dev)
                _sync(dev)
            fps = (len(times) - 1) / timer.total_s

    start = max(cfg.vi_init_frames, 1) if imu is not None else 1
    base = outs.base_mu.cpu().numpy()
    summary.update(
        frames=int(len(times)),
        fps=round(float(fps), 2),
        mode="imu" if imu is not None else "vision-only",
        final_position=[round(float(v), 4) for v in base[-1, :3]],
        mean_tracked=round(float(outs.num_tracked.float().mean()), 1),
        frames_tracking_lost=int(outs.tracking_lost.sum()),
    )
    if gt is not None:
        from ekf_vio_tpu_torch.io.trajectory import ate_rmse

        try:
            summary["ate_rmse_m"] = round(
                ate_rmse(times[start:], base[:, :3], gt[0], gt[1]), 4)
        except ValueError as e:
            summary["ate_rmse_m"] = f"unavailable ({e})"
    if args.out:
        _write_tum(args.out, times[start:], base)
        summary["trajectory"] = args.out
    if args.checkpoint:
        from ekf_vio_tpu_torch.io.checkpoint import save_npz

        save_npz(args.checkpoint, estate.filt)
        summary["checkpoint"] = args.checkpoint
    print(json.dumps(summary, indent=2))
    return 0


def _run_streaming(imgs, ts, cfg, cam, imu, insight_dir, log_every,
                   gravity_w=None):
    """Per-frame host loop that renders the filter state each frame
    (EKFVIO.cpp:379-442), with the per-feature covariance error ellipses
    (EKFVIO.cpp:316-377)."""
    import torch

    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.frontend import camera as cam_mod
    from ekf_vio_tpu_torch import scan
    from ekf_vio_tpu_torch.utils.profiling import FrameTimer
    from ekf_vio_tpu_torch.viz import insight

    os.makedirs(insight_dir, exist_ok=True)
    dev = imgs.device
    if imu is not None and gravity_w is None:
        gravity_w = torch.tensor([0.0, 0.0, -cfg.gravity], device=dev)
    start = 1
    if imu is not None and 1 < cfg.vi_init_frames < imgs.shape[0]:
        # the closed-form visual-inertial alignment of run_sequence_imu
        estate = engine.initialize_imu(imgs, ts, *imu, gravity_w, cfg, cam,
                                       cfg.vi_init_frames, device=dev)
        start = cfg.vi_init_frames
    else:
        estate = engine.initialize(imgs[0], ts[0], cfg, cam, device=dev)
    # the compiled step (jax.jit(engine.step) in the JAX CLI): on the
    # card one captured graph of it, replayed once a frame; the drawing
    # below reads its copied outputs back, outside the replay
    if imu is not None:
        body = engine.imu_step_body(cfg, cam, gravity_w)
        frame_in = engine.imu_frames(imgs, ts, *imu, start=1)
        step = scan.graphed(lambda es, *x: body(es, x))
    else:
        step = scan.graphed(
            lambda es, img, t: engine.step(es, img, t, cfg, cam))
        frame_in = (imgs[1:], ts[1:])
    timer = FrameTimer(log_every=log_every)
    outs = []
    for i in range(start, imgs.shape[0]):
        with timer.frame():
            estate, out = step(estate, *(x[i - 1] for x in frame_in))
            _sync(dev)
        outs.append(out)

        filt = estate.filt
        feat_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
        # the factor form stores L; Σ = L Lᵀ
        sigma = filt.Sigma @ filt.Sigma.T if cfg.square_root_form \
            else filt.Sigma
        cov_px = insight.feature_pixel_covariances(sigma, cam.fx, cam.fy,
                                                   cfg.max_features)
        frame = insight.render_insight(imgs[i], feat_px, filt.active,
                                       feat_cov_px=cov_px)
        insight.write_png(os.path.join(insight_dir, f"{i:06d}.png"), frame)
    return estate, engine.StepOutputs(
        *(torch.stack(f) for f in zip(*outs))), timer.fps


def cmd_sim(args) -> int:
    """Closed-loop synthetic convergence report (the reference's
    ekfvio_analyze_ekf, test/analyzeEKFSimulation.cpp:219-247)."""
    from ekf_vio_tpu_torch.sim.simulator import run_reference_scenarios

    results = run_reference_scenarios(seed=args.seed, device=args.device)
    report = []
    for k, (scn, _, _, telem) in enumerate(results):
        min_diag, asym, pos_err, feat_err = (t.cpu().numpy() for t in telem)
        report.append({
            "scenario": k + 1,
            "features": int(scn.feature_count),
            "steps": len(pos_err),
            "final_pos_err_m": round(float(pos_err[-1]), 6),
            "final_feat_err": round(float(feat_err[-1]), 6),
            "sigma_min_diag": round(float(min_diag.min()), 8),
            "sigma_max_asym": round(float(asym.max()), 8),
        })
    print(json.dumps(report, indent=2))
    return 0


def cmd_info(args) -> int:
    import dataclasses

    import torch

    cfg = _load_config(args.config)
    devices = ["cpu"] + [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                         for i in range(torch.cuda.device_count())]
    print(json.dumps({
        "devices": devices,
        "default_backend": "cuda" if torch.cuda.is_available() else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "config": dataclasses.asdict(cfg),
        "state_dim": cfg.state_dim,
    }, indent=2, default=str))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ekf_vio_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run VIO on a sequence")
    src = r.add_mutually_exclusive_group()
    src.add_argument("--euroc", help="EuRoC sequence name or mav0 path")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="run on N synthetic frames")
    src.add_argument("--rendered", type=int, metavar="N",
                     help="run on N rendered-scene frames (IMU + GT, "
                          "sim/rendered.py)")
    r.add_argument("--config", help="YAML profile (configs/*.yaml)")
    r.add_argument("--imu", action="store_true",
                   help="force mono-inertial mode (overrides the profile)")
    r.add_argument("--no-imu", action="store_true",
                   help="force vision-only mode (overrides the profile)")
    r.add_argument("--frames", type=int, help="limit frame count")
    r.add_argument("--out", help="write TUM trajectory here")
    r.add_argument("--insight-dir",
                   help="dump annotated insight PNGs (streaming)")
    r.add_argument("--checkpoint",
                   help="save the final filter state (npz, the JAX "
                        "package's layout)")
    r.add_argument("--profile",
                   help="write a torch.profiler Chrome trace to this dir")
    r.add_argument("--log-every", type=int, default=30,
                   help="streaming fps log period")
    r.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("sim", help="closed-loop synthetic scenario report")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.set_defaults(fn=cmd_sim)

    i = sub.add_parser("info", help="devices + resolved config")
    i.add_argument("--config", help="YAML profile")
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
