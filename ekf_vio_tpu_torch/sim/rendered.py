"""Rendered end-to-end VIO sequence: images + IMU + ground truth, numpy.

A copy of the numpy part of ``ekf_vio_tpu/sim/rendered.py``: a textured
plane (or two) under a smooth 6-DoF camera trajectory, rendered by
inverse warping with bilinear sampling, and the matching IMU stream
generated analytically with noise and constant biases.  Same arguments,
same seed, same sequence.  ``evaluate_ate`` runs the port's engine on
such a sequence.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class RenderedSequence(NamedTuple):
    frames: np.ndarray     # [T, H, W] f32 images
    times: np.ndarray      # [T]
    K: np.ndarray          # [3, 3]
    gt_pos: np.ndarray     # [T, 3] camera position (world)
    gt_quat: np.ndarray    # [T, 4] camera orientation (w, x, y, z)
    imu_dt: np.ndarray     # [T-1, S]
    imu_gyro: np.ndarray   # [T-1, S, 3] body rate (rad/s)
    imu_accel: np.ndarray  # [T-1, S, 3] specific force (m/s²)
    gravity_w: np.ndarray  # [3]
    gyro_bias: np.ndarray = None   # [3] true constant gyro bias
    accel_bias: np.ndarray = None  # [3] true constant accel bias


def _rot_yaw_pitch(yaw, pitch):
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rp = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return Ry @ Rp


class _Trajectory:
    """Smooth analytic 6-DoF trajectory with exact derivatives.

    Starts at REST (p=v=0, ω=0 at t=0) via 1−cos profiles — the standard
    VIO protocol (EuRoC sequences begin stationary); a mid-motion cold
    start leaves the initial velocity unobservable to the filter."""

    def __init__(self, amp=(0.13, 0.06, 0.04), freq=(0.45, 0.3, 0.2),
                 yaw_amp=0.04, yaw_freq=0.35, pitch_amp=0.02, pitch_freq=0.25):
        self.amp = np.asarray(amp)
        self.w = 2 * np.pi * np.asarray(freq)
        self.ya, self.yw = yaw_amp, 2 * np.pi * yaw_freq
        self.pa, self.pw = pitch_amp, 2 * np.pi * pitch_freq

    def pos(self, t):
        return self.amp * (1.0 - np.cos(self.w * t))

    def vel(self, t):
        return self.amp * self.w * np.sin(self.w * t)

    def acc(self, t):
        return self.amp * self.w**2 * np.cos(self.w * t)

    def R(self, t):  # world <- body
        return _rot_yaw_pitch(self.ya * (1.0 - np.cos(self.yw * t)),
                              self.pa * (1.0 - np.cos(self.pw * t)))

    def omega_body(self, t, eps=1e-5):
        """Body rate from the exact R via central difference of R (the
        rotation is a composition of two sinusoidal elementary rotations;
        a numerical vee at 1e-5 s is exact to ~1e-9)."""
        R0 = self.R(t - eps)
        R1 = self.R(t + eps)
        W = self.R(t).T @ ((R1 - R0) / (2 * eps))
        return np.array([W[2, 1] - W[1, 2], W[0, 2] - W[2, 0],
                         W[1, 0] - W[0, 1]]) / 2.0


def _make_texture(size=2048, seed=0):
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    smooth = ndi.gaussian_filter(rng.uniform(0, 255, (size, size)), 2.0)
    blobs = (ndi.gaussian_filter(rng.uniform(0, 1, (size, size)), 8.0) > 0.5)
    tex = 0.45 * smooth + 140.0 * blobs + 25.0
    return (255 * (tex - tex.min()) / np.ptp(tex)).astype(np.float32)


def _undistort_normalized(xd, yd, dist, iters=30):
    """Invert the radtan model by fixed point: find (x, y) with
    distort(x, y) = (xd, yd).  dist = [k1, k2, p1, p2, k3]."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def _render(tex, K, R, p, plane_depth, tex_scale, h, w, dist=None,
            supersample: int = 1):
    """Inverse-warp the plane texture into the camera: for each pixel,
    intersect the ray with the plane z = plane_depth (world) and sample
    the texture bilinearly.  With ``dist`` (radtan [k1,k2,p1,p2,k3]) the
    rendered image is the DISTORTED camera image: each pixel's normalized
    coords are radtan-undistorted before ray casting — exactly the model
    cv2's undistort inverts (EKFVIO's rectify nodelet role).

    ``supersample`` > 1 renders at s x the resolution and box-averages
    down — area-filtered anti-aliasing.  Point-sampled bilinear lookup
    ALIASES under minification (steep viewing angles foreshorten the
    plane below the texture's Nyquist rate); on the aggressive scene at
    32 deg yaw the aliasing pattern shifts frame-to-frame and measured
    as a ~1 px systematic tracker error that the filter integrated into
    a spurious 0.4 rad/s gyro-bias estimate.  A real camera's pixel
    aperture area-integrates, so the supersampled image is the
    physically faithful one."""
    if supersample > 1:
        s = supersample
        Ks = K.copy() * 1.0
        Ks[0, 0] *= s
        Ks[1, 1] *= s
        Ks[0, 2] = K[0, 2] * s + (s - 1) / 2.0
        Ks[1, 2] = K[1, 2] * s + (s - 1) / 2.0
        big = _render(tex, Ks, R, p, plane_depth, tex_scale, h * s, w * s,
                      dist=dist)
        return big.reshape(h, s, w, s).mean(axis=(1, 3)).astype(np.float32)
    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], 0)  # [3, HW]
    if dist is not None:
        nd = Kinv @ rays
        x_u, y_u = _undistort_normalized(nd[0], nd[1], dist)
        rays = np.stack([x_u * K[0, 0] + K[0, 2],
                         y_u * K[1, 1] + K[1, 2], np.ones(h * w)], 0)
    d_w = R @ (Kinv @ rays)                    # ray directions in world
    if np.ndim(plane_depth) == 0:
        lam = (plane_depth - p[2]) / d_w[2]    # intersection with plane
    else:
        # depth-diverse scene: two fronto-parallel planes split at world
        # x = 0 (near plane on the left) — exercises simultaneous
        # estimation of very different feature depths (the single-plane
        # scene lets one shared depth explain everything)
        za, zb = plane_depth
        lam_a = (za - p[2]) / d_w[2]
        xa = p[0] + lam_a * d_w[0]
        lam_b = (zb - p[2]) / d_w[2]
        lam = np.where(xa < 0.0, lam_a, lam_b)
    pts = p[:, None] + lam * d_w               # [3, HW] world points
    # texture coords: plane x/y mapped at tex_scale px per meter, centered
    tx = pts[0] * tex_scale + tex.shape[1] / 2
    ty = pts[1] * tex_scale + tex.shape[0] / 2
    x0 = np.clip(np.floor(tx).astype(int), 0, tex.shape[1] - 2)
    y0 = np.clip(np.floor(ty).astype(int), 0, tex.shape[0] - 2)
    fx = np.clip(tx - x0, 0, 1)
    fy = np.clip(ty - y0, 0, 1)
    v = (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x0 + 1] * fx * (1 - fy)
         + tex[y0 + 1, x0] * (1 - fx) * fy + tex[y0 + 1, x0 + 1] * fx * fy)
    return v.reshape(h, w).astype(np.float32)


def generate(num_frames=120, fps=20.0, imu_rate=200.0, w=320, h=240,
             f=260.0, plane_depth=2.0, seed=0, gyro_noise=1.7e-4,
             accel_noise=2.0e-3, gyro_bias=(0.002, -0.001, 0.003),
             accel_bias=(0.02, -0.015, 0.01),
             distortion=None, exposure_drift=0.0,
             trajectory: "_Trajectory | None" = None,
             supersample: int = 1) -> RenderedSequence:
    """Render a sequence with consistent images, IMU and ground truth.

    Gravity points along +y of the initial camera frame (camera y-down,
    roughly level) so the accelerometer carries the usual ~1 g signal.

    ``distortion`` (radtan [k1, k2, p1, p2(, k3)]) renders DISTORTED
    imagery — the EuRoC-like real-data quirk; push the frames through
    io.euroc.undistort_and_scale before the engine.  ``exposure_drift``
    applies a slow multiplicative gain 1 + a·sin plus an additive offset
    drift (auto-exposure / vignetting stand-in); the LK front-end must
    absorb it (VERDICT r3 #9)."""
    rng = np.random.RandomState(seed + 7)
    traj = trajectory if trajectory is not None else _Trajectory()
    tex = _make_texture(seed=seed)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    g_w = np.array([0.0, 9.81, 0.0])

    times = np.arange(num_frames) / fps
    frames = np.stack([
        _render(tex, K, traj.R(t), traj.pos(t), plane_depth,
                tex_scale=640.0, h=h, w=w, dist=distortion,
                supersample=supersample)
        for t in times
    ])
    if exposure_drift:
        gain = (1.0 + exposure_drift * np.sin(0.9 * times)
                )[:, None, None].astype(np.float32)
        offs = (12.0 * exposure_drift * np.sin(0.37 * times + 1.0)
                )[:, None, None].astype(np.float32)
        frames = np.clip(frames * gain + offs, 0.0, 255.0)
    gt_pos = np.stack([traj.pos(t) for t in times])
    gt_quat = np.stack([_mat_to_quat(traj.R(t)) for t in times])

    # IMU stream between frames, with noise and constant biases.  Samples
    # exactly TILE each camera interval: full 1/imu_rate steps plus one
    # partial remainder step when fps does not divide imu_rate (trailing
    # zero-dt rows are padding).  The old full-steps-only batching
    # overran non-divisible intervals (30 fps x 200 Hz -> 7x5 ms = 35 ms
    # of IMU per 33.3 ms frame), a 5% time-scale error the filter can
    # only explain as a huge phantom gyro bias — the aggressive-scene
    # attitude runaway root cause.
    dt_s = 1.0 / imu_rate
    ratio = imu_rate / fps
    # capacity: full steps (+1 remainder slot only when fps does not
    # divide imu_rate — an always-empty padding row costs ~9% of the
    # compound-interval work for nothing)
    spf = int(np.ceil(ratio)) + (0 if abs(ratio - round(ratio)) < 1e-9
                                 else 1)
    imu_dt = np.zeros((num_frames - 1, spf), np.float32)
    gyro = np.zeros((num_frames - 1, spf, 3), np.float32)
    accel = np.zeros((num_frames - 1, spf, 3), np.float32)
    bg = np.asarray(gyro_bias)
    ba = np.asarray(accel_bias)
    for i in range(num_frames - 1):
        t = times[i]
        t_end = times[i + 1]
        s = 0
        while t_end - t > 1e-9 and s < spf:
            d = min(dt_s, t_end - t)
            tm = t + 0.5 * d
            R = traj.R(tm)
            imu_dt[i, s] = d
            gyro[i, s] = (traj.omega_body(tm) + bg
                          + gyro_noise * np.sqrt(1.0 / d) * rng.randn(3))
            accel[i, s] = (R.T @ (traj.acc(tm) - (-g_w)) + ba
                           + accel_noise * np.sqrt(1.0 / d) * rng.randn(3))
            t += d
            s += 1
    # specific force f = a − g (accelerometer measures a − g; at rest,
    # a=0 → f = −g: pointing opposite gravity)
    return RenderedSequence(frames=frames, times=times.astype(np.float32),
                            K=K, gt_pos=gt_pos.astype(np.float32),
                            gt_quat=gt_quat.astype(np.float32),
                            imu_dt=imu_dt, imu_gyro=gyro, imu_accel=accel,
                            gravity_w=(-g_w).astype(np.float32),
                            gyro_bias=bg.astype(np.float32),
                            accel_bias=ba.astype(np.float32))


def generate_aggressive(num_frames=360, fps=30.0, seed=0,
                        exposure_drift=0.08, **kw) -> RenderedSequence:
    """Aggressive-motion benchmark scene (VERDICT r4 #5): the handheld-rig
    regime the reference deploys at 90 fps (launch/sensorRig1.launch:20).

    * yaw sweep 2x0.28 rad = 32 deg with peak body rate ~1.5 rad/s
      (yaw_amp * yaw_omega = 0.28 * 2pi*0.85), plus a fast pitch nod —
      features cross the full FOV (half-FOV 31.6 deg at f=260/320 px) and
      are continuously replaced;
    * two-plane depth-diverse scene (1.2 m / 3.0 m);
    * ~3x the nominal translation amplitude, so accelerometer excitation
      is strong;
    * exposure drift on (the auto-exposure stand-in the LK front-end
      must absorb).

    30 fps keeps per-frame rotation (~2.9 deg -> ~13 px at center) inside
    the tracker's pyramid search envelope, mirroring the reference rig's
    high-rate camera; the IMU stream still carries the full 1.5 rad/s
    rates between frames.
    """
    traj = _Trajectory(amp=(0.30, 0.18, 0.12), freq=(0.55, 0.4, 0.3),
                       yaw_amp=0.28, yaw_freq=0.85,
                       pitch_amp=0.10, pitch_freq=0.6)
    kw.setdefault("plane_depth", (1.2, 3.0))
    # area-filtered rendering: at 32 deg foreshortening the point-sampled
    # texture aliases below its Nyquist rate (see _render)
    kw.setdefault("supersample", 2)
    return generate(num_frames=num_frames, fps=fps, seed=seed,
                    exposure_drift=exposure_drift, trajectory=traj, **kw)


def _mat_to_quat(R):
    """Rotation matrix -> quaternion [w, x, y, z]."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    if w < 1e-8:  # not reachable for the small-angle trajectories here
        raise ValueError("degenerate quaternion")
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def evaluate_ate(seq: RenderedSequence, cfg=None, use_imu=True,
                 device="cuda"):
    """Run the port's engine on the rendered sequence on ``device``;
    returns (ate_rmse_m, outputs) with the Umeyama-aligned (scaled) ATE
    (``rendered.evaluate_ate`` of the JAX package)."""
    import torch

    from ekf_vio_tpu_torch import engine
    from ekf_vio_tpu_torch.config import VIOConfig
    from ekf_vio_tpu_torch.frontend.camera import Camera
    from ekf_vio_tpu_torch.io.trajectory import ate_rmse

    cfg = cfg or VIOConfig(max_features=128, min_new_feature_dist=10.0,
                           fast_threshold=25, triangulate_new_features=True)
    h, w = seq.frames.shape[1:]
    cam = Camera.from_K(seq.K, w, h)
    if use_imu:
        _, outs = engine.run_sequence_imu(
            seq.frames, seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
            seq.gravity_w, cfg, cam, init_frames=cfg.vi_init_frames,
            device=device)
    else:
        _, outs = engine.run_sequence(seq.frames, seq.times, cfg, cam,
                                      device=device)
    outs = type(outs)(*(torch.as_tensor(x).cpu() for x in outs))
    start = max(cfg.vi_init_frames, 1) if use_imu else 1
    p_est = outs.base_mu[:, 0:3].numpy()
    return ate_rmse(seq.times[start:], p_est, seq.times, seq.gt_pos), outs
