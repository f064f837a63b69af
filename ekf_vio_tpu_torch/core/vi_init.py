"""Closed-form visual-inertial initialization (alignment).

Port of ``ekf_vio_tpu/core/vi_init.py``.  Over the first K frames, given
gravity and the IMU stream:

* rotations R_i and the v0-free translations tc_i come from the
  closed-form 29-dim mean chain (``imu._mean_chain``) with v0 = 0; the
  camera action frame 0 → i is p_i = R_i p_0 + (tc_i − τ_i R_i v0);
* each feature j tracked from frame 0 to frame i gives the constraint
  [h_ji]× (R_i h_j0 z_j + t_i(v0)) = 0, linear in (z_j, v0);
* per-feature depths are eliminated by a Schur complement, leaving one
  3x3 solve for v0, then back-substitution for every z_j;
* ``align_with_gyro_bias`` alternates that solve with Gauss-Newton steps
  on the IMU biases, its Jacobian from ``torch.func.jacfwd`` through the
  integration chain (host-side, once per run).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import lie


class AlignmentResult(NamedTuple):
    v0_world: torch.Tensor   # [3] initial velocity (world = frame-0 cam)
    depths0: torch.Tensor    # [N] frame-0 depths of the tracked features
    depth_ok: torch.Tensor   # [N] solved with enough parallax/conditioning
    R_i: torch.Tensor        # [K, 3, 3] frame-0 -> frame-i camera action
    tc_i: torch.Tensor       # [K, 3] translation with v0 = 0
    tau_i: torch.Tensor      # [K] elapsed time per frame


def _homogeneous(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, torch.ones_like(h[..., :1])], -1)


def integrate_motion(times, imu_dt, imu_gyro, imu_accel, gravity_w, v0=None,
                     gyro_bias=None, accel_bias=None):
    """Gyro/accel integration across the first K frames (K = len(times);
    imu_* hold K-1 intervals of S samples).  Returns (R_i [K,3,3],
    tc_i [K,3], tau_i [K], base22) with base22 the integrated base state
    at frame K-1 (world frame = frame 0)."""
    k = times.shape[0]
    s_per = imu_dt.shape[1]
    dtype, dev = imu_accel.dtype, imu_accel.device
    zeros3 = torch.zeros(3, dtype=dtype, device=dev)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    v0 = zeros3 if v0 is None else v0
    bg = zeros3 if gyro_bias is None else gyro_bias
    ba = zeros3 if accel_bias is None else accel_bias
    x0 = torch.cat([zeros3, ident, v0, zeros3, zeros3, ba, bg, ident,
                    zeros3])
    batch = imu_mod.ImuSample(dt=imu_dt[:k - 1].reshape(-1),
                              gyro=imu_gyro[:k - 1].reshape(-1, 3),
                              accel=imu_accel[:k - 1].reshape(-1, 3))
    x_fin, xs_pre = imu_mod._mean_chain(x0[None], batch, gravity_w)
    x_fin, xs_pre = x_fin[0], xs_pre[0]
    # the state after i·S samples is the PRE-state of sample i·S (i < K-1),
    # and x_fin for the last frame
    ends = torch.cat([xs_pre[s_per::s_per], x_fin[None]])
    quats = torch.cat([ident[None], ends[:, 22:26]])
    Rs = lie.quat_to_matrix(quats)
    tcs = torch.cat([zeros3[None], ends[:, 26:29]])
    tau = times - times[0]
    return Rs, tcs, tau, x_fin[0:22]


def align(h_obs, valid, R_i, tc_i, tau_i, min_parallax: float = 1e-4):
    """Solve the joint linear system for (v0, depths).

    h_obs: [K, N, 2] metric tracks (frame 0 = initial positions);
    valid: [K, N] chained track validity."""
    k, n = valid.shape
    h0 = _homogeneous(h_obs[0])                               # [N, 3]
    hi = _homogeneous(h_obs[1:])                              # [K-1, N, 3]
    Rh0 = torch.einsum("kab,nb->kna", R_i[1:], h0)
    A = lie.cross(hi, Rh0)                                    # [h_i]× R h0
    C = -lie.cross(hi, tc_i[1:, None, :])                     # [h_i]× tc
    # M v0 = −τ_i [h_i]× (R_i v0)
    M = -tau_i[1:, None, None, None] * torch.einsum(
        "knab,kbc->knac", lie.skew(hi), R_i[1:])
    OK = (valid[1:] & valid[0][None])[..., None].to(A.dtype)  # [K-1, N, 1]
    A = A * OK
    M = M * OK[..., None]
    C = C * OK

    # Schur elimination of each z_j
    ata = torch.sum(A * A, dim=(0, 2))                        # [N]
    cond_ok = ata > min_parallax
    ata_safe = torch.where(cond_ok, ata, 1.0)
    atM = torch.einsum("kna,knab->nb", A, M)                  # [N, 3]
    atc = torch.einsum("kna,kna->n", A, C)                    # [N]
    # zero-parallax features are excluded entirely (their raw M-blocks
    # would bias v0 toward zero)
    MtM = torch.einsum("knab,knac->nbc", M, M)
    Mtc = torch.einsum("knab,kna->nb", M, C)
    w = cond_ok.to(A.dtype)
    proj = w / ata_safe
    H = torch.sum(w[:, None, None] * MtM
                  - proj[:, None, None] * atM[:, :, None] * atM[:, None, :],
                  dim=0)
    b = torch.sum(w[:, None] * Mtc - proj[:, None] * atM * atc[:, None],
                  dim=0)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    v0 = torch.linalg.solve(H + 1e-8 * eye, b)
    z = (atc - atM @ v0) / ata_safe
    ok = cond_ok & (z > 0.01) & (z < 100.0)
    return AlignmentResult(v0_world=v0, depths0=z, depth_ok=ok, R_i=R_i,
                           tc_i=tc_i, tau_i=tau_i)


def align_with_gyro_bias(times, imu_dt, imu_gyro, imu_accel, gravity_w,
                         h_obs, valid, rounds: int = 2,
                         estimate_accel_bias: bool = True):
    """Joint alignment with IMU-bias refinement: ``rounds`` times,
    integrate with the current biases, solve (v0, depths) with ``align``,
    then take one damped, clipped Gauss-Newton step on b = [bg, ba] over
    the epipolar residuals.  Returns (AlignmentResult, bg, ba)."""
    dtype, dev = imu_accel.dtype, imu_accel.device
    b = torch.zeros(6, dtype=dtype, device=dev)
    k, n = valid.shape
    h0 = _homogeneous(h_obs[0])
    hi = _homogeneous(h_obs[1:])

    def residuals(b_, v0, z, depth_ok):
        R_i, tc_i, tau, _ = integrate_motion(
            times, imu_dt, imu_gyro, imu_accel, gravity_w,
            gyro_bias=b_[0:3], accel_bias=b_[3:6])
        t_i = tc_i[1:] - tau[1:, None] * (R_i[1:] @ v0)           # [K-1, 3]
        p = (torch.einsum("kab,nb->kna", R_i[1:], h0) * z[None, :, None]
             + t_i[:, None, :])
        r = lie.cross(hi, p)
        w = (valid[1:] & valid[0][None] & depth_ok[None]).to(r.dtype)
        return (r * w[..., None]).reshape(-1)

    nb = 6 if estimate_accel_bias else 3
    damp = torch.diag(torch.tensor([1e-8] * 3 + [1e-4] * 3, dtype=dtype,
                                   device=dev)[:nb])
    for _ in range(rounds):
        R_i, tc_i, tau, _ = integrate_motion(
            times, imu_dt, imu_gyro, imu_accel, gravity_w,
            gyro_bias=b[0:3], accel_bias=b[3:6])
        res = align(h_obs, valid, R_i, tc_i, tau)
        z = torch.where(res.depth_ok, res.depths0, 0.0)
        r = residuals(b, res.v0_world, z, res.depth_ok)
        J = jacfwd(residuals)(b, res.v0_world, z, res.depth_ok)[:, :nb]
        delta = torch.linalg.solve(J.T @ J + damp, -(J.T @ r))
        # trust region: an alignment-window bias is never > ~0.05 / 0.2
        delta = torch.clamp(delta, -0.2, 0.2)
        b = torch.cat([b[:nb] + delta, b[nb:]])
        b = torch.cat([torch.clamp(b[0:3], -0.05, 0.05),
                       torch.clamp(b[3:6], -0.3, 0.3)])

    R_i, tc_i, tau, _ = integrate_motion(
        times, imu_dt, imu_gyro, imu_accel, gravity_w,
        gyro_bias=b[0:3], accel_bias=b[3:6])
    return align(h_obs, valid, R_i, tc_i, tau), b[0:3], b[3:6]


def reprojection_errors(res: AlignmentResult, h_obs, valid):
    """Mean per-feature reprojection residual of the aligned solution."""
    h0 = _homogeneous(h_obs[0])
    t_i = res.tc_i[1:] - res.tau_i[1:, None] * (res.R_i[1:] @ res.v0_world)
    p = (torch.einsum("kab,nb->kna", res.R_i[1:], h0)
         * res.depths0[None, :, None] + t_i[:, None, :])
    proj = p[..., :2] / torch.clamp(p[..., 2:3], min=1e-6)
    e = torch.linalg.vector_norm(proj - h_obs[1:], dim=-1)        # [K-1, N]
    m = valid[1:] & valid[0][None] & res.depth_ok[None]
    cnt = torch.clamp(torch.sum(m.to(torch.float32)), min=1.0)
    return torch.sum(torch.where(m, e, 0.0)) / cnt
