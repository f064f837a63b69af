"""Two-view feature depth initialization (triangulation).

Port of ``ekf_vio_tpu/core/depth_init.py``: the closed-form depth of
octave/linear_depth_sol.m (minimize ‖[h2]× (R h1 z + t)‖² over the
frame-1 depth z) and the 1-D Gauss-Newton polish of octave/depth_optim.m,
batched over features, with the shared gate/width policy of the engine's
depth bootstrap and two-view triangulation.  Camera motion takes frame-1
points to frame-2 points as p2 = R p1 + t.
"""
from __future__ import annotations

import math

import torch

from ekf_vio_tpu_torch.core import lie

MIN_POINT_Z = 0.02   # D_MIN_POINT_Z (Params.h:100)
MAX_POINT_Z = 10.0   # D_MAX_POINT_Z (Params.h:99)
MIN_DEPTH_DETERMINANT = 1e-3  # D_MINIMUM_DEPTH_DETERMINANT (Params.h:92)


def _homogeneous(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, torch.ones_like(h[..., :1])], -1)


def relative_motion(base_mu: torch.Tensor, dt):
    """(R, t) of the frame-to-frame camera motion from the filter state,
    the transform feature transport applies (TightlyCoupledEKF.cpp:449-450)."""
    omega, vel, accel = base_mu[10:13], base_mu[7:10], base_mu[13:16]
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    R = lie.quat_to_matrix(dq_inv)
    t = -lie.quat_rotate(dq_inv, dt * vel + 0.5 * dt * dt * accel)
    return R, t


def linear_depth(h1: torch.Tensor, h2: torch.Tensor, R: torch.Tensor,
                 t: torch.Tensor):
    """Closed-form frame-1 depth.  h1, h2: [..., 2] normalized coords.
    Returns (z1, ok): ok = well conditioned and z1 in
    (MIN_POINT_Z, MAX_POINT_Z)."""
    h2h = _homogeneous(h2)
    rh1 = _homogeneous(h1) @ R.T
    a = lie.cross(h2h, rh1)                  # [h2]× R h1
    c = lie.cross(h2h, t)                    # [h2]× t
    den = torch.sum(a * a, -1)
    ok = den > MIN_DEPTH_DETERMINANT * MIN_DEPTH_DETERMINANT
    z = -torch.sum(a * c, -1) / torch.where(ok, den, 1.0)
    ok = ok & (z > MIN_POINT_Z) & (z < MAX_POINT_Z)
    return z, ok


def refine_depth_gn(h1, h2, R, t, z0, iters: int = 5):
    """1-D Gauss-Newton on the reprojection residual r(z) = π(R h1 z + t)
    − h2, ``iters`` steps of z ← z − (JᵀJ)⁻¹Jᵀr clamped to the depth
    range."""
    rh1 = _homogeneous(h1) @ R.T
    z = z0
    for _ in range(iters):
        p = rh1 * z[..., None] + t
        r = p[..., :2] / p[..., 2:3] - h2
        num = rh1[..., :2]
        den = p[..., 2:3]
        J = (num * den - p[..., :2] * rh1[..., 2:3]) / (den * den)
        jtj = torch.sum(J * J, -1)
        jtr = torch.sum(J * r, -1)
        step = jtr / torch.where(jtj > 1e-12, jtj, 1.0)
        z = torch.clamp(z - step, MIN_POINT_Z, MAX_POINT_Z)
    return z


def triangulation_confidence(cfg, fx: float, fy: float, rel_sigma,
                             exact_baseline: bool):
    """Shared gating/width policy: (mean_ok [N], rel [N]).  mean_ok
    accepts the triangulated mean when σ_angle·rel_sigma is below
    ``cfg.triangulation_max_rel_error``; rel is the relative 1σ prior
    width, floored at ``bootstrap_depth_sigma_rel`` with an exact (IMU)
    baseline and at 1 without."""
    sigma_ang = math.sqrt(cfg.klt_measurement_variance_px) * 2.0 / (fx + fy)
    mean_ok = sigma_ang * rel_sigma < cfg.triangulation_max_rel_error
    rel_floor = cfg.bootstrap_depth_sigma_rel if exact_baseline else 1.0
    rel = torch.clamp(2.0 * sigma_ang * rel_sigma, min=rel_floor)
    return mean_ok, rel


def triangulate_depths(h_prev, h_cur, base_mu, dt, default_depth: float,
                       refine: bool = True, Rt=None,
                       return_rel_sigma: bool = False):
    """Frame-current depths of features seen in both frames.

    Returns (z_cur [N], ok [N]) and, with ``return_rel_sigma``, the
    relative depth error per unit angular noise, 1 / |[h2]× R h1|.
    ``Rt`` is the exact inter-frame motion (mandatory under IMU
    propagation); without it the motion comes from the filter state."""
    R, t = Rt if Rt is not None else relative_motion(base_mu, dt)
    z1, ok = linear_depth(h_prev, h_cur, R, t)
    z1 = torch.where(ok, z1, default_depth)
    if refine:
        z1 = torch.where(ok, refine_depth_gn(h_prev, h_cur, R, t, z1), z1)
    rh1 = _homogeneous(h_prev) @ R.T
    z_cur = torch.clamp(rh1[..., 2] * z1 + t[2], MIN_POINT_Z, MAX_POINT_Z)
    z_out = torch.where(ok, z_cur, default_depth)
    if not return_rel_sigma:
        return z_out, ok
    cross = torch.linalg.vector_norm(lie.cross(_homogeneous(h_cur), rh1), dim=-1)
    rel_sigma = 1.0 / torch.clamp(cross, min=1e-6)
    return z_out, ok, rel_sigma
