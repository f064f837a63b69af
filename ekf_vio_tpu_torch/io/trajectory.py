"""Trajectory evaluation: alignment + ATE, numpy.

A copy of ``ekf_vio_tpu/io/trajectory.py`` (numpy only, kept here so the
port imports nothing of the JAX package).

Implements the standard monocular-VIO protocol: associate estimate/GT by
timestamp, Umeyama similarity alignment (with scale — monocular scale is
only observable through the depth prior), then RMSE of translational
residuals.
"""
from __future__ import annotations

import numpy as np


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association; returns (idx_est, idx_gt)."""
    j = np.searchsorted(t_gt, t_est)
    j = np.clip(j, 1, len(t_gt) - 1)
    left = t_gt[j - 1]
    right = t_gt[j]
    pick = np.where(np.abs(t_est - left) < np.abs(t_est - right), j - 1, j)
    ok = np.abs(t_gt[pick] - t_est) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform dst ≈ s R src + t.

    Returns (s, R[3,3], t[3])."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    t_est, p_est, t_gt, p_gt, with_scale: bool = True, max_dt: float = 0.02
) -> float:
    """Absolute trajectory error RMSE after timestamp association and
    Umeyama alignment."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        raise ValueError(f"only {len(ie)} associated poses")
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    s, R, t = umeyama(pe, pg, with_scale)
    res = pg - (s * (R @ pe.T).T + t)
    return float(np.sqrt((res**2).sum(-1).mean()))


def relative_pose_error(t_est, p_est, t_gt, p_gt, delta: float = 1.0):
    """Translational RPE over windows of `delta` seconds (drift rate)."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt))
    te = np.asarray(t_est)[ie]
    pe = np.asarray(p_est)[ie]
    pg = np.asarray(p_gt)[ig]
    errs = []
    for i in range(len(te)):
        j = np.searchsorted(te, te[i] + delta)
        if j >= len(te):
            break
        de = pe[j] - pe[i]
        dg = pg[j] - pg[i]
        errs.append(np.linalg.norm(de - dg))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else float("nan")
