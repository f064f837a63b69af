"""Process model: base-state and feature transport and their Jacobians.

Port of ``ekf_vio_tpu/core/dynamics.py`` (reference motion model,
TightlyCoupledEKF.cpp:328-460).  The 22x22 base block and the 7x22 camera
action Jacobian come from ``torch.func.jacfwd`` as the JAX package takes
them from ``jax.jacfwd``; the per-feature blocks are the closed-form
batched expressions of the action (q, t) on [u, v, ρ].
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE
from ekf_vio_tpu_torch.core import lie
from ekf_vio_tpu_torch.core.state import block_diag


def convolve_base_state(base_mu: torch.Tensor, dt) -> torch.Tensor:
    """Propagate the 22-dim base state by dt (no noise)."""
    pos, quat = base_mu[0:3], base_mu[3:7]
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]

    disp = dt * vel + 0.5 * dt * dt * accel
    pos = pos + lie.quat_rotate(quat, disp)
    dq = lie.quat_exp_omega(omega, dt)
    dq_inv = lie.quat_conj(dq)
    vel = lie.quat_rotate(dq_inv, vel + dt * accel)
    accel_new = lie.quat_rotate(dq_inv, accel)
    quat = lie.quat_mul(quat, dq)
    return torch.cat([pos, quat, vel, omega, accel_new, base_mu[16:22]])


def convolve_feature(base_mu: torch.Tensor, feat_mu: torch.Tensor,
                     dt) -> torch.Tensor:
    """Transport one feature [u, v, ρ] into the next camera frame (the
    per-feature form whose Jacobians ``imu.propagate_imu_step`` takes
    with ``torch.func.jacfwd``)."""
    return convolve_features(base_mu, feat_mu[None], dt)[0]


def convolve_features(base_mu: torch.Tensor, feat_mu: torch.Tensor,
                      dt) -> torch.Tensor:
    """Transport [N, 3] features [u, v, ρ] into the next camera frame:
    p ← dq⁻¹p − dq⁻¹(v·dt + ½a·dt²), re-projected."""
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]
    z = 1.0 / feat_mu[:, 2]
    p = torch.stack([feat_mu[:, 0] * z, feat_mu[:, 1] * z, z], -1)
    translation = dt * vel + 0.5 * dt * dt * accel
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    p = lie.quat_rotate(dq_inv, p) - lie.quat_rotate(dq_inv, translation)
    return torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], 1.0 / p[:, 2]],
                       -1)


def camera_motion_qt(base_mu: torch.Tensor, dt) -> torch.Tensor:
    """[7] camera action (q, t) over dt with p' = R(q) p + t:
    q = dq⁻¹, t = −R(dq⁻¹)(dt·v + ½dt²·a) (TightlyCoupledEKF.cpp:449-450)."""
    vel, omega, accel = base_mu[7:10], base_mu[10:13], base_mu[13:16]
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * accel
    return torch.cat([dq_inv, -lie.quat_rotate(dq_inv, d)])


def _rotate_jac_quat(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """d(quat_rotate(q, p))/dq for p: [N, 3] → [N, 3, 4], differentiated
    unconstrained in q = [w, u]:
        ∂f/∂w = 2(u×p),  ∂f/∂u = 2((uᵀp)I + u pᵀ − 2 p uᵀ − w [p]ₓ)."""
    w, u = q[0], q[1:4]
    col_w = 2.0 * lie.cross(u, p)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    utp = torch.sum(u * p, -1)
    block_u = 2.0 * (utp[:, None, None] * eye
                     + u[:, None] * p[:, None, :]
                     - 2.0 * p[:, :, None] * u[None, :]
                     - w * lie.skew(p))
    return torch.cat([col_w[:, :, None], block_u], -1)


def transport_jacobians(feat_mu: torch.Tensor, qt: torch.Tensor):
    """Analytic transport and Jacobians, batched over features.

    Returns (feat' [N,3], Ff [N,3,3] = ∂feat'/∂[u,v,ρ],
             W [N,3,7] = ∂feat'/∂[q,t])."""
    q, t = qt[0:4], qt[4:7]
    R = lie.quat_to_matrix(q)
    z = 1.0 / feat_mu[:, 2]
    h = torch.stack([feat_mu[:, 0], feat_mu[:, 1], torch.ones_like(z)], -1)
    p = z[:, None] * h
    p2 = p @ R.T + t

    inv_z2 = 1.0 / p2[:, 2]
    zero = torch.zeros_like(inv_z2)
    one = torch.ones_like(inv_z2)
    # projection Jacobian ∂[x/z, y/z, 1/z]/∂p', rows scaled by 1/z
    P = inv_z2[:, None, None] * torch.stack([
        torch.stack([one, zero, -p2[:, 0] * inv_z2], -1),
        torch.stack([zero, one, -p2[:, 1] * inv_z2], -1),
        torch.stack([zero, zero, -inv_z2], -1),
    ], -2)
    # ∂p/∂[u,v,ρ] = [z e1 | z e2 | −z² h]
    dp = torch.stack([
        torch.stack([z, zero, -z * z * h[:, 0]], -1),
        torch.stack([zero, z, -z * z * h[:, 1]], -1),
        torch.stack([zero, zero, -z * z], -1),
    ], -2)
    Ff = (P @ R) @ dp
    W = torch.cat([P @ _rotate_jac_quat(q, p), P], -1)
    feat2 = torch.stack([p2[:, 0] * inv_z2, p2[:, 1] * inv_z2, inv_z2], -1)
    return feat2, Ff, W


def process_jacobian_blocks(base_mu: torch.Tensor, feat_mu: torch.Tensor, dt):
    """Exact Jacobian blocks of the process model:
    Fb [22, 22] = ∂base'/∂base, Ffb [N, 3, 22] = ∂feat'/∂base,
    Ff [N, 3, 3] = ∂feat'/∂feat."""
    Fb = jacfwd(convolve_base_state)(base_mu, dt)
    qt = camera_motion_qt(base_mu, dt)
    Jqt = jacfwd(camera_motion_qt)(base_mu, dt)            # [7, 22]
    _, Ff, W = transport_jacobians(feat_mu, qt)
    return Fb, W @ Jqt, Ff


def mask_feature_jacobians(Ffb, Ff, active):
    """Inactive slots get identity self-blocks and no base coupling
    (bias rows are identity, TightlyCoupledEKF.cpp:255-257)."""
    a = active[:, None, None]
    eye3 = torch.eye(3, dtype=Ff.dtype, device=Ff.device)
    return torch.where(a, Ffb, 0.0), torch.where(a, Ff, eye3)


def build_dense_F(Fb, Ffb, Ff) -> torch.Tensor:
    """F = [[Fb, 0], [Ffb, blkdiag(Ff)]], [D, D] with D = 22 + 3N."""
    n = Ff.shape[0]
    top = torch.cat([Fb, Fb.new_zeros(BASE_STATE_SIZE, 3 * n)], dim=1)
    bot = torch.cat([Ffb.reshape(3 * n, BASE_STATE_SIZE), block_diag(Ff)],
                    dim=1)
    return torch.cat([top, bot], dim=0)


def propagate_covariance(Sigma, Fb, Ffb, Ff, q_diag) -> torch.Tensor:
    """Σ ← F Σ Fᵀ + Q as one dense triple product, symmetrized.  Callers
    keep TF32 off: the spectrum spans 1e-5..1e2 and needs true f32."""
    F = build_dense_F(Fb, Ffb, Ff)
    out = F @ Sigma @ F.T + torch.diag(q_diag)
    return 0.5 * (out + out.T)


def blk_left(B: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """blkdiag(B) @ M for B [m, 3, 3] and M [3m, c]."""
    m = B.shape[0]
    return torch.einsum("nij,njc->nic", B, M.reshape(m, 3, -1)).reshape(
        3 * m, -1)


def blk_right(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """M @ blkdiag(B)ᵀ for M [r, 3m] and B [m, 3, 3]."""
    m = B.shape[0]
    return torch.einsum("rnj,nij->rni", M.reshape(M.shape[0], m, 3),
                        B).reshape(M.shape[0], -1)


def propagate_covariance_blocked(Sigma, Fb, Ffb, Ff, q_diag) -> torch.Tensor:
    """Σ ← F Σ Fᵀ + Q through the block structure of F = [[Fb, 0], [L, B]]
    (L = Ffb rows, B = blkdiag(Ff)), with no [D, D] F:

        Σbb' = Fb Σbb Fbᵀ,   Σbf' = Fb (Σbb Lᵀ + Σbf Bᵀ),
        Σff' = L Σbb Lᵀ + L Σbf Bᵀ + (L Σbf Bᵀ)ᵀ + B Σff Bᵀ,

    the block-diagonal products as [N, 3, 3] einsums.  The single-device
    form of ``parallel/sharded_filter.sharded_predict``."""
    nb = BASE_STATE_SIZE
    n = Ff.shape[0]
    Sbb, Sbf, Sff = Sigma[:nb, :nb], Sigma[:nb, nb:], Sigma[nb:, nb:]
    L = Ffb.reshape(3 * n, nb)
    Sbb_Lt = Sbb @ L.T                                     # [22, 3N]
    Sbf_Bt = blk_right(Sbf, Ff)                            # [22, 3N]
    new_bb = Fb @ Sbb @ Fb.T
    new_bf = Fb @ (Sbb_Lt + Sbf_Bt)
    L_Sbf_Bt = L @ Sbf_Bt
    new_ff = (L @ Sbb_Lt + L_Sbf_Bt + L_Sbf_Bt.T
              + blk_right(blk_left(Ff, Sff), Ff))
    out = torch.cat([torch.cat([new_bb, new_bf], 1),
                     torch.cat([new_bf.T, new_ff], 1)], 0)
    out = out + torch.diag(q_diag)
    return 0.5 * (out + out.T)


def process_noise_diag(dt, n_max: int, active: torch.Tensor,
                       cfg) -> torch.Tensor:
    """Diagonal Q(dt) (TightlyCoupledEKF.cpp:123-174): per-second rates
    times dt; inactive feature slots get none."""
    kw = dict(dtype=torch.float32, device=active.device)
    base = torch.cat([
        torch.full((7,), cfg.q_pos, **kw),
        torch.full((3,), cfg.q_vel, **kw),
        torch.full((3,), cfg.q_omega, **kw),
        torch.full((3,), cfg.q_accel, **kw),
        torch.full((6,), cfg.q_bias, **kw),
    ])
    feat = torch.where(active[:, None], cfg.q_feature, 0.0) * torch.ones(
        n_max, 3, **kw)
    return torch.cat([base, feat.reshape(-1)]) * dt
