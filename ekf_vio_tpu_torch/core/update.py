"""EKF measurement update — dense, masked, fixed-shape.

Port of ``ekf_vio_tpu/core/update.py`` (TightlyCoupledEKF.cpp:475-628).
H is the static selector of every slot's (u, v) rows, so HΣ and ΣHᵀ are
strided views of Σ; slots that were not measured collapse to identity rows
of S and zero gain columns, so one fixed-shape Cholesky serves every frame
without a host sync.  The gain solve is ``cholesky_ex`` + ``cholesky_solve``;
a failed factorization skips the update (TightlyCoupledEKF.cpp:579).
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core.state import (FilterState, block_diag, uv_cols,
                                          uv_rows)


def update_with_feature_positions(
    state: FilterState,
    cfg: VIOConfig,
    measured_uv: torch.Tensor,  # [N_max, 2] metric positions from the tracker
    meas_cov: torch.Tensor,     # [N_max, 2, 2] measurement covariance
    passed: torch.Tensor,       # [N_max] bool — tracker success
    budget: int | None = None,
) -> FilterState:
    """Masked EKF update with the expanded Joseph form.

    Features with ``passed=False`` contribute nothing; the caller frees
    their slots with ``drop_features``.  Callers keep TF32 off."""
    n = state.n_max
    if budget is not None and budget < n:
        raise NotImplementedError(
            "measured-subset compaction (budget) is not ported yet")
    if cfg.joseph_form != "expanded":
        raise NotImplementedError(
            "the materialized Joseph form is not ported yet")

    meas = passed & state.active
    m = meas.repeat_interleave(2).to(state.Sigma.dtype)   # [2N]
    mu = state.mu_flat()
    z = measured_uv.reshape(-1)
    y = (z - state.feat_mu[:, :2].reshape(-1)) * m
    A = uv_cols(state.Sigma)                             # [D, 2N] = ΣHᵀ
    S = uv_rows(A) + block_diag(meas_cov)                # [2N, 2N]

    mm = m[:, None] * m[None, :]
    S_true = S * mm            # unregularized masked S, for the Joseph form
    S = S * mm + torch.diag(1.0 - m)
    # relative spectral floor (VIOConfig.sigma_jitter_rel)
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(
        torch.diagonal(S) * m)
    S = S + lam * torch.eye(2 * n, dtype=S.dtype, device=S.device)
    A = A * m[None, :]

    L, info = torch.linalg.cholesky_ex(S)
    K = torch.cholesky_solve(A.T, L).T                  # [D, 2N]
    solve_ok = torch.isfinite(K).all() & (info == 0)
    K = torch.where(solve_ok, K, 0.0)

    mu = mu + K @ y
    # Joseph form expanded through the selector structure of H:
    # (I−KH)Σ(I−KH)ᵀ + KRKᵀ = Σ − K(HΣ) − (ΣHᵀ)Kᵀ + K(HΣHᵀ+R)Kᵀ
    B = K @ A.T
    Sigma = state.Sigma - B - B.T + (K @ S_true) @ K.T
    Sigma = 0.5 * (Sigma + Sigma.T)

    # quaternion renormalization (TightlyCoupledEKF.cpp:604-609)
    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])

    klt_ref = torch.where(meas[:, None], measured_uv, state.klt_ref)
    return state.replace(base_mu=mu[:BASE_STATE_SIZE],
                         feat_mu=mu[BASE_STATE_SIZE:].reshape(n, 3),
                         Sigma=Sigma, klt_ref=klt_ref)


def innovation_stats(state: FilterState, measured_uv, passed) -> torch.Tensor:
    """Mean innovation magnitude over measured features."""
    meas = passed & state.active
    mag = torch.linalg.vector_norm(measured_uv - state.feat_mu[:, :2], dim=-1)
    cnt = torch.clamp(meas.sum(), min=1)
    return torch.sum(torch.where(meas, mag, 0.0)) / cnt


def innovation_nis_per_feature(state: FilterState, measured_uv,
                               meas_cov) -> torch.Tensor:
    """[N] per-feature NIS yᵢᵀ Sᵢ⁻¹ yᵢ with Sᵢ the feature's own 2x2 block
    Σ_uv + Rᵢ of the pre-update state (covariance form)."""
    y = measured_uv - state.feat_mu[:, :2]
    tail = state.Sigma[BASE_STATE_SIZE:, BASE_STATE_SIZE:]
    n = state.n_max
    blocks = torch.diagonal(tail.reshape(n, 3, n, 3), dim1=0, dim2=2)
    S = blocks.permute(2, 0, 1)[:, :2, :2] + meas_cov
    det = torch.clamp(S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0],
                      min=1e-30)
    return (S[:, 1, 1] * y[:, 0] ** 2 - 2 * S[:, 0, 1] * y[:, 0] * y[:, 1]
            + S[:, 0, 0] * y[:, 1] ** 2) / det


def innovation_nis(state: FilterState, measured_uv, meas_cov,
                   passed) -> torch.Tensor:
    """Mean per-feature NIS over measured features (E[NIS] = 2)."""
    nis = innovation_nis_per_feature(state, measured_uv, meas_cov)
    meas = passed & state.active
    cnt = torch.clamp(meas.sum(), min=1)
    return torch.sum(torch.where(meas, nis, 0.0)) / cnt
