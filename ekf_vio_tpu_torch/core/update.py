"""EKF measurement update — dense, masked, fixed-shape.

Port of ``ekf_vio_tpu/core/update.py`` (TightlyCoupledEKF.cpp:475-628).
H is the static selector of every slot's (u, v) rows, so HΣ and ΣHᵀ are
strided views of Σ; slots that were not measured collapse to identity rows
of S and zero gain columns, so one fixed-shape Cholesky serves every frame
without a host sync.  The gain solve is ``cholesky_ex`` + ``cholesky_solve``;
a failed factorization skips the update (TightlyCoupledEKF.cpp:579).  A
``budget`` compacts the measured subset first (data-dependent gathers, no
host read), and ``cfg.joseph_form`` picks the expanded or the materialized
Joseph form.
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
    """Masked EKF update with the Joseph form ``cfg.joseph_form``.

    Features with ``passed=False`` contribute nothing; the caller frees
    their slots with ``drop_features``.  ``budget`` (static) compacts the
    measured subset before the factorization: measured slots are gathered
    to the front (stable sort of the mask) and only a [2·budget, 2·budget]
    system is factorized.  Exact whenever the measured count fits the
    budget; measured features beyond it stay uncorrected for the frame
    but still refresh ``klt_ref``.  Callers keep TF32 off."""
    n_full = state.n_max
    d = state.state_dim
    dtype, dev = state.Sigma.dtype, state.device
    meas_full = passed & state.active
    compact = budget is not None and budget < n_full

    mu = state.mu_flat()
    if compact:
        n = budget
        # stable sort of ~meas: measured slots first, in slot order
        idx_c = torch.argsort((~meas_full).to(torch.int8), stable=True)[:n]
        uv_idx = (BASE_STATE_SIZE + 3 * idx_c[:, None]
                  + torch.arange(2, device=dev)[None, :]).reshape(-1)
        meas = meas_full[idx_c]
        meas_cov = meas_cov[idx_c]
        m = meas.repeat_interleave(2).to(dtype)           # [2B]
        y = (measured_uv[idx_c].reshape(-1) - mu[uv_idx]) * m
        A = state.Sigma[:, uv_idx]                        # [D, 2B] = ΣHᵀ
        S = A[uv_idx, :] + block_diag(meas_cov)           # [2B, 2B]
    else:
        n = n_full
        meas = meas_full
        m = meas.repeat_interleave(2).to(dtype)           # [2N]
        y = (measured_uv.reshape(-1) - state.feat_mu[:, :2].reshape(-1)) * m
        A = uv_cols(state.Sigma)                          # [D, 2N] = ΣHᵀ
        S = uv_rows(A) + block_diag(meas_cov)             # [2N, 2N]

    mm = m[:, None] * m[None, :]
    S_true = S * mm            # unregularized masked S, for the Joseph form
    S = S * mm + torch.diag(1.0 - m)
    # relative spectral floor (VIOConfig.sigma_jitter_rel)
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(
        torch.diagonal(S) * m)
    S = S + lam * torch.eye(2 * n, dtype=S.dtype, device=dev)
    A = A * m[None, :]

    L, info = torch.linalg.cholesky_ex(S)
    K = torch.cholesky_solve(A.T, L).T                  # [D, 2N]
    solve_ok = torch.isfinite(K).all() & (info == 0)
    K = torch.where(solve_ok, K, 0.0)

    mu = mu + K @ y
    if cfg.joseph_form == "expanded":
        # Joseph form expanded through the selector structure of H:
        # (I−KH)Σ(I−KH)ᵀ + KRKᵀ = Σ − K(HΣ) − (ΣHᵀ)Kᵀ + K(HΣHᵀ+R)Kᵀ
        B = K @ A.T
        Sigma = state.Sigma - B - B.T + (K @ S_true) @ K.T
    else:
        # materialized product (TightlyCoupledEKF.cpp:586-596): the
        # subtraction happens in I−KH before the quadratic form
        if not compact:
            slots = torch.arange(n, device=dev)
            uv_idx = (BASE_STATE_SIZE + 3 * slots[:, None]
                      + torch.arange(2, device=dev)[None, :]).reshape(-1)
        I_KH = torch.eye(d, dtype=dtype, device=dev)
        I_KH[:, uv_idx] -= K
        Sigma = (I_KH @ state.Sigma @ I_KH.T
                 + K @ (block_diag(meas_cov) * mm) @ K.T)
    Sigma = 0.5 * (Sigma + Sigma.T)

    # quaternion renormalization (TightlyCoupledEKF.cpp:604-609)
    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])

    # every measured feature caches its tracker result, the measured but
    # over-budget ones too
    klt_ref = torch.where(meas_full[:, None], measured_uv, state.klt_ref)
    return state.replace(base_mu=mu[:BASE_STATE_SIZE],
                         feat_mu=mu[BASE_STATE_SIZE:].reshape(n_full, 3),
                         Sigma=Sigma, klt_ref=klt_ref)


def innovation_stats(state: FilterState, measured_uv, passed) -> torch.Tensor:
    """Mean innovation magnitude over measured features."""
    meas = passed & state.active
    mag = torch.linalg.vector_norm(measured_uv - state.feat_mu[:, :2], dim=-1)
    cnt = torch.clamp(meas.sum(), min=1)
    return torch.sum(torch.where(meas, mag, 0.0)) / cnt


def innovation_nis_per_feature(state: FilterState, measured_uv, meas_cov,
                               factor: bool = False) -> torch.Tensor:
    """[N] per-feature NIS yᵢᵀ Sᵢ⁻¹ yᵢ with Sᵢ the feature's own 2x2 block
    Σ_uv + Rᵢ of the pre-update state.  ``factor=True`` reads the block
    from a Cholesky-factor state (Σ_block = L_uv L_uvᵀ)."""
    y = measured_uv - state.feat_mu[:, :2]
    n = state.n_max
    if factor:
        Luv = uv_rows(state.Sigma).reshape(n, 2, -1)          # [N, 2, D]
        Suv = Luv @ Luv.transpose(1, 2)
    else:
        tail = state.Sigma[BASE_STATE_SIZE:, BASE_STATE_SIZE:]
        blocks = torch.diagonal(tail.reshape(n, 3, n, 3), dim1=0, dim2=2)
        Suv = blocks.permute(2, 0, 1)[:, :2, :2]
    S = Suv + meas_cov
    det = torch.clamp(S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0],
                      min=1e-30)
    return (S[:, 1, 1] * y[:, 0] ** 2 - 2 * S[:, 0, 1] * y[:, 0] * y[:, 1]
            + S[:, 0, 0] * y[:, 1] ** 2) / det


def innovation_nis(state: FilterState, measured_uv, meas_cov, passed,
                   factor: bool = False) -> torch.Tensor:
    """Mean per-feature NIS over measured features (E[NIS] = 2)."""
    nis = innovation_nis_per_feature(state, measured_uv, meas_cov,
                                     factor=factor)
    meas = passed & state.active
    cnt = torch.clamp(meas.sum(), min=1)
    return torch.sum(torch.where(meas, nis, 0.0)) / cnt
