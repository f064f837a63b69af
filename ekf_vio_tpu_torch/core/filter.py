"""TightlyCoupledEKF as functions over a ``FilterState`` holding a dense Σ.

Port of ``ekf_vio_tpu/core/filter.py``:

    reference                     ->  here
    TightlyCoupledEKF()           ->  init_state(cfg)
    addNewFeatures(...)           ->  add_features(state, cfg, uv, valid)
    process(dt)                   ->  predict(state, cfg, dt)
    updateWithFeaturePositions()  ->  update_with_feature_positions(...)
    checkSigma()                  ->  check_sigma(state)
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import dynamics, sqrt_filter
from ekf_vio_tpu_torch.core.state import (  # noqa: F401  (re-exports)
    FilterState,
    add_features,
    check_sigma,
    device_scalar,
    drop_features,
    init_state,
)
from ekf_vio_tpu_torch.core.update import (  # noqa: F401  (re-exports)
    innovation_stats,
    update_with_feature_positions as _update_covariance_form,
)


def update_with_feature_positions(state, cfg, measured_uv, meas_cov, passed,
                                  budget=None) -> FilterState:
    """EKF update, dispatching on ``cfg.square_root_form``: the dense
    covariance-form update (core/update.py) or the QR square-root array
    update (core/sqrt_filter.py) on a dense Σ, with the same semantics.
    ``budget`` (static) compacts the measured subset before the
    factorization, in the covariance form only."""
    if cfg.square_root_form:
        # budget >= n_max is the dense path's no-op; only an actual
        # compaction request is refused for the QR-array update
        if budget is not None and budget < state.n_max:
            raise ValueError(
                "measured-subset compaction (budget) is implemented for "
                "the covariance-form update only; the sqrt QR-array "
                "update runs the full masked system")
        return sqrt_filter.update_sqrt(state, cfg, measured_uv, meas_cov,
                                       passed)
    return _update_covariance_form(state, cfg, measured_uv, meas_cov, passed,
                                   budget)


def predict(state: FilterState, cfg: VIOConfig, dt) -> FilterState:
    """Process step (TightlyCoupledEKF::process, cpp:96-121): exact
    Jacobian blocks, mean transport (features with the pre-update base
    state, cpp:102-107), then Σ ← FΣFᵀ + Q; with
    ``cfg.square_root_form`` the covariance propagates as an orthogonal
    triangularization instead (core/sqrt_filter.py)."""
    if cfg.square_root_form:
        return sqrt_filter.predict_sqrt(state, cfg, dt)
    dt = device_scalar(dt, state.base_mu.dtype, state.device)

    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu,
                                                   state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)
    q_diag = dynamics.process_noise_diag(dt, state.n_max, state.active,
                                         cfg).to(state.Sigma.dtype)
    Sigma = dynamics.propagate_covariance(state.Sigma, Fb, Ffb, Ff, q_diag)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                         t=state.t + dt)
