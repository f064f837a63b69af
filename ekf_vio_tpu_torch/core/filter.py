"""TightlyCoupledEKF as functions over a ``FilterState`` holding a dense Σ.

Port of ``ekf_vio_tpu/core/filter.py``:

    reference                     ->  here
    TightlyCoupledEKF()           ->  init_state(cfg)
    addNewFeatures(...)           ->  add_features(state, cfg, uv, valid)
    process(dt)                   ->  predict(state, cfg, dt)
    updateWithFeaturePositions()  ->  update_with_feature_positions(...)
    checkSigma()                  ->  check_sigma(state)

and ``CovarianceForm``, the operations the frame flow (``engine.step``)
applies to Σ, on the dense matrix; ``form_of`` chooses it or the factor
form (``sqrt_filter.FactorForm``).
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import dynamics
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import sqrt_filter
from ekf_vio_tpu_torch.core.state import (  # noqa: F401  (re-exports)
    FilterState,
    add_features,
    check_sigma,
    device_scalar,
    drop_features,
    init_state,
    rho_vec,
)
from ekf_vio_tpu_torch.core.update import (  # noqa: F401  (re-exports)
    innovation_nis,
    innovation_nis_per_feature,
    innovation_stats,
    update_with_feature_positions as _update_covariance_form,
)
from ekf_vio_tpu_torch.frontend import klt


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


class CovarianceForm:
    """A form: every operation the frame flow (``engine.step``) applies
    to Σ, here held whole in ``FilterState.Sigma``.  ``sqrt_filter.
    FactorForm`` (a Cholesky factor) has the same ones, and
    ``sharded_filter.SplitForm`` (this rank's blocks) those of the step,
    not ``from_covariance`` or ``covariance``.  ``propagate_imu`` returns
    (filt, frame motion qt), ``update`` (filt, mean NIS); ``gate_nis`` is
    the χ² gate's [N] NIS with the constant R; ``reprime_depths`` wipes
    the booted slots' ρ rows and columns and sets their variance to
    sig_tri²; ``sigma_diag`` is Σ's diagonal from its 22 base variances
    on; ``recovered_sigma`` gives the fields of Σ after a tracking-lost
    reset; ``covariance`` (Σ whole) is for readers outside the flow."""

    predict = staticmethod(predict)
    propagate_imu = staticmethod(imu_mod.propagate_imu_batch_with_motion)
    measurement_covariance = staticmethod(klt.measurement_covariance)
    drop = staticmethod(drop_features)
    add = staticmethod(add_features)

    def gate_nis(self, filt, cfg, cam, measured_uv):
        return innovation_nis_per_feature(
            filt, measured_uv, klt.measurement_covariance_metric(
                cam.fx, cam.fy, cfg.max_features, cfg, device=filt.device))

    def reprime_depths(self, filt, boot, sig_tri):
        n, dtype = filt.n_max, filt.Sigma.dtype
        keep = 1.0 - rho_vec(boot.to(dtype), n)
        Sigma = filt.Sigma * (keep[:, None] * keep[None, :])
        # booted rows were just wiped to a zero diagonal: adding the new
        # prior sets it exactly; other rows add zero
        return filt.replace(Sigma=Sigma + torch.diag(rho_vec(
            torch.where(boot, sig_tri * sig_tri, 0.0).to(dtype), n)))

    def update(self, filt, cfg, measured_uv, meas_cov, passed):
        nis = innovation_nis(filt, measured_uv, meas_cov, passed)
        return update_with_feature_positions(filt, cfg, measured_uv,
                                             meas_cov, passed), nis

    def sigma_diag(self, filt):
        return torch.diagonal(filt.Sigma)

    def sigma_finite(self, filt):
        return torch.isfinite(torch.diagonal(filt.Sigma)).all()

    def recovered_sigma(self, filt, base_variances):
        return dict(Sigma=torch.diag(torch.cat([base_variances, torch.zeros(
            3 * filt.n_max, dtype=filt.Sigma.dtype, device=filt.device)])))

    def pos_cov(self, filt):
        return filt.Sigma[:3, :3]

    def from_covariance(self, filt):
        return filt

    def covariance(self, filt):
        return filt.Sigma


COVARIANCE = CovarianceForm()


def form_of(cfg: VIOConfig):
    """The form the frame flow holds Σ in: the factor form with
    ``cfg.square_root_form``, else the covariance form."""
    return sqrt_filter.FACTOR if cfg.square_root_form else COVARIANCE
