"""Square-root (Cholesky-factor) predict and update.

Port of ``ekf_vio_tpu/core/sqrt_filter.py``.  Both steps run in factor
space, so no cancellation-prone operation of the covariance form remains:

* predict:  Σ' = FΣFᵀ + Q   becomes   L' = tria([F L | √Q])
* update:   the QR array algorithm — one orthogonal triangularization of

      pre = [[√R,  H L],          postᵀ = qr(preᵀ)  ⇒  post = [[S^c, 0 ],
             [ 0,   L ]]                                       [ G,  L']]

  with S^c S^cᵀ = HΣHᵀ + R + λ and G = ΣHᵀ S^{-cᵀ}; the gain comes from
  that λ-damped factorization, and the posterior from a second,
  Joseph-exact triangularization with the true R,
  L' = tria([(I−KH)L | K·chol R]), PSD by construction for any K.

With ``VIOConfig.square_root_form`` the engine keeps the LOWER CHOLESKY
FACTOR ``L`` in ``FilterState.Sigma`` across steps: factored once at
initialization (``to_factor``) and never re-squared in the loop.  Dropping
a slot zeroes its rows of L (exact, no QR); adding a slot or re-priming a
depth is one QR re-triangularization (``wipe_rows_factor``).  Rows of
exactly-zero variance (the anchored pose gauge, freed slots) are zero rows
of L throughout, so the pre-arrays are rank-deficient by design: ``R`` of
their QR is unique only up to what those rows leave free, and LAPACK and
cuSOLVER may differ there.  ``L Lᵀ`` is what is defined, and what the
tests compare.

``torch.linalg.qr(mode="r")``, ``cholesky_ex`` and ``solve_triangular``
are the library calls the JAX package leaves to XLA.  A failed Cholesky
becomes NaN (as ``jnp.linalg.cholesky`` returns it) through ``_chol_nan``,
with no host read, so the update's finiteness guard skips the update.
Callers keep TF32 off (``engine.use_f32_matmul``): ``F @ L`` and
``K @ HL`` need true f32.  ``predict_sqrt`` / ``update_sqrt`` are the
dense-boundary wrappers (factor on entry, square on exit).

Each triangularization runs in a span of the recorder
(``utils/profiling.py``), ``vio.tria.<role>``: ``imu`` (the compound IMU
propagation), ``predict`` (the random-walk process), ``update`` (the
array QR), ``posterior`` (the Joseph re-triangularization) and ``wipe``
(a slot add or a depth re-prime).  The update counts ``skipped``: an
update that a failed factorization or a non-finite gain left as
predicted.  With no recorder on a span is a ``record_function`` range and
the count computes nothing, so a captured step gains no node.
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import dynamics
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import state as state_mod
from ekf_vio_tpu_torch.core.state import FilterState
from ekf_vio_tpu_torch.utils import profiling


def _chol_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor(s) of A, all-NaN where the factorization
    failed (``jnp.linalg.cholesky``'s convention), without a host read."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def _stabilized_chol(Sigma: torch.Tensor):
    """Lower Cholesky factor of Σ with exactly-zero diagonal entries (PSD:
    the whole row and column is zero) pinned to 1 for the factorization.
    Returns (L, pad), pad the indicator of the pinned entries."""
    pad = (torch.diagonal(Sigma) == 0.0).to(Sigma.dtype)
    return _chol_nan(Sigma + torch.diag(pad)), pad


def _qr_r(pre_T: torch.Tensor, role: str) -> torch.Tensor:
    """R of the QR of ``pre_T``, in the span ``vio.tria.<role>``."""
    with profiling.span("vio.tria." + role):
        return torch.linalg.qr(pre_T, mode="r").R


def _tria(pre_T: torch.Tensor, role: str) -> torch.Tensor:
    """Lower-triangular factor of pre_Tᵀ·pre_T via one QR (pre_T: [M, D]),
    with the diagonal sign-normalized nonnegative (a zero diagonal entry
    keeps its row: sign 0 counts as +1)."""
    R = _qr_r(pre_T, role)
    s = torch.sign(torch.diagonal(R))
    s = torch.where(s == 0, 1.0, s)
    return (R * s[:, None]).T


def to_factor(state: FilterState) -> FilterState:
    """Dense-Σ state → factor state (the Sigma field holds lower L).
    Exactly-zero-variance rows become zero rows of L."""
    L, pad = _stabilized_chol(state.Sigma)
    return state.replace(Sigma=L * (1.0 - pad)[:, None])


def to_covariance(state: FilterState) -> FilterState:
    """Factor state → dense-Σ state."""
    L = state.Sigma
    Sigma = L @ L.T
    return state.replace(Sigma=0.5 * (Sigma + Sigma.T))


def sigma_diag_factor(L: torch.Tensor) -> torch.Tensor:
    """diag(LLᵀ) without squaring: squared row norms."""
    return torch.sum(L * L, dim=1)


def wipe_rows_factor(L: torch.Tensor, wipe: torch.Tensor,
                     new_diag: torch.Tensor) -> torch.Tensor:
    """Factor-space analog of zeroing Σ rows/cols ``wipe`` and setting
    their diagonal to ``new_diag``: L' = tria([P L | √new_diag e_r ...]).

    wipe: [D] bool or float row selector; new_diag: [D] variances, read at
    wiped rows only.  One [2D, D] QR."""
    w = wipe.to(L.dtype)
    L1 = L * (1.0 - w)[:, None]
    # a select, not a multiply: new_diag may carry NaN at rows that are
    # not wiped (a σ computed over every slot, dead ones included), and
    # NaN * 0 = NaN would reach the whole factor through the QR
    add = torch.diag(torch.where(w > 0.0,
                                 torch.sqrt(torch.clamp(new_diag, min=0.0)),
                                 0.0).to(L.dtype))
    return _tria(torch.cat([L1.T, add], 0), "wipe")


def predict_sqrt_factor(state: FilterState, cfg: VIOConfig,
                        dt) -> FilterState:
    """Factor-native process step: L' = tria([F L | √Q])."""
    dt = state_mod.device_scalar(dt, state.base_mu.dtype, state.device)
    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu,
                                                   state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)
    q_diag = dynamics.process_noise_diag(dt, state.n_max, state.active,
                                         cfg).to(state.Sigma.dtype)
    F = dynamics.build_dense_F(Fb, Ffb, Ff)
    A = torch.cat([(F @ state.Sigma).T, torch.diag(torch.sqrt(q_diag))], 0)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu,
                         Sigma=_tria(A, "predict"), t=state.t + dt)


def propagate_imu_factor(state: FilterState, cfg: VIOConfig,
                         batch: imu_mod.ImuSample, gravity_w, lin_base=None):
    """Factor-native compound IMU propagation (the sqrt form of
    ``imu.propagate_imu_batch_with_motion``): one QR of

        [ (F L)ᵀ ; (T·chol(Q29))ᵀ ; diag(√q_feat) ]

    where T = [[I₂₂, 0], [0, Wm]] maps the 29-dim compound noise onto the
    state.  Returns (state', qt)."""
    nb = BASE_STATE_SIZE
    n = state.n_max
    dtype, dev = state.Sigma.dtype, state.device
    base_mu, qt, qt_lin, J, Q29, total_dt = imu_mod.compound_interval(
        state.base_mu, cfg, batch, gravity_w, lin_base=lin_base)

    Fb = J[:nb, :nb]
    new_feat = imu_mod.compound_transport(state.feat_mu, qt)
    _, Ff, W = dynamics.transport_jacobians(state.feat_mu, qt_lin)
    Ffb = torch.einsum("nij,jb->nib", W, J[nb:, :nb])
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    W = torch.where(state.active[:, None, None], W, 0.0)

    q_feat = torch.where(state.active[:, None], cfg.q_feature, 0.0) \
        * torch.ones(n, 3, dtype=dtype, device=dev) * total_dt
    q_diag = torch.cat([torch.zeros(nb, dtype=dtype, device=dev),
                        q_feat.reshape(-1)])

    # noise factor: Q_total = T Q29 Tᵀ with T = [[I, 0], [0, Wm]]
    jit29 = 1e-12 * torch.clamp(torch.max(torch.diagonal(Q29)), min=1e-30)
    C29 = _chol_nan(Q29 + jit29 * torch.eye(29, dtype=dtype, device=dev))
    Wm = W.reshape(3 * n, 7)
    TC = torch.cat([C29[:nb, :], Wm @ C29[nb:, :]], 0)        # [D, 29]

    F = dynamics.build_dense_F(Fb, Ffb, Ff)
    A = torch.cat([(F @ state.Sigma).T, TC.T,
                   torch.diag(torch.sqrt(q_diag))], 0)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu,
                         Sigma=_tria(A, "imu"), t=state.t + total_dt), qt


def update_sqrt_factor(state: FilterState, cfg: VIOConfig,
                       measured_uv: torch.Tensor,  # [N_max, 2]
                       meas_cov: torch.Tensor,     # [N_max, 2, 2]
                       passed: torch.Tensor,       # [N_max] bool
                       ) -> FilterState:
    """Factor-native masked QR-array measurement update (state.Sigma holds
    L in and out).  A failed factorization or a non-finite gain leaves the
    state as predicted, and is counted as ``skipped``."""
    n = state.n_max
    d = state.state_dim
    dtype, dev = state.Sigma.dtype, state.device

    meas = passed & state.active
    m = meas.repeat_interleave(2).to(dtype)               # [2N]
    mu = state.mu_flat()
    y = (measured_uv.reshape(-1) - state.feat_mu[:, :2].reshape(-1)) * m

    L = state.Sigma
    HL = state_mod.uv_rows(L) * m[:, None]                # [2N, D]

    # relative spectral floor, the covariance-form update's semantics:
    # λ = jitter + rel · max(diag S) added to R, as gain damping only
    r_diag = torch.diagonal(meas_cov, dim1=-2, dim2=-1).reshape(-1)
    s_diag = (torch.sum(HL * HL, dim=1) + r_diag) * m
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(s_diag)

    eye2 = torch.eye(2, dtype=meas_cov.dtype, device=dev)
    mm = m[:, None] * m[None, :]
    Rc = state_mod.block_diag(_chol_nan(meas_cov + (lam + 1e-30) * eye2))
    Rc = Rc * mm + torch.diag(1.0 - m)

    two_n = 2 * n
    pre_T = torch.cat([
        torch.cat([Rc.T, torch.zeros(two_n, d, dtype=dtype, device=dev)], 1),
        torch.cat([HL.T, L.T], 1)], 0)
    post = _qr_r(pre_T, "update").T
    Sc = post[:two_n, :two_n]          # chol(HΣHᵀ + R + λ)
    G = post[two_n:, :two_n]           # ΣHᵀ Sc⁻ᵀ

    # gain from the λ-damped factorization: K = ΣHᵀ(S+λ)⁻¹ = G Sc⁻¹
    e = torch.linalg.solve_triangular(Sc, y[:, None], upper=False)[:, 0]
    K = torch.linalg.solve_triangular(Sc.T, G.T, upper=True).T    # [D, 2N]
    ok = torch.isfinite(e).all() & torch.isfinite(K).all()
    profiling.count("skipped", ok, True)   # ok ^ True: skipped
    e = torch.where(ok, e, 0.0)
    K = torch.where(ok, K, 0.0)
    G = torch.where(ok, G, 0.0)

    mu = mu + G @ e                    # = K y

    # posterior: Joseph-exact triangularization for this gain with the
    # true (un-inflated) R
    Rc_true = state_mod.block_diag(_chol_nan(meas_cov + 1e-30 * eye2)) * mm
    Lp = _tria(torch.cat([(L - K @ HL).T, (K @ Rc_true).T], 0),
               "posterior")
    Lp = torch.where(ok, Lp, state.Sigma)

    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])
    klt_ref = torch.where(meas[:, None], measured_uv, state.klt_ref)
    return state.replace(base_mu=mu[:BASE_STATE_SIZE],
                         feat_mu=mu[BASE_STATE_SIZE:].reshape(n, 3),
                         Sigma=Lp, klt_ref=klt_ref)


def drop_features_factor(state: FilterState,
                         drop: torch.Tensor) -> FilterState:
    """Factor-space slot free: zero the dropped slots' ROWS of L.  Exact
    without a QR: with row r of L zero, Σ = LLᵀ has zero row and column r
    while every other entry keeps its value."""
    drop = drop & state.active
    keep = state_mod.slot_keep(drop, state.Sigma.dtype)
    return state.replace(active=state.active & ~drop,
                         Sigma=state.Sigma * keep[:, None])


def add_features_factor(state: FilterState, cfg: VIOConfig,
                        new_uv: torch.Tensor, valid: torch.Tensor,
                        depths: torch.Tensor | None = None,
                        depth_vars: torch.Tensor | None = None
                        ) -> FilterState:
    """Factor-space ``add_features``: the same slot assignment, means and
    bookkeeping as ``state.add_features``, with the Σ wipe and diagonal
    prior as one QR re-triangularization (``wipe_rows_factor``)."""
    n = state.n_max
    dtype, dev = state.Sigma.dtype, state.device
    take, src = state_mod.plan_insertion(state.active, valid)

    if depths is None:
        rho = torch.full((n, 1), 1.0 / cfg.default_point_depth,
                         dtype=state.feat_mu.dtype, device=dev)
    else:
        rho = (1.0 / torch.clamp(depths[src], 1e-3, 1e3))[:, None]
    uv_src = new_uv[src]
    feat_mu = torch.where(take[:, None], torch.cat([uv_src, rho], -1),
                          state.feat_mu)
    klt_ref = torch.where(take[:, None], uv_src, state.klt_ref)

    head = torch.zeros(BASE_STATE_SIZE, dtype=dtype, device=dev)
    wipe = torch.cat([head, take.repeat_interleave(3).to(dtype)])
    if depth_vars is None:
        dvar = torch.full((n,), cfg.default_point_depth_variance,
                          dtype=dtype, device=dev)
    else:
        dvar = torch.clamp(depth_vars[src], 1e-8,
                           cfg.default_point_depth_variance).to(dtype)
    hv = torch.full((n,), cfg.default_point_homogenous_variance,
                    dtype=dtype, device=dev)
    new_diag = torch.cat([head, torch.stack([hv, hv, dvar], -1).reshape(-1)])
    L = wipe_rows_factor(state.Sigma, wipe, new_diag)
    return state.replace(feat_mu=feat_mu, active=state.active | take,
                         klt_ref=klt_ref, Sigma=L,
                         age=torch.where(take, 0, state.age))


def predict_sqrt(state: FilterState, cfg: VIOConfig, dt) -> FilterState:
    """Dense-boundary square-root process step: factor on entry, one QR,
    square on exit."""
    return to_covariance(predict_sqrt_factor(to_factor(state), cfg, dt))


def update_sqrt(state: FilterState, cfg: VIOConfig, measured_uv, meas_cov,
                passed) -> FilterState:
    """Dense-boundary masked square-root measurement update, with the
    semantics of ``update.update_with_feature_positions``."""
    return to_covariance(update_sqrt_factor(to_factor(state), cfg,
                                            measured_uv, meas_cov, passed))
