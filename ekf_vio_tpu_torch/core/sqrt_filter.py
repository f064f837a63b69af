"""Square-root (Cholesky-factor) predict and update.

Port of ``ekf_vio_tpu/core/sqrt_filter.py``.  Both steps run in factor
space, so no cancellation-prone operation of the covariance form remains:

* predict:  Σ' = FΣFᵀ + Q   becomes   L' = tria([F L | √Q])
* update:   the QR array algorithm — one orthogonal triangularization of

      pre = [[√R,  H L],          postᵀ = qr(preᵀ)  ⇒  post = [[S^c, 0 ],
             [ 0,   L ]]                                       [ G,  L']]

  with S^c S^cᵀ = HΣHᵀ + R + λ and G = ΣHᵀ S^{-cᵀ}; the gain comes from
  that λ-damped factorization, and the posterior is Joseph-exact with the
  true R, [(I−KH)L | K·chol R], PSD by construction for any K.

With ``VIOConfig.square_root_form`` the engine's frame flow runs in
``FactorForm``, which keeps the LOWER CHOLESKY FACTOR ``L`` in
``FilterState.Sigma`` across steps: factored once at initialization
(``to_factor``) and never re-squared in the loop.

**The carried factor.**  Every change a step makes to Σ keeps Σ = F Fᵀ
exact for a non-square F (``[D, C]``): a transform multiplies F, new
noise appends columns, a wiped or freed slot zeroes rows, a prior
appends columns.  Every reader between two triangularizations reads rows
of F only (``uv_rows``, ``sigma_diag_factor``, the per-feature NIS), and
the update array needs no square factor either: the Gram matrix of
[[√R, H F], [0, F]] is the same for any F with F Fᵀ = Σ.  So the
``*_array`` functions return the state with F in the ``Sigma`` field,
and ``triangularize`` makes it square lower-triangular again:

* ``predict_sqrt_array``:   F' = [Φ F | √Q]
* ``propagate_imu_array``:  F' = [Φ F | T·chol Q29 | √q_feat]
* ``wipe_rows_array``:      F' = [P F | √v at the wiped rows]
* ``update_sqrt_array``:    one QR of the array above for S^c and G, then
  F' = [F − K H F | K·chol R] (or F and zero columns, if it failed)
* ``add_features_array``:   F' = [P F | the new slots' prior], one column
  a state row of a filled slot, compacted by the slot's rank
* ``drop_features_factor``: zeroes rows, of L or of F

``FactorForm`` carries F through a step of ``engine.step``, from the IMU
propagation (or the predict) through the depth re-prime, the update, the
drops, the lost reset and the slot add, and runs two QRs a frame: the
update array and one ``triangularize`` at the end of its ``add``, in
``vio.replenish`` (role ``close``).  The state at every step boundary is
square lower-triangular.  The public
``predict_sqrt_factor``, ``propagate_imu_factor``, ``update_sqrt_factor``,
``wipe_rows_factor``, ``add_features_factor`` and ``drop_features_factor``
keep square in, square out: each is its ``*_array`` function followed by
one QR.  Rows of exactly-zero variance (the anchored pose gauge, freed
slots) are zero rows of L throughout, so the pre-arrays are
rank-deficient by design: ``R`` of their QR is unique only up to what
those rows leave free, and LAPACK and cuSOLVER may differ there.
``L Lᵀ`` is what is defined, and what the tests compare.

``torch.linalg.qr(mode="r")``, ``cholesky_ex`` and ``solve_triangular``
are the library calls the JAX package leaves to XLA.  A failed Cholesky
becomes NaN (as ``jnp.linalg.cholesky`` returns it) through ``_chol_nan``,
with no host read, so the update's finiteness guard skips the update.
Callers keep TF32 off (``engine.use_f32_matmul``): ``F @ L`` and
``K @ HF`` need true f32.  ``predict_sqrt`` / ``update_sqrt`` are the
dense-boundary wrappers (factor on entry, square on exit).

Each triangularization runs in a span of the recorder
(``utils/profiling.py``), ``vio.tria.<role>``: in ``FactorForm``
``update`` (the array QR) and ``close`` (the step's factor made square);
in the public square-out functions ``imu``, ``predict``, ``posterior``
and ``wipe``.  The update counts ``skipped``: an update that a failed
factorization or a non-finite gain left as predicted.  With no recorder
on a span is a ``record_function`` range and the count computes nothing,
so a captured step gains no node.
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import dynamics
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import state as state_mod
from ekf_vio_tpu_torch.core.state import FilterState, rho_vec
from ekf_vio_tpu_torch.core.update import (innovation_nis,
                                           innovation_nis_per_feature)
from ekf_vio_tpu_torch.frontend import klt
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


def triangularize(state: FilterState, role: str) -> FilterState:
    """The carried factor F (``state.Sigma``, [D, C], Σ = F Fᵀ) made
    square lower-triangular by one QR of Fᵀ, in ``vio.tria.<role>``."""
    return state.replace(Sigma=_tria(state.Sigma.T, role))


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
    """diag(LLᵀ) without squaring: squared row norms (of L or of a carried
    F)."""
    return torch.sum(L * L, dim=1)


def wipe_rows_array(F: torch.Tensor, wipe: torch.Tensor,
                    new_diag: torch.Tensor,
                    rows: torch.Tensor | None = None) -> torch.Tensor:
    """Factor-space analog of zeroing Σ rows/cols ``wipe`` and setting
    their diagonal to ``new_diag``, on a carried factor F ([D, C]):
    [P F | E], E one column a row of ``rows`` (default: all D), √new_diag
    at the wiped ones and zero at the others.

    wipe: [D] bool or float row selector, nonzero only at ``rows``;
    new_diag: [D] variances, read at wiped rows only."""
    w = wipe.to(F.dtype)
    # a select, not a multiply: new_diag may carry NaN at rows that are
    # not wiped (a σ computed over every slot, dead ones included), and
    # NaN * 0 = NaN would reach the whole factor through the QR
    sd = torch.where(w > 0.0, torch.sqrt(torch.clamp(new_diag, min=0.0)),
                     0.0).to(F.dtype)
    if rows is None:
        E = torch.diag(sd)
    else:  # column j: sd at row rows[j]
        r = torch.arange(F.shape[0], device=F.device)
        E = torch.where(r[:, None] == rows[None, :], sd[rows][None, :], 0.0)
    return torch.cat([F * (1.0 - w)[:, None], E], 1)


def wipe_rows_factor(L: torch.Tensor, wipe: torch.Tensor,
                     new_diag: torch.Tensor) -> torch.Tensor:
    """``wipe_rows_array`` over every row, made square: one [2D, D] QR."""
    return _tria(wipe_rows_array(L, wipe, new_diag).T, "wipe")


def predict_sqrt_array(state: FilterState, cfg: VIOConfig,
                       dt) -> FilterState:
    """Factor-native process step on the carried factor: F' = [Φ F | √Q]."""
    dt = state_mod.device_scalar(dt, state.base_mu.dtype, state.device)
    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(state.base_mu,
                                                   state.feat_mu, dt)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    new_feat = dynamics.convolve_features(state.base_mu, state.feat_mu, dt)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(state.base_mu, dt)
    q_diag = dynamics.process_noise_diag(dt, state.n_max, state.active,
                                         cfg).to(state.Sigma.dtype)
    Phi = dynamics.build_dense_F(Fb, Ffb, Ff)
    A = torch.cat([Phi @ state.Sigma, torch.diag(torch.sqrt(q_diag))], 1)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=A,
                         t=state.t + dt)


def predict_sqrt_factor(state: FilterState, cfg: VIOConfig,
                        dt) -> FilterState:
    """Factor-native process step: L' = tria([Φ L | √Q])."""
    return triangularize(predict_sqrt_array(state, cfg, dt), "predict")


def propagate_imu_array(state: FilterState, cfg: VIOConfig,
                        batch: imu_mod.ImuSample, gravity_w, lin_base=None):
    """Factor-native compound IMU propagation (the sqrt form of
    ``imu.propagate_imu_batch_with_motion``) on the carried factor:

        F' = [ Φ F | T·chol(Q29) | √q_feat ]

    where T = [[I₂₂, 0], [0, Wm]] maps the 29-dim compound noise onto the
    state and √q_feat is one column a feature row (the base rows get no
    diagonal noise).  Returns (state', qt)."""
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

    # noise factor: Q_total = T Q29 Tᵀ with T = [[I, 0], [0, Wm]]
    jit29 = 1e-12 * torch.clamp(torch.max(torch.diagonal(Q29)), min=1e-30)
    C29 = _chol_nan(Q29 + jit29 * torch.eye(29, dtype=dtype, device=dev))
    Wm = W.reshape(3 * n, 7)
    TC = torch.cat([C29[:nb, :], Wm @ C29[nb:, :]], 0)        # [D, 29]
    Qf = torch.cat([torch.zeros(nb, 3 * n, dtype=dtype, device=dev),
                    torch.diag(torch.sqrt(q_feat.reshape(-1)))], 0)

    Phi = dynamics.build_dense_F(Fb, Ffb, Ff)
    A = torch.cat([Phi @ state.Sigma, TC, Qf], 1)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=A,
                         t=state.t + total_dt), qt


def propagate_imu_factor(state: FilterState, cfg: VIOConfig,
                         batch: imu_mod.ImuSample, gravity_w, lin_base=None):
    """``propagate_imu_array`` made square: one QR.  Returns (state', qt)."""
    state, qt = propagate_imu_array(state, cfg, batch, gravity_w,
                                    lin_base=lin_base)
    return triangularize(state, "imu"), qt


def update_sqrt_array(state: FilterState, cfg: VIOConfig,
                      measured_uv: torch.Tensor,  # [N_max, 2]
                      meas_cov: torch.Tensor,     # [N_max, 2, 2]
                      passed: torch.Tensor,       # [N_max] bool
                      ):
    """Factor-native masked QR-array measurement update on the carried
    factor F ([D, C]): one QR of the (2N + C) × (2N + D) array for S^c and
    G, then the Joseph posterior carried untriangularized, F' = [F − K H F
    | K·chol R] ([D, C + 2N]).  A failed factorization or a non-finite
    gain leaves the state as predicted, F' = [F | 0], and is counted as
    ``skipped``.  Returns (state', ok)."""
    n = state.n_max
    d = state.state_dim
    dtype, dev = state.Sigma.dtype, state.device

    meas = passed & state.active
    m = meas.repeat_interleave(2).to(dtype)               # [2N]
    mu = state.mu_flat()
    y = (measured_uv.reshape(-1) - state.feat_mu[:, :2].reshape(-1)) * m

    F = state.Sigma
    HF = state_mod.uv_rows(F) * m[:, None]                # [2N, C]

    # relative spectral floor, the covariance-form update's semantics:
    # λ = jitter + rel · max(diag S) added to R, as gain damping only
    r_diag = torch.diagonal(meas_cov, dim1=-2, dim2=-1).reshape(-1)
    s_diag = (torch.sum(HF * HF, dim=1) + r_diag) * m
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(s_diag)

    eye2 = torch.eye(2, dtype=meas_cov.dtype, device=dev)
    mm = m[:, None] * m[None, :]
    Rc = state_mod.block_diag(_chol_nan(meas_cov + (lam + 1e-30) * eye2))
    Rc = Rc * mm + torch.diag(1.0 - m)

    two_n = 2 * n
    pre_T = torch.cat([
        torch.cat([Rc.T, torch.zeros(two_n, d, dtype=dtype, device=dev)], 1),
        torch.cat([HF.T, F.T], 1)], 0)
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

    # posterior: Joseph-exact for this gain with the true (un-inflated) R
    Rc_true = state_mod.block_diag(_chol_nan(meas_cov + 1e-30 * eye2)) * mm
    Fp = torch.where(ok, torch.cat([F - K @ HF, K @ Rc_true], 1),
                     torch.nn.functional.pad(F, (0, two_n)))

    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])
    klt_ref = torch.where(meas[:, None], measured_uv, state.klt_ref)
    return state.replace(base_mu=mu[:BASE_STATE_SIZE],
                         feat_mu=mu[BASE_STATE_SIZE:].reshape(n, 3),
                         Sigma=Fp, klt_ref=klt_ref), ok


def update_sqrt_factor(state: FilterState, cfg: VIOConfig,
                       measured_uv: torch.Tensor,  # [N_max, 2]
                       meas_cov: torch.Tensor,     # [N_max, 2, 2]
                       passed: torch.Tensor,       # [N_max] bool
                       ) -> FilterState:
    """``update_sqrt_array`` with the posterior made square (state.Sigma
    holds L in and out); a skipped update returns L itself."""
    new, ok = update_sqrt_array(state, cfg, measured_uv, meas_cov, passed)
    return new.replace(Sigma=torch.where(
        ok, _tria(new.Sigma.T, "posterior"), state.Sigma))


def drop_features_factor(state: FilterState,
                         drop: torch.Tensor) -> FilterState:
    """Factor-space slot free: zero the dropped slots' ROWS of L (or of a
    carried F).  Exact without a QR: with row r zero, Σ = LLᵀ has zero row
    and column r while every other entry keeps its value."""
    drop = drop & state.active
    keep = state_mod.slot_keep(drop, state.Sigma.dtype)
    return state.replace(active=state.active & ~drop,
                         Sigma=state.Sigma * keep[:, None])


def add_features_array(state: FilterState, cfg: VIOConfig,
                       new_uv: torch.Tensor, valid: torch.Tensor,
                       depths: torch.Tensor | None = None,
                       depth_vars: torch.Tensor | None = None,
                       slots: int | None = None) -> FilterState:
    """Factor-space ``add_features`` on the carried factor: the same slot
    assignment, means and bookkeeping as ``state.add_features``, with the
    filled slots' rows of F zeroed and their diagonal prior appended as
    3·``slots`` columns (default: every slot), the slot of rank r among
    those filled in columns 3r..3r+2.  At most ``slots`` slots are filled;
    a caller that offers no more candidates than that loses none."""
    n = state.n_max
    k = n if slots is None else slots
    dtype, dev = state.Sigma.dtype, state.device
    take, src = state_mod.plan_insertion(state.active, valid)
    rank = torch.cumsum(take.to(torch.int32), 0) - 1
    take = take & (rank < k)

    if depths is None:
        rho = torch.full((n, 1), 1.0 / cfg.default_point_depth,
                         dtype=state.feat_mu.dtype, device=dev)
    else:
        rho = (1.0 / torch.clamp(depths[src], 1e-3, 1e3))[:, None]
    uv_src = new_uv[src]
    feat_mu = torch.where(take[:, None], torch.cat([uv_src, rho], -1),
                          state.feat_mu)
    klt_ref = torch.where(take[:, None], uv_src, state.klt_ref)

    if depth_vars is None:
        dvar = torch.full((n,), cfg.default_point_depth_variance,
                          dtype=dtype, device=dev)
    else:
        dvar = torch.clamp(depth_vars[src], 1e-8,
                           cfg.default_point_depth_variance).to(dtype)
    hv = torch.full((n,), cfg.default_point_homogenous_variance,
                    dtype=dtype, device=dev)
    sd = torch.sqrt(torch.stack([hv, hv, dvar], -1))            # [N, 3]
    # E[3s+i, 3r+j] = sd[s, i] where slot s is filled with rank r and
    # i = j: a select, so a NaN prior of a slot not filled stays out
    hit = ((take[:, None] & (rank[:, None] == torch.arange(
        k, dtype=rank.dtype, device=dev)[None, :]))[:, None, :, None]
        & torch.eye(3, dtype=torch.bool, device=dev)[None, :, None, :])
    E = torch.where(hit, sd[:, :, None, None], 0.0).reshape(3 * n, 3 * k)
    E = torch.cat([torch.zeros(BASE_STATE_SIZE, 3 * k, dtype=dtype,
                               device=dev), E], 0)
    keep = state_mod.slot_keep(take, dtype)
    return state.replace(feat_mu=feat_mu, active=state.active | take,
                         klt_ref=klt_ref,
                         Sigma=torch.cat([state.Sigma * keep[:, None], E], 1),
                         age=torch.where(take, 0, state.age))


def add_features_factor(state: FilterState, cfg: VIOConfig,
                        new_uv: torch.Tensor, valid: torch.Tensor,
                        depths: torch.Tensor | None = None,
                        depth_vars: torch.Tensor | None = None
                        ) -> FilterState:
    """``add_features_array`` over every slot, made square: one QR."""
    return triangularize(add_features_array(state, cfg, new_uv, valid,
                                            depths=depths,
                                            depth_vars=depth_vars), "wipe")


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


class FactorForm:
    """The frame flow's operations on Σ (``filter.CovarianceForm`` lists
    them) in factor form: ``Sigma`` holds L at a step's boundaries and the
    carried factor F within it (module docstring).  The depth re-prime
    wipes ρ rows of F, ``recovered_sigma`` pads diag(σ) to F's width, and
    ``add`` ends with the step's second QR (``vio.tria.close``)."""

    from_covariance = staticmethod(to_factor)
    predict = staticmethod(predict_sqrt_array)
    propagate_imu = staticmethod(propagate_imu_array)
    measurement_covariance = staticmethod(klt.measurement_covariance)
    drop = staticmethod(drop_features_factor)

    def gate_nis(self, filt, cfg, cam, measured_uv):
        return innovation_nis_per_feature(
            filt, measured_uv, klt.measurement_covariance_metric(
                cam.fx, cam.fy, cfg.max_features, cfg, device=filt.device),
            factor=True)

    def reprime_depths(self, filt, boot, sig_tri):
        n, dtype = filt.n_max, filt.Sigma.dtype
        rows = BASE_STATE_SIZE + 2 + 3 * torch.arange(n, device=filt.device)
        return filt.replace(Sigma=wipe_rows_array(
            filt.Sigma, rho_vec(boot.to(dtype), n),
            rho_vec((sig_tri * sig_tri).to(dtype), n), rows=rows))

    def update(self, filt, cfg, measured_uv, meas_cov, passed):
        nis = innovation_nis(filt, measured_uv, meas_cov, passed,
                             factor=True)
        return update_sqrt_array(filt, cfg, measured_uv, meas_cov,
                                 passed)[0], nis

    def add(self, filt, cfg, new_uv, valid, depths, depth_vars):
        # replenish offers at most num_features − #active candidates
        # (frontend/replenish.py; num_features <= max_features, config),
        # so the prior's columns compact to 3·num_features
        return triangularize(add_features_array(
            filt, cfg, new_uv, valid, depths=depths, depth_vars=depth_vars,
            slots=cfg.num_features), "close")

    def sigma_diag(self, filt):
        return sigma_diag_factor(filt.Sigma)

    def sigma_finite(self, filt):
        return torch.isfinite(sigma_diag_factor(filt.Sigma)).all()

    def recovered_sigma(self, filt, base_variances):
        sig_diag = torch.cat([base_variances, torch.zeros(
            3 * filt.n_max, dtype=filt.Sigma.dtype, device=filt.device)])
        return dict(Sigma=torch.nn.functional.pad(
            torch.diag(torch.sqrt(sig_diag)),
            (0, filt.Sigma.shape[1] - filt.state_dim)))

    def pos_cov(self, filt):
        L3 = filt.Sigma[:3, :]
        return L3 @ L3.T

    def covariance(self, filt):
        return filt.Sigma @ filt.Sigma.T


FACTOR = FactorForm()
