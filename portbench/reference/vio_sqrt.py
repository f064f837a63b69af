"""Plain reference of the step in square-root form: Σ carried as its lower
Cholesky factor L across frames.

Plain PyTorch, no kernels, no CUDA graph, no lane axis, and nothing
imported from the program under test.  It is written from what the
program's ``core/sqrt_filter.py`` says of the form in its docstring, not
from its code:

* the initialization's Σ factored once (``to_factor``): exactly-zero
  rows (the anchored pose, free slots) are zero rows of L;
* predict and IMU propagation: L' = tria([F L | noise factor | √q]);
* the update, the QR array algorithm: one triangularization of
  [[√R_λ, H L], [0, L]] gives S^c (S^c S^cᵀ = HΣHᵀ + R + λ) beside
  G = ΣHᵀ S^c⁻ᵀ; the gain is the λ-damped one, K = ΣHᵀ (S^c S^cᵀ)⁻¹;
  the posterior is the Joseph-exact L' = tria([(I − K H) L | K √R]) with
  the true R; a non-finite gain leaves the state as predicted;
* slot add and depth re-prime: one re-triangularization
  tria([P L | √v e_r]) of the rows ``r`` wiped to their new variance v;
  slot drop: the slot's rows of L zeroed.

``tria(A)`` is the lower factor T with T Tᵀ = A Aᵀ, from one QR of Aᵀ.
The front end, the IMU means and Jacobians, both initializations, the
measurement covariance and the recovery's choices are the frozen
covariance reference's (``vio.py``), imported, not copied.

Departures from that description, each on purpose:

* the IMU noise factor is built from the chain itself: each sample's noise
  Jacobian times √(its noise), carried to the interval's end by the later
  samples' transition Jacobians, side by side (29 × 12 per sample), so the
  compounded 29 × 29 noise is never factored and takes no jitter;
* the gain solves against S^c S^cᵀ with ΣHᵀ = L (H L)ᵀ (``cholesky_solve``)
  instead of G S^c⁻¹; the mean moves by K y;
* the 2 × 2 factors of R carry no 1e-30 floor, and R of a QR keeps the
  signs LAPACK or cuSOLVER give it (T Tᵀ does not depend on them).

L itself is not unique where a pre-array loses rank, so a comparison
reads Σ = L Lᵀ of both sides (``squared``), never L.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from portbench.reference import vio as ref
from portbench.reference.vio import NB, State, precision  # noqa: F401

NOISE = 12  # per IMU sample: gyro, accel, gyro bias walk, accel bias walk


def make_cfg(vio: dict):
    """The configuration as ``vio.make_cfg`` reads it, with the factor
    form, the one thing it refuses, required instead."""
    if not vio.get("square_root_form"):
        raise ValueError("the factor-form reference runs square_root_form "
                         "only; vio.py runs the covariance form")
    cfg = ref.make_cfg(dict(vio, square_root_form=False))
    cfg.square_root_form = True
    return cfg


# ---------------------------------------------------------------- factors

def tria(A):
    """Lower-triangular T with T Tᵀ = A Aᵀ (A: [D, M]), from the QR of Aᵀ."""
    return torch.linalg.qr(A.T, mode="r").R.T


def to_factor(Sigma):
    """Lower Cholesky factor of Σ, exactly-zero rows kept zero rows."""
    zero = torch.diagonal(Sigma) == 0.0
    L = torch.linalg.cholesky(Sigma + torch.diag(zero.to(Sigma.dtype)))
    return L * (~zero).to(L.dtype)[:, None]


def sigma_diag(L):
    """diag(L Lᵀ): the rows' squared norms."""
    return torch.sum(L * L, dim=1)


def squared(s: State) -> State:
    """The state with Σ = L Lᵀ, in float64: what a comparison reads."""
    L = s.Sigma.detach().to(torch.float64)
    return s.replace(Sigma=L @ L.T)


def from_program(estate) -> State:
    """A program state in factor form, its L kept as L."""
    return ref.from_program(estate)


def _dense_F(Fb, Ffb, Ff):
    n = Ff.shape[0]
    top = torch.cat([Fb, Fb.new_zeros(NB, 3 * n)], 1)
    bot = torch.cat([Ffb.reshape(3 * n, NB), ref._block_diag(Ff)], 1)
    return torch.cat([top, bot], 0)


def _wipe(L, rows, var):
    """Rows ``rows`` [D] bool of Σ (and their columns) wiped, their
    variance set to ``var`` [D]: tria([P L | diag(√var) on the rows])."""
    keep = (~rows).to(L.dtype)
    add = torch.diag(torch.where(rows, torch.sqrt(var.clamp(min=0.0)), 0.0))
    return tria(torch.cat([L * keep[:, None], add.to(L.dtype)], 1))


# ---------------------------------------------------------------- process

def predict(s: State, cfg, dt) -> State:
    """Vision-only process step, as ``vio.predict`` with L' = tria([F L |
    √Q])."""
    Fb = jacfwd(ref.convolve_base_state)(s.base_mu, dt)
    qt = ref.camera_motion_qt(s.base_mu, dt)
    Jqt = jacfwd(ref.camera_motion_qt)(s.base_mu, dt)
    _, Ff, W = ref.transport_jacobians(s.feat_mu, qt)
    Ffb, Ff = ref._mask_jacobians(W @ Jqt, Ff, s.active)
    new_feat = ref.convolve_features(s.base_mu, s.feat_mu, dt)
    kw = dict(dtype=torch.float32, device=s.active.device)
    base_q = torch.cat([torch.full((7,), cfg.q_pos, **kw),
                        torch.full((3,), cfg.q_vel, **kw),
                        torch.full((3,), cfg.q_omega, **kw),
                        torch.full((3,), cfg.q_accel, **kw),
                        torch.full((6,), cfg.q_bias, **kw)])
    feat_q = torch.where(s.active[:, None], cfg.q_feature, 0.0) * torch.ones(
        s.n, 3, **kw)
    q_diag = torch.cat([base_q, feat_q.reshape(-1)]) * dt
    L = tria(torch.cat([_dense_F(Fb, Ffb, Ff) @ s.Sigma,
                        torch.diag(torch.sqrt(q_diag))], 1))
    return s.replace(base_mu=ref.convolve_base_state(s.base_mu, dt),
                     feat_mu=torch.where(s.active[:, None], new_feat,
                                         s.feat_mu),
                     Sigma=L, t=s.t + dt)


def propagate_imu(s: State, cfg, dt, gyro, accel, gravity_w):
    """One camera interval of IMU samples as one factor propagation: the
    means and the first-estimate Jacobians of ``vio.propagate_imu``,
    then L' = tria([F L | T N | √q_feat]) with N [29, 12 K] the chain's
    noise factor (N Nᵀ = the compounded noise) and T = [[I, 0], [0, W]]
    its map onto the state.  Returns (state, the camera motion qt [7])."""
    dtype, dev = s.Sigma.dtype, dt.device
    tail = ref._const([1.0] + [0.0] * 6, s.base_mu)
    x0 = torch.cat([s.base_mu, tail])
    x0_lin = torch.cat([s.lin_base.to(dtype), tail])
    xf, xs = ref.mean_chain(torch.stack([x0, x0_lin]), dt, gyro, accel,
                            gravity_w)
    x, x_lin, xs_lin = xf[0], xf[1], xs[1]
    k = dt.shape[0]
    xn = torch.cat([xs_lin, torch.zeros(k, NOISE, dtype=dtype, device=dev)],
                   -1)
    JG = ref._jac29_xn(xn, gyro, accel, dt, gravity_w)
    ok = dt > 0
    eye = torch.eye(29, dtype=dtype, device=dev)
    Ji = torch.where(ok[:, None, None], JG[:, :, :29], eye)
    # G_k diag(√q_k), q_k = psd / dt_k; zero for a padding sample
    root_q = torch.sqrt(ref._imu_psd(cfg, s.base_mu)[None, :]
                        / torch.clamp(dt, min=1e-6)[:, None])
    Gi = JG[:, :, 29:] * torch.where(ok[:, None], root_q, 0.0)[:, None, :]
    # each sample's noise carried to the end by the later transitions
    P, cols = eye, []
    for i in reversed(range(k)):
        cols.append(P @ Gi[i])
        P = P @ Ji[i]
    J, N = P, torch.cat(cols[::-1], 1)                     # [29, 29], [29, 12K]

    base_mu, qt, qt_lin, total_dt = x[0:NB], x[22:29], x_lin[22:29], dt.sum()
    n = s.n
    z = 1.0 / s.feat_mu[:, 2]
    p = torch.stack([s.feat_mu[:, 0] * z, s.feat_mu[:, 1] * z, z], -1)
    p = ref.quat_rotate(qt[0:4], p) + qt[4:7]
    new_feat = torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2],
                            1.0 / p[:, 2]], -1)
    _, Ff, W = ref.transport_jacobians(s.feat_mu, qt_lin)
    Ffb = torch.einsum("nij,jb->nib", W, J[NB:, :NB])
    Ffb, Ff = ref._mask_jacobians(Ffb, Ff, s.active)
    W = torch.where(s.active[:, None, None], W, 0.0)
    q_feat = torch.where(s.active[:, None], cfg.q_feature, 0.0) * torch.ones(
        n, 3, dtype=dtype, device=dev) * total_dt
    q_diag = torch.cat([torch.zeros(NB, dtype=dtype, device=dev),
                        q_feat.reshape(-1)])
    TN = torch.cat([N[:NB], W.reshape(3 * n, 7) @ N[NB:]], 0)   # [D, 12K]
    L = tria(torch.cat([_dense_F(J[:NB, :NB], Ffb, Ff) @ s.Sigma, TN,
                        torch.diag(torch.sqrt(q_diag))], 1))
    feat_mu = torch.where(s.active[:, None], new_feat, s.feat_mu)
    return s.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=L,
                     t=s.t + total_dt), qt


# ---------------------------------------------------------------- update

def _chol2(B):
    """Lower factors of 2 × 2 blocks [N, 2, 2]; NaN where one fails."""
    C, info = torch.linalg.cholesky_ex(B)
    return torch.where((info == 0)[:, None, None], C, torch.nan)


def update(s: State, cfg, measured_uv, meas_cov, passed) -> State:
    """Masked QR-array update (``s.Sigma`` holds L in and out)."""
    n, dtype, dev = s.n, s.Sigma.dtype, s.Sigma.device
    L = s.Sigma
    meas = passed & s.active
    m = meas.repeat_interleave(2).to(dtype)
    mu = torch.cat([s.base_mu, s.feat_mu.reshape(-1)])
    y = (measured_uv.reshape(-1) - s.feat_mu[:, :2].reshape(-1)) * m
    HL = ref._uv_rows(L) * m[:, None]                          # [2N, D]
    r = torch.diagonal(meas_cov, dim1=-2, dim2=-1).reshape(-1)
    lam = cfg.sigma_jitter + cfg.sigma_jitter_rel * torch.max(
        (torch.sum(HL * HL, 1) + r) * m)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    mm = m[:, None] * m[None, :]
    # unmeasured rows: a unit innovation factor, no gain
    R_lam = ref._block_diag(_chol2(meas_cov + lam * eye2)) * mm \
        + torch.diag(1.0 - m)
    two_n = 2 * n
    pre = torch.cat([torch.cat([R_lam, HL], 1),
                     torch.cat([torch.zeros(L.shape[0], two_n, dtype=dtype,
                                            device=dev), L], 1)], 0)
    Sc = tria(pre)[:two_n, :two_n]                 # S^c S^cᵀ = HΣHᵀ + R + λ
    K = torch.cholesky_solve(HL @ L.T, Sc).T       # ΣHᵀ (HΣHᵀ + R + λ)⁻¹
    ok = torch.isfinite(K).all()
    K = torch.where(ok, K, 0.0)
    mu = mu + K @ y
    R_true = ref._block_diag(_chol2(meas_cov)) * mm
    post = tria(torch.cat([L - K @ HL, K @ R_true], 1))
    quat = mu[3:7] / torch.linalg.vector_norm(mu[3:7])
    mu = torch.cat([mu[:3], quat, mu[7:]])
    return s.replace(base_mu=mu[:NB], feat_mu=mu[NB:].reshape(n, 3),
                     Sigma=torch.where(ok, post, L),
                     klt_ref=torch.where(meas[:, None], measured_uv,
                                         s.klt_ref))


# ---------------------------------------------------------------- slots

def add_features(s: State, cfg, new_uv, valid) -> State:
    """``vio.add_features`` with the wipe and the prior as one
    re-triangularization."""
    n, dtype = s.n, s.Sigma.dtype
    take, src = ref._plan_insertion(s.active, valid)
    rho = torch.full((n, 1), 1.0 / cfg.default_point_depth, dtype=dtype,
                     device=s.Sigma.device)
    uv_src = new_uv[src]
    feat_mu = torch.where(take[:, None], torch.cat([uv_src, rho], -1),
                          s.feat_mu)
    rows = 1.0 - ref._slot_keep(take, dtype)
    prior = torch.tensor([cfg.default_point_homogenous_variance] * 2
                         + [cfg.default_point_depth_variance], dtype=dtype,
                         device=s.Sigma.device).repeat(n)
    var = torch.cat([torch.zeros(NB, dtype=dtype, device=s.Sigma.device),
                     prior])
    return s.replace(feat_mu=feat_mu, active=s.active | take,
                     klt_ref=torch.where(take[:, None], uv_src, s.klt_ref),
                     Sigma=_wipe(s.Sigma, rows > 0, var),
                     age=torch.where(take, 0, s.age))


def drop_features(s: State, drop) -> State:
    """Free the dropped slots: their rows of L zeroed."""
    drop = drop & s.active
    keep = ref._slot_keep(drop, s.Sigma.dtype)
    return s.replace(active=s.active & ~drop, Sigma=s.Sigma * keep[:, None])


def depth_bootstrap(s: State, cfg, cam, measured_uv, passed, qt) -> State:
    """``vio.depth_bootstrap``'s choice of the features to re-prime (young,
    tracked, triangulated against the exact IMU motion, disagreeing with
    their estimate); their ρ rows wiped to the triangulation's variance by
    one re-triangularization."""
    z_new, tri_ok, rel_sig = ref.triangulate(
        s.klt_ref, measured_uv, ref.quat_to_matrix(qt[0:4]), qt[4:7],
        cfg.default_point_depth)
    rho_new = 1.0 / z_new
    sigma_ang = cfg.klt_measurement_variance_px ** 0.5 * 2.0 / (
        cam["fx"] + cam["fy"])
    good = sigma_ang * rel_sig < cfg.triangulation_max_rel_error
    rel = torch.clamp(2.0 * sigma_ang * rel_sig,
                      min=cfg.bootstrap_depth_sigma_rel)
    sig_tri = rel * rho_new
    rho_old = s.feat_mu[:, 2]
    boot = ((s.age <= cfg.bootstrap_max_age) & tri_ok & good & passed
            & s.active & (torch.abs(rho_new - rho_old) > sig_tri))
    rho = torch.where(boot, rho_new, rho_old)
    dtype = s.Sigma.dtype
    rows = ref._rho_vec(boot.to(dtype), s.n) > 0
    var = ref._rho_vec((sig_tri * sig_tri).to(dtype), s.n)
    return s.replace(feat_mu=torch.cat([s.feat_mu[:, :2], rho[:, None]], 1),
                     Sigma=_wipe(s.Sigma, rows, var))


def _recover(s: State, cfg, lost) -> State:
    """``vio._recover``'s choices, its diagonal Σ given as its own factor
    diag(σ)."""
    r = ref._recover(s.replace(Sigma=torch.diag(sigma_diag(s.Sigma))), cfg,
                     lost)
    return r.replace(Sigma=torch.where(lost, torch.sqrt(r.Sigma), s.Sigma))


# ------------------------------------------------------------------ step

def step(s: State, img, t, cfg, cam, imu=None, gravity_w=None):
    """``vio.step`` in factor form: predict or IMU propagation, LK seeded
    at the predicted positions, kill box, depth bootstrap (IMU), update,
    drop of failed features, recovery, FAST replenishment.  Returns
    (state with L, outputs dict in covariance terms, as the program's)."""
    dev = s.Sigma.device
    img = img.to(device=dev, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    s = s.replace(age=torch.where(s.active, s.age + 1, 0))
    dt = torch.clamp(t - s.t, min=0.0)
    qt = None
    if imu is not None:
        idt, gyro, accel = (x.to(dev) for x in imu)
        rem = torch.clamp(t - (s.t + idt.sum()), min=0.0)
        s, qt = propagate_imu(s, cfg, *ref._with_remainder(idt, gyro, accel,
                                                           rem),
                              gravity_w.to(dev))
    else:
        s = predict(s, cfg, dt)
    s = s.replace(t=t)
    lin_base = s.base_mu

    cur_pyr = ref.build_pyramid(img, cfg.klt_max_pyramid_level)
    prev_px = ref.metric_to_pixel(cam, s.klt_ref)
    seed_px = ref.metric_to_pixel(cam, s.feat_mu[:, :2])
    pts, status, _ = ref.track(s.prev_pyr, cur_pyr, prev_px, seed_px,
                               s.active, cfg)
    passed = status & ref.in_kill_box(cam, pts, cfg.kill_pad)
    measured = ref.pixel_to_metric(cam, pts)
    if imu is not None and cfg.triangulate_new_features:
        s = depth_bootstrap(s, cfg, cam, measured, passed, qt)

    meas_cov = ref.measurement_cov(cam, s.n, cfg, dev)
    meas = passed & s.active
    cnt = torch.clamp(meas.sum(), min=1)
    mag = torch.linalg.vector_norm(measured - s.feat_mu[:, :2], dim=-1)
    innov = torch.sum(torch.where(meas, mag, 0.0)) / cnt
    nis_f = ref._nis_per_feature(s.replace(Sigma=s.Sigma @ s.Sigma.T),
                                 measured, meas_cov)
    nis = torch.sum(torch.where(meas, nis_f, 0.0)) / cnt
    prior_var = sigma_diag(s.Sigma)
    s = update(s, cfg, measured, meas_cov, passed)
    num_tracked = torch.sum(passed & s.active, dtype=torch.int32)
    s = drop_features(s, s.active & ~passed)
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(s.base_mu).all()
            | ~torch.isfinite(sigma_diag(s.Sigma)).all())
    if cfg.recover_on_tracking_lost:
        s = _recover(s, cfg, lost)
        lin_base = torch.where(lost, s.base_mu, lin_base)

    feat_px = ref.metric_to_pixel(cam, s.feat_mu[:, :2])
    cand_px, cand_valid = ref.replenish(img, feat_px, s.active, cfg, s.n)
    s = add_features(s, cfg, ref.pixel_to_metric(cam, cand_px), cand_valid)
    L3 = s.Sigma[:3]
    out = {"base_mu": s.base_mu, "num_tracked": num_tracked,
           "num_active": s.active.sum(dtype=torch.int32),
           "mean_innovation": innov,
           "pose_cov_diag": sigma_diag(s.Sigma)[:7],
           "tracking_lost": lost, "pos_cov": L3 @ L3.T, "mean_nis": nis,
           "prior_var": prior_var}
    return s.replace(prev_pyr=cur_pyr, lin_base=lin_base), out


# -------------------------------------------------------- initialization

def initialize(img, t, cfg, cam) -> State:
    """``vio.initialize``, its Σ factored."""
    s = ref.initialize(img, t, cfg, cam)
    return s.replace(Sigma=to_factor(s.Sigma))


def initialize_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                   cfg, cam, k) -> State:
    """``vio.initialize_imu``, its Σ factored."""
    s = ref.initialize_imu(images, times, imu_dt, imu_gyro, imu_accel,
                           gravity_w, cfg, cam, k)
    return s.replace(Sigma=to_factor(s.Sigma))
