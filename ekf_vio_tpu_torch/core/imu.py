"""IMU-driven state propagation in the same 22-state layout.

Port of ``ekf_vio_tpu/core/imu.py`` (the compound-interval path): the gyro
and accelerometer samples act as controls through the bias states,

    ω = ω_m − b_g,    a_body = (a_m − b_a) + R(q)ᵀ g_w,

substituted into the reference kinematics.  A camera interval's K samples
become one 29-dim system x = [base(22), qc(4), tc(3)] whose mean chain is
closed-form prefix products and sums (``_mean_chain``), whose per-sample
transition and noise Jacobians come from ONE ``torch.func.vmap(jacfwd)``
over [x | n] (``_jac29_xn``), and whose (J, Q) pairs compound by a
pairwise tree (``_compose_chain_tree``).  The interval then costs one
dense Σ ← FΣFᵀ + Q (``propagate_imu_batch_with_motion``).  Callers keep
TF32 off, as the JAX package pins these paths to f32 matmuls.

``propagate_imu_step`` / ``propagate_imu_batch_steps`` are the
sequential reference the compound path is held against: one exact
``torch.func.jacfwd`` F and G per sample and one [D, D] covariance
product per sample, the samples in a Python loop.

The cumulative quaternion product (``jax.lax.associative_scan`` in the
JAX package) is a log-depth doubling of batched ``quat_mul``; its
association order differs, so parity holds at f32 roundoff.  The known
reference defects are reproduced: a full-interval dropout replays the
padding row (``extend_batch_with_remainder``), and ``_mean_chain`` forms
its exclusive prefixes by subtraction.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import dynamics, lie
from ekf_vio_tpu_torch.core.state import FilterState, device_constant


class ImuSample(NamedTuple):
    dt: torch.Tensor      # [K] seconds since the previous sample
    gyro: torch.Tensor    # [K, 3] rad/s
    accel: torch.Tensor   # [K, 3] m/s² (specific force)


def substitute_imu_controls(base_mu, gyro_m, accel_m, gravity_w):
    """Replace the ω and a states with their IMU-derived values."""
    q = base_mu[..., 3:7]
    omega = gyro_m - base_mu[..., 19:22]
    a_body = ((accel_m - base_mu[..., 16:19])
              + lie.quat_rotate(lie.quat_conj(q), gravity_w))
    return torch.cat([base_mu[..., :10], omega, a_body, base_mu[..., 16:]],
                     -1)


def convolve_base_imu(base_mu, gyro_m, accel_m, dt, gravity_w):
    """One strapdown step of the base state under IMU controls."""
    mu2 = substitute_imu_controls(base_mu, gyro_m, accel_m, gravity_w)
    return dynamics.convolve_base_state(mu2, dt)


def _f_with_noise(base_mu, gyro_m, accel_m, noise, dt, gravity_w):
    """One strapdown step with additive noise inputs (for G = ∂f/∂n):
    n = [n_g(3), n_a(3), n_bg(3), n_ba(3)], measurement white noise and
    bias random walks."""
    n_g, n_a, n_bg, n_ba = noise[0:3], noise[3:6], noise[6:9], noise[9:12]
    mu = torch.cat([base_mu[:16], base_mu[16:19] + n_ba * dt,
                    base_mu[19:22] + n_bg * dt])
    return convolve_base_imu(mu, gyro_m + n_g, accel_m + n_a, dt, gravity_w)


_jac_base_imu = jacfwd(convolve_base_imu, argnums=0)
_jac_noise = jacfwd(_f_with_noise, argnums=3)


def imu_noise_psd(cfg: VIOConfig, device=None) -> torch.Tensor:
    """Diagonal continuous-time noise PSD for n = [n_g, n_a, n_bg, n_ba]."""
    return device_constant(
        [cfg.imu_gyro_noise ** 2] * 3 + [cfg.imu_accel_noise ** 2] * 3
        + [cfg.imu_gyro_bias_walk ** 2] * 3
        + [cfg.imu_accel_bias_walk ** 2] * 3, device=device)


def extend_batch_with_remainder(batch: ImuSample, rem) -> ImuSample:
    """Append one zero-order-hold sample covering ``rem`` seconds of the
    camera interval not spanned by IMU data: the last valid sample's
    gyro/accel held over the gap.  With rem = 0 (or ≤ 1e-6) the row is
    dt = 0 padding, an exact no-op of the compound propagation."""
    k = batch.dt.shape[0]
    ar = torch.arange(k, device=batch.dt.device)
    idx = torch.clamp(torch.max(torch.where(batch.dt > 0, ar, -1)), min=0)
    rem = torch.as_tensor(rem, dtype=batch.dt.dtype, device=batch.dt.device)
    rem = torch.where(rem > 1e-6, rem, 0.0).reshape(1)
    pick = idx.reshape(1)
    return ImuSample(
        dt=torch.cat([batch.dt, rem]),
        gyro=torch.cat([batch.gyro, batch.gyro.index_select(0, pick)]),
        accel=torch.cat([batch.accel, batch.accel.index_select(0, pick)]))


def propagate_imu_step(state: FilterState, cfg: VIOConfig, sample: ImuSample,
                       gravity_w) -> FilterState:
    """One IMU sample: exact F and G, Σ ← FΣFᵀ + GQGᵀ (+ feature noise).

    Features move with the IMU-substituted kinematics; their Jacobian
    blocks reach the original state (biases included) through the
    substitution."""
    dt = sample.dt
    dtype, dev = state.Sigma.dtype, state.device
    mu_sub = substitute_imu_controls(state.base_mu, sample.gyro,
                                     sample.accel, gravity_w)
    Fb = _jac_base_imu(state.base_mu, sample.gyro, sample.accel, dt,
                       gravity_w)

    def feat_transport(b_mu, f_mu):
        return dynamics.convolve_feature(
            substitute_imu_controls(b_mu, sample.gyro, sample.accel,
                                    gravity_w), f_mu, dt)

    Ffb = vmap(jacfwd(feat_transport, argnums=0), in_dims=(None, 0))(
        state.base_mu, state.feat_mu)                      # [N, 3, 22]
    Ff = vmap(jacfwd(feat_transport, argnums=1), in_dims=(None, 0))(
        state.base_mu, state.feat_mu)                      # [N, 3, 3]
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)

    G = _jac_noise(state.base_mu, sample.gyro, sample.accel,
                   torch.zeros(12, dtype=dtype, device=dev), dt, gravity_w)
    Qn = torch.diag(imu_noise_psd(cfg, dev).to(dtype)
                    / torch.clamp(dt, min=1e-6))
    GQG = G @ Qn @ G.T                                     # [22, 22]

    q_feat = torch.where(state.active[:, None], cfg.q_feature, 0.0) \
        * torch.ones(state.n_max, 3, dtype=dtype, device=dev) * dt
    q_diag = torch.cat([torch.zeros(BASE_STATE_SIZE, dtype=dtype,
                                    device=dev), q_feat.reshape(-1)])
    Sigma = dynamics.propagate_covariance(state.Sigma, Fb, Ffb, Ff, q_diag)
    nb = BASE_STATE_SIZE
    Sigma = Sigma + torch.nn.functional.pad(
        GQG, (0, Sigma.shape[1] - nb, 0, Sigma.shape[0] - nb))
    Sigma = 0.5 * (Sigma + Sigma.T)

    new_feat = dynamics.convolve_features(mu_sub, state.feat_mu, dt)
    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    base_mu = dynamics.convolve_base_state(mu_sub, dt)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                         t=state.t + dt)


def propagate_imu_batch_steps(state: FilterState, cfg: VIOConfig,
                              batch: ImuSample, gravity_w) -> FilterState:
    """The sequential reference: ``propagate_imu_step`` per sample, one
    [D, D] covariance product each; rows with dt <= 0 keep the state
    (``torch.where``, no host read)."""
    for i in range(batch.dt.shape[0]):
        smp = ImuSample(batch.dt[i], batch.gyro[i], batch.accel[i])
        s2 = propagate_imu_step(state, cfg, smp, gravity_w)
        ok = smp.dt > 0
        state = FilterState(**{
            f.name: torch.where(ok, getattr(s2, f.name),
                                getattr(state, f.name))
            for f in dataclasses.fields(FilterState)})
    return state


# --------------------------------------------------------------------------
# Compound propagation: one [D, D] covariance product per camera frame.
# --------------------------------------------------------------------------


def _motion_step29(x29, gyro_m, accel_m, noise, dt, gravity_w):
    """One IMU sample of the [base, qc, tc] system with noise inputs
    n = [n_g, n_a, n_bg, n_ba]."""
    base, qc, tc = x29[0:22], x29[22:26], x29[26:29]
    n_g, n_a, n_bg, n_ba = noise[0:3], noise[3:6], noise[6:9], noise[9:12]
    base = torch.cat([base[:16], base[16:19] + n_ba * dt,
                      base[19:22] + n_bg * dt])
    mu_sub = substitute_imu_controls(base, gyro_m + n_g, accel_m + n_a,
                                     gravity_w)
    vel, omega, acc = mu_sub[7:10], mu_sub[10:13], mu_sub[13:16]
    dq_inv = lie.quat_conj(lie.quat_exp_omega(omega, dt))
    d = dt * vel + 0.5 * dt * dt * acc
    qc2 = lie.quat_mul(dq_inv, qc)            # compound: T_i ∘ T_{1..i-1}
    tc2 = lie.quat_rotate(dq_inv, tc - d)
    base2 = dynamics.convolve_base_state(mu_sub, dt)
    return torch.cat([base2, qc2, tc2])


def _step29_xn(xn, gyro_m, accel_m, dt, gravity_w):
    return _motion_step29(xn[:29], gyro_m, accel_m, xn[29:], dt, gravity_w)


# J and G of every sample from ONE forward-mode pass over [x | n] (41
# tangents), batched over the interval's K samples
_jac29_xn = vmap(jacfwd(_step29_xn), in_dims=(0, 0, 0, 0, None))


def compound_transport(feat_mu: torch.Tensor, qt: torch.Tensor):
    """Transport [N, 3] features [u, v, ρ] by the compound motion
    qt = [qc(4), tc(3)]."""
    z = 1.0 / feat_mu[:, 2]
    p = torch.stack([feat_mu[:, 0] * z, feat_mu[:, 1] * z, z], -1)
    p = lie.quat_rotate(qt[0:4], p) + qt[4:7]
    return torch.stack([p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], 1.0 / p[:, 2]],
                       -1)


def _compose_chain_tree(Ji: torch.Tensor, Qi: torch.Tensor):
    """Compound a chain of (J, Q) transport pairs (sample 0 first) by a
    pairwise reduction tree: (J_{K-1}···J_0, Q) in log₂K levels."""
    while Ji.shape[0] > 1:
        k = Ji.shape[0]
        even = k - (k % 2)
        Ja, Qa = Ji[0:even:2], Qi[0:even:2]     # earlier of each pair
        Jb, Qb = Ji[1:even:2], Qi[1:even:2]     # later of each pair
        Jc = torch.einsum("kij,kjl->kil", Jb, Ja)
        Qc = torch.einsum("kij,kjl,kml->kim", Jb, Qa, Jb) + Qb
        if k % 2:
            Jc = torch.cat([Jc, Ji[-1:]], 0)
            Qc = torch.cat([Qc, Qi[-1:]], 0)
        Ji, Qi = Jc, Qc
    return Ji[0], Qi[0]


def _cumulative_quat_mul(dq: torch.Tensor) -> torch.Tensor:
    """c_i = dq_0 ⊗ … ⊗ dq_i along dim -2 (log-depth doubling)."""
    k = dq.shape[-2]
    c = dq
    s = 1
    while s < k:
        c = torch.cat([c[..., :s, :], lie.quat_mul(c[..., :-s, :],
                                                   c[..., s:, :])], -2)
        s *= 2
    return c


def _mean_chain(x0: torch.Tensor, batch: ImuSample, gravity_w):
    """Closed-form mean integration of the 29-dim [base, qc, tc] system
    over an interval, for L chains at once.

    x0: [L, 29].  Returns (x_final [L, 29], xs [L, K, 29]) with xs_j the
    state BEFORE sample j.  With w_i = R(q_i) v_i and A_i = R(q_i)(a_i −
    b_a) + g_w the body-frame recursions collapse to prefix products and
    sums; zero-dt rows are exact no-ops."""
    dt = batch.dt                                     # [K]
    k = dt.shape[0]
    n_l = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    p0, q0, v0 = x0[:, None, 0:3], x0[:, None, 3:7], x0[:, None, 7:10]
    b_a, b_g = x0[:, None, 16:19], x0[:, None, 19:22]
    dtc = dt[:, None]                                 # [K, 1]

    omega = batch.gyro - b_g                          # [L, K, 3]
    dq = lie.quat_exp_omega(omega, dtc)               # [L, K, 4]
    c = _cumulative_quat_mul(dq)
    ident = device_constant([1.0, 0.0, 0.0, 0.0], dtype, dev)
    c_excl = torch.cat([ident.expand(n_l, 1, 4), c[:, :-1]], 1)
    q_pre = lie.quat_mul(q0, c_excl)                  # [L, K, 4]
    q_pre_inv = lie.quat_conj(q_pre)

    A = lie.quat_rotate(q_pre, batch.accel - b_a) + gravity_w
    dv = dtc * A
    w0 = lie.quat_rotate(q0, v0)                      # [L, 1, 3]
    w_pre = w0 + torch.cumsum(dv, 1) - dv             # exclusive prefix
    D = dtc * w_pre + 0.5 * (dt * dt)[:, None] * A
    p_pre = p0 + torch.cumsum(D, 1) - D

    v_pre = lie.quat_rotate(q_pre_inv, w_pre)
    qc_pre = lie.quat_conj(c_excl)
    tc_pre = lie.quat_rotate(q_pre_inv, p0 - p_pre)
    # ω/a slots of the PRE states are overwritten by the control
    # substitution before any use: carry x0's slots through
    rest = x0[:, None, 10:22].expand(n_l, k, 12)
    xs = torch.cat([p_pre, q_pre, v_pre, rest, qc_pre, tc_pre], -1)

    c_last = c[:, -1]
    q_fin = lie.quat_mul(q0[:, 0], c_last)
    q_fin_inv = lie.quat_conj(q_fin)
    w_fin = w0[:, 0] + torch.sum(dv, 1)
    p_fin = p0[:, 0] + torch.sum(D, 1)
    v_fin = lie.quat_rotate(q_fin_inv, w_fin)
    qc_fin = lie.quat_conj(c_last)
    tc_fin = lie.quat_rotate(q_fin_inv, p0[:, 0] - p_fin)

    # ω/a slots after the interval: the last valid sample's substituted
    # rate and its dq⁻¹-transported acceleration; an all-padding interval
    # keeps x0's slots
    ar = torch.arange(k, device=dev)
    last = torch.max(torch.where(dt > 0, ar, -1))
    has = last >= 0
    idx = torch.clamp(last, min=0).reshape(1)
    a_pre = (batch.accel - b_a
             + lie.quat_rotate(q_pre_inv, gravity_w.expand(n_l, k, 3)))
    a_post = lie.quat_rotate(lie.quat_conj(dq), a_pre)
    om_fin = torch.where(has, omega.index_select(1, idx)[:, 0], x0[:, 10:13])
    ac_fin = torch.where(has, a_post.index_select(1, idx)[:, 0],
                         x0[:, 13:16])

    x_fin = torch.cat([p_fin, q_fin, v_fin, om_fin, ac_fin, x0[:, 16:22],
                       qc_fin, tc_fin], -1)
    return x_fin, xs


def compound_interval(base_mu, cfg: VIOConfig, batch: ImuSample, gravity_w,
                      lin_base=None):
    """Integrate the 29-dim [base, qc, tc] system over the interval and
    compound the per-sample (J, Q) transport pairs.

    Returns (base_mu', qt, qt_lin, J [29,29], Q29 [29,29], total_dt) where
    qt_lin is the compound motion of the FEJ linearization chain (== qt
    when ``lin_base`` is None)."""
    dtype, dev = base_mu.dtype, base_mu.device
    psd = imu_noise_psd(cfg, dev).to(dtype)
    tail = device_constant([1.0] + [0.0] * 6, dtype, dev)
    x0 = torch.cat([base_mu, tail])
    k = batch.dt.shape[0]
    if lin_base is None:
        xf, xs = _mean_chain(x0[None], batch, gravity_w)
        x = x_lin = xf[0]
        xs_lin = xs[0]
    else:
        x0_lin = torch.cat([lin_base.to(dtype), tail])
        xf, xs = _mean_chain(torch.stack([x0, x0_lin]), batch, gravity_w)
        x, x_lin = xf[0], xf[1]
        xs_lin = xs[1]

    xn = torch.cat([xs_lin, torch.zeros(k, 12, dtype=dtype, device=dev)], -1)
    JG = _jac29_xn(xn, batch.gyro, batch.accel, batch.dt, gravity_w)
    Ji, Gi = JG[:, :, :29], JG[:, :, 29:]                 # [K, 29, 29|12]
    qn = psd[None, :] / torch.clamp(batch.dt, min=1e-6)[:, None]
    GQG = torch.einsum("kij,kj,klj->kil", Gi, qn, Gi)
    ok = (batch.dt > 0)[:, None, None]
    Ji = torch.where(ok, Ji, torch.eye(29, dtype=dtype, device=dev))
    GQG = torch.where(ok, GQG, 0.0)
    J, Q29 = _compose_chain_tree(Ji, GQG)
    return x[0:22], x[22:29], x_lin[22:29], J, Q29, torch.sum(batch.dt)


def propagate_imu_batch_with_motion(state: FilterState, cfg: VIOConfig,
                                    batch: ImuSample, gravity_w,
                                    lin_base=None):
    """Propagate a camera interval's IMU samples ([K] leading dim; zero-dt
    rows are no-ops) with ONE covariance propagation, and return the
    compound camera motion qt = [qc(4), tc(3)] (p_cur = R(qc) p_prev + tc).

    With ``lin_base`` (first-estimate Jacobians) the transition Jacobians
    and the feature-transport Jacobians are evaluated along the chain from
    ``lin_base``; the mean always uses the posterior ``state.base_mu``."""
    nb = BASE_STATE_SIZE
    n = state.n_max
    dtype = state.Sigma.dtype
    base_mu, qt, qt_lin, J, Q29, total_dt = compound_interval(
        state.base_mu, cfg, batch, gravity_w, lin_base=lin_base)

    Fb = J[:nb, :nb]
    new_feat = compound_transport(state.feat_mu, qt)
    _, Ff, W = dynamics.transport_jacobians(state.feat_mu, qt_lin)
    Ffb = torch.einsum("nij,jb->nib", W, J[nb:, :nb])      # [N, 3, 22]
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, state.active)
    W = torch.where(state.active[:, None, None], W, 0.0)

    q_feat = torch.where(state.active[:, None], cfg.q_feature, 0.0) \
        * torch.ones(n, 3, dtype=dtype, device=state.device) * total_dt
    q_diag = torch.cat([torch.zeros(nb, dtype=dtype, device=state.device),
                        q_feat.reshape(-1)])
    Sigma = dynamics.propagate_covariance(state.Sigma, Fb, Ffb, Ff, q_diag)

    # accumulated IMU noise: base block, rank-7 feature block and cross
    Wm = W.reshape(3 * n, 7)
    Qbf = Q29[:nb, nb:] @ Wm.T                             # [22, 3N]
    Qn = torch.cat([torch.cat([Q29[:nb, :nb], Qbf], 1),
                    torch.cat([Qbf.T, Wm @ Q29[nb:, nb:] @ Wm.T], 1)], 0)
    Sigma = Sigma + Qn
    Sigma = 0.5 * (Sigma + Sigma.T)

    feat_mu = torch.where(state.active[:, None], new_feat, state.feat_mu)
    return state.replace(base_mu=base_mu, feat_mu=feat_mu, Sigma=Sigma,
                         t=state.t + total_dt), qt


def propagate_imu_batch(state: FilterState, cfg: VIOConfig, batch: ImuSample,
                        gravity_w) -> FilterState:
    """As ``propagate_imu_batch_with_motion``, without the motion."""
    state, _ = propagate_imu_batch_with_motion(state, cfg, batch, gravity_w)
    return state


def estimate_gravity_world(accel_samples: torch.Tensor, g: float = 9.81):
    """Initial gravity in the world (= initial body) frame from a
    stationary window: the specific force at rest is f = −g_w."""
    mean_f = torch.mean(accel_samples, 0)
    return -mean_f / torch.linalg.vector_norm(mean_f) * g
