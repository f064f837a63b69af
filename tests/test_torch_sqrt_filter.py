"""The square-root filter of the port (ekf_vio_tpu_torch/core/sqrt_filter.py)
against the JAX package's on the CPU, function by function (the engine in
square-root form: tests/test_torch_sqrt_engine.py).

Inputs are made with numpy from a seed: a filter state with a correlated
Σ whose pose gauge (rows 0-6) and inactive slots are exactly zero, as the
engine keeps them.  Both packages start from the same Σ or the same
factor L (the JAX package's ``to_factor``).

What is compared: the mean, and L Lᵀ — not L entry by entry, because the
pre-arrays are rank-deficient by design (zero rows for the gauge and the
free slots) and the R of a QR is not unique there.  Tolerances: the mean
within 1e-5 (f32 roundoff of the same formulas); L Lᵀ within
2e-5·max|Σ| (f32 roundoff of two Householder QRs in different LAPACK
call orders, scaled by the largest covariance entry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import filter as jfilt
from ekf_vio_tpu.core import imu as jimu
from ekf_vio_tpu.core import sqrt_filter as jsqrt
from ekf_vio_tpu.core import state as jstate
from ekf_vio_tpu_torch import interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as tfilt
from ekf_vio_tpu_torch.core import imu, sqrt_filter

N = 16
D = 22 + 3 * N
CFG_KW = dict(max_features=N, sigma_jitter_rel=0.0)
MU_TOL = 1e-5
SIG_REL = 2e-5


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state_dict(seed, active_frac=0.75):
    """A filter state as the engine keeps it: correlated Σ with a spectrum
    over ~4 decades, zero rows and columns at the pose gauge and at every
    inactive slot."""
    rng = np.random.RandomState(seed)
    a = rng.normal(size=(D, D))
    scale = 10.0 ** rng.uniform(-2.0, 0.0, D)
    sigma = (a @ a.T / D + np.eye(D)) * scale[:, None] * scale[None, :]
    active = rng.uniform(size=N) < active_frac
    live = np.concatenate([np.zeros(7), np.ones(15), np.repeat(active, 3)])
    sigma = (sigma * live[:, None] * live[None, :]).astype(np.float32)
    q = rng.normal(size=4)
    base = rng.normal(scale=0.3, size=22)
    base[3:7] = q / np.linalg.norm(q)
    feat = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.4, 0.4, N),
                     rng.uniform(0.3, 2.5, N)], -1).astype(np.float32)
    return dict(
        base_mu=base.astype(np.float32), feat_mu=feat, active=active,
        klt_ref=(feat[:, :2] + rng.normal(scale=0.01, size=(N, 2))).astype(
            np.float32),
        Sigma=0.5 * (sigma + sigma.T), t=np.float32(1.25),
        age=rng.randint(0, 9, N).astype(np.int32))


def _jax_state(d):
    return jstate.FilterState(**{k: jnp.asarray(v) for k, v in d.items()})


def _factor_pair(seed):
    """The same factor-mode state in both packages (L from the JAX
    package's ``to_factor``)."""
    jf = jsqrt.to_factor(_jax_state(_state_dict(seed)))
    d = {k: np.asarray(getattr(jf, k)) for k in interop.FILTER_FIELDS}
    return interop.filter_state_from_numpy(d, "cpu"), jf


def _cov(L):
    L = _np(L).astype(np.float64)
    return L @ L.T


def _assert_factor_state(got, ref, scale=None):
    """Means and bookkeeping equal within MU_TOL; L Lᵀ within
    SIG_REL·max|Σ|."""
    np.testing.assert_allclose(_np(got.base_mu), _np(ref.base_mu),
                               atol=MU_TOL)
    np.testing.assert_allclose(_np(got.feat_mu), _np(ref.feat_mu),
                               atol=MU_TOL)
    np.testing.assert_allclose(_np(got.klt_ref), _np(ref.klt_ref),
                               atol=MU_TOL)
    np.testing.assert_array_equal(_np(got.active), _np(ref.active))
    np.testing.assert_array_equal(_np(got.age), _np(ref.age))
    want = _cov(ref.Sigma)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(_cov(got.Sigma), want, atol=SIG_REL * scale)
    # lower triangular with a nonnegative diagonal, as _tria leaves it
    Lg = _np(got.Sigma)
    assert np.abs(np.triu(Lg, 1)).max() == 0.0
    assert np.diagonal(Lg).min() >= 0.0


def _measurement(seed, state_dict):
    rng = np.random.RandomState(100 + seed)
    z = (state_dict["feat_mu"][:, :2]
         + rng.normal(scale=3e-3, size=(N, 2))).astype(np.float32)
    r = rng.uniform(0.5e-5, 2e-5, (N, 2))
    meas_cov = np.zeros((N, 2, 2), np.float32)
    meas_cov[:, 0, 0], meas_cov[:, 1, 1] = r[:, 0], r[:, 1]
    meas_cov[:, 0, 1] = meas_cov[:, 1, 0] = 0.2 * np.sqrt(r[:, 0] * r[:, 1])
    passed = np.arange(N) % 3 != 0   # a third fails
    return z, meas_cov, passed


@pytest.mark.parametrize("seed", [0, 1])
def test_factor_round_trip(seed):
    d = _state_dict(seed)
    ts = interop.filter_state_from_numpy(d, "cpu")
    fact = sqrt_filter.to_factor(ts)
    jf = jsqrt.to_factor(_jax_state(d))
    # Σ has full rank on its live rows, so its Cholesky factor is unique
    np.testing.assert_allclose(_np(fact.Sigma), np.asarray(jf.Sigma),
                               atol=SIG_REL * np.abs(d["Sigma"]).max())
    dead = np.diagonal(d["Sigma"]) == 0
    assert dead.sum() >= 7 and np.abs(_np(fact.Sigma)[dead]).max() == 0.0
    back = sqrt_filter.to_covariance(fact)
    np.testing.assert_allclose(_np(back.Sigma), d["Sigma"],
                               atol=1e-5 * np.abs(d["Sigma"]).max())
    np.testing.assert_allclose(
        _np(sqrt_filter.sigma_diag_factor(fact.Sigma)),
        np.asarray(jsqrt.sigma_diag_factor(jf.Sigma)),
        atol=SIG_REL * np.abs(d["Sigma"]).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_predict_sqrt_factor(seed):
    tf, jf = _factor_pair(seed)
    got = sqrt_filter.predict_sqrt_factor(tf, VIOConfig(**CFG_KW), 0.05)
    ref = jax.jit(jsqrt.predict_sqrt_factor, static_argnums=1)(
        jf, JConfig(**CFG_KW), 0.05)
    _assert_factor_state(got, ref)
    assert abs(float(got.t) - float(ref.t)) < 1e-6


@pytest.mark.parametrize("jitter_rel", [0.0, 1e-4])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_sqrt_factor_partial_measurements(seed, jitter_rel):
    tf, jf = _factor_pair(seed)
    z, meas_cov, passed = _measurement(seed, _state_dict(seed))
    kw = dict(CFG_KW, sigma_jitter_rel=jitter_rel)
    t = torch.from_numpy
    got = sqrt_filter.update_sqrt_factor(tf, VIOConfig(**kw), t(z),
                                         t(meas_cov), t(passed))
    ref = jsqrt.update_sqrt_factor(jf, JConfig(**kw), jnp.asarray(z),
                                   jnp.asarray(meas_cov), jnp.asarray(passed))
    _assert_factor_state(got, ref)
    # the update did something: measured features moved
    meas = passed & _np(tf.active)
    assert np.abs(_np(got.feat_mu) - _np(tf.feat_mu))[meas].max() > 1e-4
    np.testing.assert_array_equal(_np(got.klt_ref)[meas], z[meas])


def test_unmeasured_features_untouched():
    """All passed=False: a no-op on the mean and on L Lᵀ."""
    tf, jf = _factor_pair(2)
    z, meas_cov, _ = _measurement(2, _state_dict(2))
    t = torch.from_numpy
    got = sqrt_filter.update_sqrt_factor(
        tf, VIOConfig(**CFG_KW), t(z), t(meas_cov),
        torch.zeros(N, dtype=torch.bool))
    np.testing.assert_allclose(_np(got.base_mu), _np(tf.base_mu), atol=1e-6)
    np.testing.assert_allclose(_np(got.feat_mu), _np(tf.feat_mu), atol=1e-6)
    np.testing.assert_array_equal(_np(got.klt_ref), _np(tf.klt_ref))
    want = _cov(tf.Sigma)
    np.testing.assert_allclose(_cov(got.Sigma), want,
                               atol=SIG_REL * np.abs(want).max())
    ref = jsqrt.update_sqrt_factor(jf, JConfig(**CFG_KW), jnp.asarray(z),
                                   jnp.asarray(meas_cov), jnp.zeros(N, bool))
    _assert_factor_state(got, ref)


def test_inactive_rows_stay_isolated():
    """Dropped slots keep zero rows of L Lᵀ through a predict and an
    update that measures every slot (tests/test_sqrt_filter.py's
    TestIsolation, in factor space)."""
    tf, jf = _factor_pair(3)
    cfg, jcfg = VIOConfig(**CFG_KW), JConfig(**CFG_KW)
    drop = np.arange(N) >= N // 2
    tf = sqrt_filter.drop_features_factor(tf, torch.from_numpy(drop))
    jf = jsqrt.drop_features_factor(jf, jnp.asarray(drop))
    tf = sqrt_filter.predict_sqrt_factor(tf, cfg, 0.05)
    jf = jsqrt.predict_sqrt_factor(jf, jcfg, 0.05)
    z = _np(tf.feat_mu)[:, :2].copy()
    meas_cov = np.tile(np.eye(2, dtype=np.float32) * 1e-5, (N, 1, 1))
    tf = sqrt_filter.update_sqrt_factor(tf, cfg, torch.from_numpy(z),
                                        torch.from_numpy(meas_cov),
                                        torch.ones(N, dtype=torch.bool))
    jf = jsqrt.update_sqrt_factor(jf, jcfg, jnp.asarray(z),
                                  jnp.asarray(meas_cov), jnp.ones(N, bool))
    _assert_factor_state(tf, jf)
    rows = (22 + 3 * np.arange(N)[:, None] + np.arange(3)).reshape(N, 3)
    dead = rows[~_np(tf.active)].reshape(-1)
    assert dead.size >= 3 * (N // 2)
    assert np.abs(_cov(tf.Sigma)[dead]).max() < 1e-5


def test_drop_features_factor():
    tf, jf = _factor_pair(4)
    drop = np.arange(N) % 3 == 0
    got = sqrt_filter.drop_features_factor(tf, torch.from_numpy(drop))
    ref = jsqrt.drop_features_factor(jf, jnp.asarray(drop))
    _assert_factor_state(got, ref)
    np.testing.assert_array_equal(_np(got.Sigma), np.asarray(ref.Sigma))
    dense = jstate.drop_features(_jax_state(_state_dict(4)),
                                 jnp.asarray(drop))
    np.testing.assert_allclose(
        _cov(got.Sigma), np.asarray(dense.Sigma),
        atol=SIG_REL * np.abs(np.asarray(dense.Sigma)).max())


@pytest.mark.parametrize("with_depths", [False, True])
def test_add_features_factor(with_depths):
    """Slot reuse: drop, then re-allocate in factor space; wiped rows get
    the clean prior, survivors keep their correlations."""
    tf, jf = _factor_pair(5)
    cfg, jcfg = VIOConfig(**CFG_KW), JConfig(**CFG_KW)
    drop = np.arange(N) < 6
    tf = sqrt_filter.drop_features_factor(tf, torch.from_numpy(drop))
    jf = jsqrt.drop_features_factor(jf, jnp.asarray(drop))
    rng = np.random.RandomState(7)
    uv = rng.uniform(-0.4, 0.4, (N, 2)).astype(np.float32)
    valid = rng.uniform(size=N) < 0.4
    kw, jkw = {}, {}
    if with_depths:
        depths = rng.uniform(0.2, 4.0, N).astype(np.float32)
        dvars = (10.0 ** rng.uniform(-9, 3, N)).astype(np.float32)
        kw = dict(depths=torch.from_numpy(depths),
                  depth_vars=torch.from_numpy(dvars))
        jkw = dict(depths=jnp.asarray(depths), depth_vars=jnp.asarray(dvars))
    got = sqrt_filter.add_features_factor(tf, cfg, torch.from_numpy(uv),
                                          torch.from_numpy(valid), **kw)
    ref = jsqrt.add_features_factor(jf, jcfg, jnp.asarray(uv),
                                    jnp.asarray(valid), **jkw)
    assert int(_np(got.active).sum()) > int(_np(tf.active).sum())
    # the default depth prior (variance 100) sets the scale of L Lᵀ
    _assert_factor_state(got, ref)


def test_wipe_rows_factor_with_nan_at_rows_not_wiped():
    tf, jf = _factor_pair(6)
    wipe = np.zeros(D, bool)
    wipe[[24, 30, 31]] = True
    new_diag = np.where(wipe, 0.25, np.nan).astype(np.float32)
    got = sqrt_filter.wipe_rows_factor(tf.Sigma, torch.from_numpy(wipe),
                                       torch.from_numpy(new_diag))
    ref = jsqrt.wipe_rows_factor(jf.Sigma, jnp.asarray(wipe),
                                 jnp.asarray(new_diag))
    assert np.isfinite(_np(got)).all()
    want = _cov(tf.Sigma)
    want[wipe, :] = 0.0
    want[:, wipe] = 0.0
    want[wipe, wipe] = 0.25
    scale = np.abs(want).max()
    np.testing.assert_allclose(_cov(got), want, atol=SIG_REL * scale)
    np.testing.assert_allclose(_cov(got), _cov(ref), atol=SIG_REL * scale)
    # a float selector, as the engine's depth bootstrap passes it
    got_f = sqrt_filter.wipe_rows_factor(
        tf.Sigma, torch.from_numpy(wipe.astype(np.float32)),
        torch.from_numpy(new_diag))
    np.testing.assert_array_equal(_np(got_f), _np(got))


@pytest.mark.parametrize("fej", [False, True])
def test_propagate_imu_factor(fej):
    tf, jf = _factor_pair(8)
    rng = np.random.RandomState(9)
    k = 10
    dt = np.full(k, 0.005, np.float32)
    dt[-2:] = 0.0   # padding rows
    gyro = rng.normal(scale=0.3, size=(k, 3)).astype(np.float32)
    accel = (rng.normal(scale=0.5, size=(k, 3))
             + np.array([0.0, 9.81, 0.0])).astype(np.float32)
    g_w = np.array([0.0, -9.81, 0.0], np.float32)
    lin = (_np(tf.base_mu) + rng.normal(scale=1e-3, size=22).astype(
        np.float32)) if fej else None
    kw = dict(CFG_KW, use_imu=True, q_feature=1e-7)
    t = torch.from_numpy
    got, qt = sqrt_filter.propagate_imu_factor(
        tf, VIOConfig(**kw), imu.ImuSample(t(dt), t(gyro), t(accel)), t(g_w),
        lin_base=None if lin is None else t(lin))
    ref, jqt = jax.jit(jsqrt.propagate_imu_factor, static_argnums=1)(
        jf, JConfig(**kw),
        jimu.ImuSample(jnp.asarray(dt), jnp.asarray(gyro),
                       jnp.asarray(accel)), jnp.asarray(g_w),
        lin_base=None if lin is None else jnp.asarray(lin))
    np.testing.assert_allclose(_np(qt), np.asarray(jqt), atol=MU_TOL)
    _assert_factor_state(got, ref)
    assert abs(float(got.t) - float(ref.t)) < 1e-6


@pytest.mark.parametrize("bad", ["negative_R", "nan_R"])
def test_failed_cholesky_leaves_the_state_unchanged(bad):
    """A measurement covariance whose Cholesky fails turns the gain
    non-finite; the guard then keeps the predicted mean and factor.  (The
    JAX package keeps the factor but lets the NaN of G·0 into the mean;
    the port zeroes G with the gain.)"""
    tf, jf = _factor_pair(10)
    z, meas_cov, passed = _measurement(10, _state_dict(10))
    meas_cov = meas_cov.copy()
    row = int(np.nonzero(passed & _np(tf.active))[0][0])
    meas_cov[row] = -np.eye(2) if bad == "negative_R" else np.nan
    t = torch.from_numpy
    got = sqrt_filter.update_sqrt_factor(tf, VIOConfig(**CFG_KW), t(z),
                                         t(meas_cov), t(passed))
    np.testing.assert_array_equal(_np(got.Sigma), _np(tf.Sigma))
    np.testing.assert_allclose(_np(got.base_mu), _np(tf.base_mu), atol=1e-6)
    np.testing.assert_allclose(_np(got.feat_mu), _np(tf.feat_mu), atol=1e-6)
    ref = jsqrt.update_sqrt_factor(jf, JConfig(**CFG_KW), jnp.asarray(z),
                                   jnp.asarray(meas_cov), jnp.asarray(passed))
    np.testing.assert_array_equal(np.asarray(ref.Sigma), np.asarray(jf.Sigma))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_boundary_wrappers_and_filter_dispatch(seed):
    """``predict_sqrt`` / ``update_sqrt`` on a dense Σ, reached through
    ``filter.predict`` / ``update_with_feature_positions`` with
    ``square_root_form``; ``budget`` is refused as the JAX package
    refuses it."""
    d = _state_dict(seed)
    kw = dict(CFG_KW, square_root_form=True)
    cfg, jcfg = VIOConfig(**kw), JConfig(**kw)
    ts = interop.filter_state_from_numpy(d, "cpu")
    js = _jax_state(d)
    got = tfilt.predict(ts, cfg, 0.05)
    ref = jfilt.predict(js, jcfg, 0.05)
    scale = np.abs(np.asarray(ref.Sigma)).max()
    np.testing.assert_allclose(_np(got.base_mu), np.asarray(ref.base_mu),
                               atol=MU_TOL)
    np.testing.assert_allclose(_np(got.Sigma), np.asarray(ref.Sigma),
                               atol=SIG_REL * scale)
    z, meas_cov, passed = _measurement(seed, d)
    t = torch.from_numpy
    got = tfilt.update_with_feature_positions(ts, cfg, t(z), t(meas_cov),
                                              t(passed), budget=N)
    ref = jfilt.update_with_feature_positions(
        js, jcfg, jnp.asarray(z), jnp.asarray(meas_cov), jnp.asarray(passed),
        budget=N)
    np.testing.assert_allclose(_np(got.feat_mu), np.asarray(ref.feat_mu),
                               atol=MU_TOL)
    np.testing.assert_allclose(_np(got.Sigma), np.asarray(ref.Sigma),
                               atol=SIG_REL * scale)
    # against the covariance form of the port itself (floor off)
    dense = tfilt.update_with_feature_positions(
        ts, VIOConfig(**CFG_KW), t(z), t(meas_cov), t(passed))
    np.testing.assert_allclose(_np(got.Sigma), _np(dense.Sigma),
                               atol=2e-4 * scale)
    with pytest.raises(ValueError, match="budget"):
        tfilt.update_with_feature_positions(ts, cfg, t(z), t(meas_cov),
                                            t(passed), budget=N - 1)
    with pytest.raises(ValueError, match="budget"):
        jfilt.update_with_feature_positions(
            js, jcfg, jnp.asarray(z), jnp.asarray(meas_cov),
            jnp.asarray(passed), budget=N - 1)


def test_factor_nis_matches_jax():
    from ekf_vio_tpu.core import update as jupd
    from ekf_vio_tpu_torch.core import update

    tf, jf = _factor_pair(11)
    z, meas_cov, passed = _measurement(11, _state_dict(11))
    t = torch.from_numpy
    got = update.innovation_nis_per_feature(tf, t(z), t(meas_cov),
                                            factor=True)
    ref = jupd.innovation_nis_per_feature(jf, jnp.asarray(z),
                                          jnp.asarray(meas_cov), factor=True)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-4)
    got = update.innovation_nis(tf, t(z), t(meas_cov), t(passed), factor=True)
    ref = jupd.innovation_nis(jf, jnp.asarray(z), jnp.asarray(meas_cov),
                              jnp.asarray(passed), factor=True)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
