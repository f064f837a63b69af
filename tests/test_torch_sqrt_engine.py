"""The port's engine in square-root form (``VIOConfig.square_root_form``:
the state's Sigma field holds the Cholesky factor L across frames) against
the JAX engine on the CPU: ``initialize``, one step from a carried
factor-mode state, a vision rollout, IMU steps with the depth bootstrap,
and the tracking-lost re-bootstrap.

Bars: the covariance-form bars of tests/test_torch_engine.py, with Σ
read as L Lᵀ (L itself is not unique where the pre-arrays lose rank):
equal tracked and active counts on every frame; per step base_mu within
1e-4, feat_mu within 2e-5, L Lᵀ within 1e-3·max(|Σ|, 1); over a rollout
base_mu within 5e-3 (vision) and 1e-3 (IMU), f32 roundoff compounding in
the weakly observed kinematic states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu import engine as jengine
from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import sqrt_filter as jsqrt
from ekf_vio_tpu.core import state as jstate
from ekf_vio_tpu_torch import engine, interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as tfilt
from ekf_vio_tpu_torch.core import sqrt_filter
from ekf_vio_tpu_torch.sim import frames as sim_frames
from ekf_vio_tpu_torch.sim import rendered


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _cov(L):
    L = _np(L).astype(np.float64)
    return L @ L.T


W, H = 160, 120
K = [[458.0 / 4, 0.0, W / 2], [0.0, 458.0 / 4, H / 2], [0.0, 0.0, 1.0]]
ENGINE_KW = dict(max_features=64, num_features=50, min_new_feature_dist=8.0,
                 fast_threshold=30, square_root_form=True)


def _jax_state_dict(es):
    d = {k: np.asarray(getattr(es.filt, k)) for k in interop.FILTER_FIELDS}
    d["prev_pyr"] = [np.asarray(level) for level in es.prev_pyr]
    d["frame_idx"] = np.asarray(es.frame_idx)
    d["lin_base"] = np.asarray(es.lin_base)
    return d


@pytest.fixture(scope="module")
def small_frames():
    from ekf_vio_tpu.frontend import camera as jcam

    frames, times = sim_frames.make_frames(seed=0, n_frames=8)
    return np.array(jcam.downscale_image(jnp.asarray(frames), 4)), times


def test_sqrt_engine_step_from_a_carried_jax_state(small_frames):
    """``initialize`` factors once in both packages; one step from the JAX
    package's factor-mode state, carried over by ``interop`` unchanged."""
    small, times = small_frames
    jcfg, cfg = JConfig(**ENGINE_KW), VIOConfig(**ENGINE_KW)
    jc = jengine.make_hashable_camera(K, W, H)
    cam = interop.camera_from_K(K, W, H)
    es0 = jengine.initialize(jnp.asarray(small[0]), times[0], jcfg, jc)
    ts_init = engine.initialize(torch.from_numpy(small[0]), times[0], cfg,
                                cam, device="cpu")
    np.testing.assert_allclose(_np(ts_init.filt.Sigma),
                               np.asarray(es0.filt.Sigma), atol=1e-6)
    # interop carries the factor (the Sigma field holding L) unchanged
    d0 = _jax_state_dict(es0)
    ts0 = interop.engine_state_from_numpy(d0, "cpu")
    np.testing.assert_array_equal(_np(ts0.filt.Sigma), d0["Sigma"])
    np.testing.assert_array_equal(
        interop.engine_state_to_numpy(ts0)["Sigma"], d0["Sigma"])
    np.testing.assert_array_equal(
        interop.filter_state_to_numpy(
            interop.filter_state_from_numpy(d0, "cpu"))["Sigma"], d0["Sigma"])
    assert np.abs(np.triu(d0["Sigma"], 1)).max() == 0.0   # it is a factor

    es1, jout = jax.jit(jengine.step, static_argnums=(3, 4))(
        es0, jnp.asarray(small[1]), jnp.float32(times[1]), jcfg, jc)
    ts1, out = engine.step(ts0, torch.from_numpy(small[1]),
                           torch.tensor(times[1]), cfg, cam)
    assert int(out.num_tracked) == int(jout.num_tracked) > 30
    assert int(out.num_active) == int(jout.num_active)
    assert bool(out.tracking_lost) == bool(jout.tracking_lost) is False
    np.testing.assert_array_equal(_np(ts1.filt.active),
                                  np.asarray(es1.filt.active))
    assert np.abs(_np(ts1.filt.base_mu) - np.asarray(es1.filt.base_mu)
                  ).max() < 1e-4
    assert np.abs(_np(ts1.filt.feat_mu) - np.asarray(es1.filt.feat_mu)
                  ).max() < 2e-5
    # the bars of test_torch_engine.py's covariance-form step, on L Lᵀ
    want = _cov(es1.filt.Sigma)
    assert np.abs(_cov(ts1.filt.Sigma) - want).max() < 1e-3 * max(
        np.abs(want).max(), 1.0)
    np.testing.assert_allclose(_np(out.pose_cov_diag),
                               np.asarray(jout.pose_cov_diag), atol=1e-5)
    np.testing.assert_allclose(_np(out.pos_cov), np.asarray(jout.pos_cov),
                               atol=1e-5)
    np.testing.assert_allclose(float(out.mean_nis), float(jout.mean_nis),
                               rtol=1e-3)


def test_sqrt_engine_rollout_matches_jax(small_frames):
    small, times = small_frames
    jcfg, cfg = JConfig(**ENGINE_KW), VIOConfig(**ENGINE_KW)
    _, jout = jengine.run_sequence(jnp.asarray(small), jnp.asarray(times),
                                   jcfg, jengine.make_hashable_camera(K, W, H))
    es, out = engine.run_sequence(torch.from_numpy(small),
                                  torch.from_numpy(times), cfg,
                                  interop.camera_from_K(K, W, H),
                                  device="cpu")
    np.testing.assert_array_equal(_np(out.num_tracked),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(_np(out.num_active),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 10
    assert torch.isfinite(out.base_mu).all()
    # the drift test_torch_engine.py's covariance-form rollout allows
    np.testing.assert_allclose(_np(out.base_mu), np.asarray(jout.base_mu),
                               atol=5e-3)
    cov = sqrt_filter.to_covariance(es.filt)
    min_diag, asym = tfilt.check_sigma(cov)
    assert float(min_diag) >= 0.0 and float(asym) == 0.0


def test_sqrt_engine_recover_tracking_lost_matches_jax():
    """The re-bootstrap's diag(√σ) factor, from a factor with a NaN mean
    entry and an infinite row."""
    rng = np.random.RandomState(0)
    n = 8
    d = 22 + 3 * n
    kw = dict(max_features=n, square_root_form=True)
    fields = dict(
        base_mu=rng.normal(size=22).astype(np.float32),
        feat_mu=rng.normal(size=(n, 3)).astype(np.float32),
        active=rng.uniform(size=n) < 0.5,
        klt_ref=rng.normal(size=(n, 2)).astype(np.float32),
        Sigma=np.tril(rng.normal(scale=0.3, size=(d, d))).astype(np.float32),
        t=np.float32(0.3), age=rng.randint(0, 5, n).astype(np.int32))
    fields["base_mu"][1] = np.nan
    fields["Sigma"][17, 3] = np.inf
    js = jstate.FilterState(**{k: jnp.asarray(v) for k, v in fields.items()})
    for lost in (True, False):
        got = engine._recover_tracking_lost(
            interop.filter_state_from_numpy(fields, "cpu"), VIOConfig(**kw),
            torch.tensor(lost), sqrt_filter.FACTOR)
        ref = jengine._recover_tracking_lost(js, JConfig(**kw),
                                             jnp.asarray(lost))
        for k in interop.FILTER_FIELDS:
            np.testing.assert_allclose(_np(getattr(got, k)),
                                       np.asarray(getattr(ref, k)),
                                       atol=1e-6, equal_nan=True)
        if lost:   # the factor of diag(σ²) is diag(σ)
            L = _np(got.Sigma)
            assert np.abs(L - np.diag(np.diagonal(L))).max() == 0.0
            assert abs(L[8, 8] ** 2 - 30.0) < 1e-4


MONO_KW = dict(max_features=32, num_features=25, min_new_feature_dist=10.0,
               fast_threshold=25, triangulate_new_features=True,
               klt_measurement_variance_px=0.001, q_feature=1e-7,
               use_imu=True, square_root_form=True)


def test_sqrt_mono_inertial_steps_match_jax():
    """IMU steps in square-root form from ``initialize`` (no VI
    initialization, which has its own file): the factor IMU propagation,
    the depth bootstrap's re-triangularization, update, drop and add.
    Rendered 160x120 frames, below the FAST kernels' 128x256 px line, so
    both packages mask the margin after NMS."""
    seq = rendered.generate(num_frames=6, w=160, h=120)
    frames = np.round(seq.frames)
    h, w = frames.shape[1:]
    jcfg, cfg = JConfig(**MONO_KW), VIOConfig(**MONO_KW)
    jc = jengine.make_hashable_camera(seq.K, w, h)
    cam = interop.camera_from_K(seq.K, w, h)
    args = (frames, seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
            seq.gravity_w)
    jes, jout = jengine.run_sequence_imu(*(jnp.asarray(a) for a in args),
                                         jcfg, jc)
    es, out = engine.run_sequence_imu(*(torch.from_numpy(a) for a in args),
                                      cfg, cam, device="cpu")
    np.testing.assert_array_equal(_np(out.num_tracked),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(_np(out.num_active),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 10
    np.testing.assert_allclose(_np(out.base_mu), np.asarray(jout.base_mu),
                               atol=1e-3)
    want = _cov(jes.filt.Sigma)
    assert np.abs(_cov(es.filt.Sigma) - want).max() < 1e-3 * max(
        np.abs(want).max(), 1.0)
