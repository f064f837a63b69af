"""The port's sequential IMU reference (``imu.propagate_imu_step`` /
``propagate_imu_batch_steps``, ``dynamics.convolve_feature``) and its
blocked covariance propagate (``dynamics.propagate_covariance_blocked``)
against the JAX package on the CPU, on inputs made from a numpy seed.

Bars (each relative to the largest magnitude of the reference value, as
in ``test_torch_imu.py``): one step and the per-sample loop within 1e-5
of JAX's (the mean, Σ and t: the same exact jacfwd F and G, summed in
another order); the port's loop against the port's compound interval
``propagate_imu_batch`` at ``tests/test_imu.py:140``'s bars (base_mu
atol 1e-6, Σ rtol 1e-5 with atol 1e-6); the blocked propagate within
rtol 1e-4, atol 1e-5 of F Σ Fᵀ + Q and of the JAX blocked propagate
(``tests/test_dynamics.py:203``'s bars), and equal to the port's dense
``propagate_covariance`` at those bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import dynamics as jdynamics
from ekf_vio_tpu.core import imu as jimu
from ekf_vio_tpu_torch import interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import dynamics, imu
from test_torch_batched import one_torch_thread  # noqa: F401  (fixture)
from test_torch_core import _close, _filter_dict, _jax_state

N = 8
G_W = np.array([0.0, 0.0, -9.81], np.float32)


def _state(seed):
    d = _filter_dict(seed, n=N)
    rng = np.random.RandomState(seed + 50)
    d["base_mu"][10:22] = rng.normal(scale=0.05, size=12)  # ω, a, biases
    return d


def _batch(seed, k=6, pad=(3,)):
    rng = np.random.RandomState(seed)
    dt = np.full(k, 0.005, np.float32)
    dt[list(pad)] = 0.0
    gyro = rng.normal(scale=0.3, size=(k, 3)).astype(np.float32)
    accel = (-G_W + rng.normal(scale=0.5, size=(k, 3))).astype(np.float32)
    return dt, gyro, accel


def _port(d):
    return interop.filter_state_from_numpy(d, "cpu")


def _assert_filter(got, ref, rel=1e-5):
    for k in ("base_mu", "feat_mu", "Sigma", "t"):
        _close(getattr(got, k), getattr(ref, k), rel)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))


def test_convolve_feature_matches_jax_and_the_batched_form():
    d = _state(0)
    base = torch.from_numpy(d["base_mu"])
    for f in d["feat_mu"][:4]:
        got = dynamics.convolve_feature(base, torch.from_numpy(f), 0.05)
        _close(got, jdynamics.convolve_feature(jnp.asarray(d["base_mu"]),
                                               jnp.asarray(f), 0.05))
    np.testing.assert_array_equal(
        torch.stack([dynamics.convolve_feature(base, torch.from_numpy(f),
                                               0.05)
                     for f in d["feat_mu"]]).numpy(),
        dynamics.convolve_features(base, torch.from_numpy(d["feat_mu"]),
                                   0.05).numpy())


@pytest.mark.parametrize("dt", [0.005, 0.0021])
def test_imu_step_matches_jax(dt):
    d = _state(1)
    _, gyro, accel = _batch(2)
    cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
    got = imu.propagate_imu_step(
        _port(d), cfg, imu.ImuSample(torch.tensor(dt), torch.from_numpy(
            gyro[0]), torch.from_numpy(accel[0])), torch.from_numpy(G_W))
    ref = jax.jit(jimu.propagate_imu_step, static_argnums=1)(
        _jax_state(d), jcfg, jimu.ImuSample(jnp.float32(dt),
                                            jnp.asarray(gyro[0]),
                                            jnp.asarray(accel[0])),
        jnp.asarray(G_W))
    _assert_filter(got, ref)
    # the bias columns couple into pose and velocity (G and F are exact)
    assert np.abs(got.Sigma[:10, 16:22].numpy()).max() > 0


def test_imu_loop_matches_jax_with_padding_rows():
    d = _state(3)
    dt, gyro, accel = _batch(4, k=6, pad=(1, 4))
    cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
    got = imu.propagate_imu_batch_steps(
        _port(d), cfg, imu.ImuSample(*(torch.from_numpy(a)
                                       for a in (dt, gyro, accel))),
        torch.from_numpy(G_W))
    ref = jax.jit(jimu.propagate_imu_batch_steps, static_argnums=1)(
        _jax_state(d), jcfg, jimu.ImuSample(*(jnp.asarray(a)
                                              for a in (dt, gyro, accel))),
        jnp.asarray(G_W))
    _assert_filter(got, ref)
    np.testing.assert_allclose(float(got.t), d["t"] + dt.sum(), rtol=1e-6)


def test_imu_loop_matches_the_compound_interval():
    """As tests/test_imu.py:140: from rest, 10 samples at 200 Hz."""
    cfg = VIOConfig(max_features=N, use_imu=True)
    from ekf_vio_tpu_torch.core import filter as ekf

    s0 = ekf.init_state(cfg)
    k = 10
    g_w = torch.from_numpy(G_W)
    batch = imu.ImuSample(
        dt=torch.full((k,), 0.005),
        gyro=torch.tensor([0.05, 0.0, 0.1]).expand(k, 3).contiguous(),
        accel=(-g_w).expand(k, 3).contiguous())
    s_scan = imu.propagate_imu_batch(s0, cfg, batch, g_w)
    s_loop = imu.propagate_imu_batch_steps(s0, cfg, batch, g_w)
    np.testing.assert_allclose(s_scan.base_mu.numpy(),
                               s_loop.base_mu.numpy(), atol=1e-6)
    np.testing.assert_allclose(s_scan.Sigma.numpy(), s_loop.Sigma.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_blocked_propagate_matches_dense_and_jax():
    """As tests/test_dynamics.py:203, on a random SPD Σ and the exact
    process Jacobians of a random base state."""
    n = 6
    rng = np.random.RandomState(0)
    d = 22 + 3 * n
    a = rng.normal(size=(d, d)).astype(np.float32)
    sigma = (a @ a.T / d + np.eye(d, dtype=np.float32)).astype(np.float32)
    base = rng.normal(scale=0.3, size=22).astype(np.float32)
    base[3:7] = [1, 0, 0, 0]
    feats = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    active = rng.uniform(size=n) < 0.7
    t = torch.from_numpy
    Fb, Ffb, Ff = dynamics.process_jacobian_blocks(t(base), t(feats), 0.05)
    Ffb, Ff = dynamics.mask_feature_jacobians(Ffb, Ff, t(active))
    q = dynamics.process_noise_diag(0.05, n, t(active),
                                    VIOConfig(max_features=n))
    F = dynamics.build_dense_F(Fb, Ffb, Ff)
    want = F @ t(sigma) @ F.T + torch.diag(q)
    want = 0.5 * (want + want.T)
    got = dynamics.propagate_covariance_blocked(t(sigma), Fb, Ffb, Ff, q)
    for ref in (want, dynamics.propagate_covariance(t(sigma), Fb, Ffb, Ff,
                                                    q)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
    jref = jdynamics.propagate_covariance_blocked(
        jnp.asarray(sigma), *(jnp.asarray(x.numpy()) for x in (Fb, Ffb, Ff,
                                                               q)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)
