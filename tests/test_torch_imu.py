"""Parity of the port's IMU propagation (ekf_vio_tpu_torch/core/imu.py) with
the JAX package on the CPU, on inputs made from a numpy seed.

Bars (each relative to the largest magnitude of the reference value):
the mean chain and the compound motion within 1e-5, J within 1e-5, Q29
within 1e-4 (its entries are products of 1e-8-sized noise terms summed in
another association order), the propagated Σ within 1e-5; the JAX
package's associative scan and cumsum associate differently from the
port's doubling and sequential prefix sums, so parity is at f32 roundoff.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import imu as jimu
from ekf_vio_tpu_torch import interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import imu
from test_torch_core import _close, _filter_dict, _jax_state

N = 16
G_W = np.array([0.0, 9.81, 0.0], np.float32)


def _batch(seed, k=10, pad=(7,)):
    """k samples at ~200 Hz; rows in ``pad`` are dt = 0 padding."""
    rng = np.random.RandomState(seed)
    dt = np.full(k, 0.005, np.float32)
    dt[-1] = 0.0021
    dt[list(pad)] = 0.0
    gyro = rng.normal(scale=0.3, size=(k, 3)).astype(np.float32)
    accel = (-G_W + rng.normal(scale=0.5, size=(k, 3))).astype(np.float32)
    return dt, gyro, accel


def _both(batch):
    dt, gyro, accel = batch
    return (imu.ImuSample(*(torch.from_numpy(a) for a in batch)),
            jimu.ImuSample(jnp.asarray(dt), jnp.asarray(gyro),
                           jnp.asarray(accel)))


def _state(seed):
    d = _filter_dict(seed, n=N)
    rng = np.random.RandomState(seed + 100)
    d["base_mu"][10:22] = rng.normal(scale=0.05, size=12)  # ω, a, biases
    return d


@pytest.mark.parametrize("fej", [False, True])
def test_compound_interval_matches_jax(fej):
    d = _state(1)
    tb, jb = _both(_batch(2))
    lin = d["base_mu"] + np.random.RandomState(3).normal(
        scale=1e-2, size=22).astype(np.float32)
    lin[3:7] /= np.linalg.norm(lin[3:7])
    cfg, jcfg = VIOConfig(max_features=N), JConfig(max_features=N)
    got = imu.compound_interval(torch.from_numpy(d["base_mu"]), cfg, tb,
                                torch.from_numpy(G_W),
                                lin_base=torch.from_numpy(lin) if fej else None)
    ref = jax.jit(jimu.compound_interval, static_argnums=(1, 4))(
        jnp.asarray(d["base_mu"]), jcfg, jb, jnp.asarray(G_W), jnp.float32,
        lin_base=jnp.asarray(lin) if fej else None)
    names = ("base_mu", "qt", "qt_lin", "J", "Q29", "total_dt")
    for name, a, b in zip(names, got, ref):
        _close(a, b, 1e-4 if name == "Q29" else 1e-5)
    if fej:  # the linearization chain really differs from the mean's
        assert np.abs(np.asarray(ref[1]) - np.asarray(ref[2])).max() > 1e-6


def test_mean_chain_matches_jax():
    d = _state(4)
    tb, jb = _both(_batch(5, k=11, pad=(0, 6)))
    x0 = np.concatenate([d["base_mu"], [1, 0, 0, 0, 0, 0, 0]]).astype(
        np.float32)
    xf, xs = imu._mean_chain(torch.from_numpy(x0)[None], tb,
                             torch.from_numpy(G_W))
    rf, rs = jimu._mean_chain(jnp.asarray(x0), jb, jnp.asarray(G_W))
    _close(xf[0], rf, 1e-5)
    _close(xs[0], rs, 1e-5)


@pytest.mark.parametrize("fej", [False, True])
def test_propagate_imu_batch_with_motion_matches_jax(fej):
    d = _state(6)
    tb, jb = _both(_batch(7))
    lin = d["base_mu"].copy()
    lin[7:10] += 0.01
    cfg = VIOConfig(max_features=N, q_feature=1e-7)
    jcfg = JConfig(max_features=N, q_feature=1e-7)
    got, qt = imu.propagate_imu_batch_with_motion(
        interop.filter_state_from_numpy(d, "cpu"), cfg, tb,
        torch.from_numpy(G_W), lin_base=torch.from_numpy(lin) if fej else None)
    ref, rqt = jax.jit(jimu.propagate_imu_batch_with_motion,
                       static_argnums=(1,))(
        _jax_state(d), jcfg, jb, jnp.asarray(G_W),
        lin_base=jnp.asarray(lin) if fej else None)
    _close(qt, rqt, 1e-5)
    for k in ("base_mu", "feat_mu", "t"):
        _close(getattr(got, k), getattr(ref, k), 1e-5)
    _close(got.Sigma, ref.Sigma, 1e-5)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    # inactive slots keep their means
    np.testing.assert_array_equal(got.feat_mu.numpy()[~d["active"]],
                                  d["feat_mu"][~d["active"]])


@pytest.mark.parametrize("rem", [0.0, 5e-7, 0.0031])
@pytest.mark.parametrize("pad", [(), (8, 9), tuple(range(10))])
def test_extend_batch_with_remainder_matches_jax(rem, pad):
    tb, jb = _both(_batch(8, pad=pad))
    got = imu.extend_batch_with_remainder(tb, torch.tensor(rem))
    ref = jimu.extend_batch_with_remainder(jb, jnp.float32(rem))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a zero (or sub-microsecond) remainder appends a dt = 0 padding row
    assert (float(got.dt[-1]) == 0.0) == (rem <= 1e-6)


def test_padding_row_is_a_noop():
    """Appending dt = 0 rows changes nothing in the propagated state."""
    d = _state(9)
    tb, _ = _both(_batch(10, pad=()))
    cfg = VIOConfig(max_features=N)
    s = interop.filter_state_from_numpy(d, "cpu")
    a, qa = imu.propagate_imu_batch_with_motion(s, cfg, tb,
                                                torch.from_numpy(G_W))
    padded = imu.extend_batch_with_remainder(tb, torch.tensor(0.0))
    b, qb = imu.propagate_imu_batch_with_motion(s, cfg, padded,
                                                torch.from_numpy(G_W))
    _close(qa, qb, 1e-7)
    _close(a.base_mu, b.base_mu, 1e-7)
    _close(a.Sigma, b.Sigma, 1e-6)


def test_estimate_gravity_world_matches_jax():
    rng = np.random.RandomState(11)
    f = (-G_W + rng.normal(scale=0.05, size=(50, 3))).astype(np.float32)
    got = imu.estimate_gravity_world(torch.from_numpy(f))
    ref = jimu.estimate_gravity_world(jnp.asarray(f))
    _close(got, ref, 1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy()), 9.81, rtol=1e-6)


def test_noise_psd_and_controls_match_jax():
    cfg, jcfg = VIOConfig(), JConfig()
    np.testing.assert_array_equal(imu.imu_noise_psd(cfg).numpy(),
                                  np.asarray(jimu.imu_noise_psd(jcfg)))
    d = _state(12)
    gyro = np.float32([0.1, -0.2, 0.05])
    acc = np.float32([0.3, -9.7, 0.2])
    t = torch.from_numpy
    _close(imu.convolve_base_imu(t(d["base_mu"]), t(gyro), t(acc),
                                 torch.tensor(0.005), t(G_W)),
           jimu.convolve_base_imu(jnp.asarray(d["base_mu"]), gyro, acc,
                                  jnp.float32(0.005), jnp.asarray(G_W)), 1e-6)
