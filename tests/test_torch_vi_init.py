"""Parity of the port's visual-inertial initialization
(ekf_vio_tpu_torch/core/vi_init.py) with the JAX package on the CPU.

Its own file, at small sizes: the XLA-CPU compile of the JAX module's
vmapped ``jacfwd`` has segfaulted whole-suite runs.  Inputs: the IMU
stream of a rendered 160x120 sequence and tracks of random scene points
projected along its ground truth, from a numpy seed.

Bars: the integrated rotations and translations within 1e-5, the aligned
v0, depths and biases within 1e-3 relative (a 3x3 normal-equation solve
amplifies f32 roundoff of sums taken in another order), depth_ok equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.core import vi_init as jvi
from ekf_vio_tpu_torch.core import vi_init
from ekf_vio_tpu_torch.sim import rendered
from test_torch_core import _close

K, N = 6, 24


@pytest.fixture(scope="module")
def scene():
    seq = rendered.generate(num_frames=K, w=160, h=120, f=130.0)
    rng = np.random.RandomState(2)
    pts = np.stack([rng.uniform(-0.8, 0.8, N), rng.uniform(-0.6, 0.6, N),
                    np.full(N, 2.0)], -1)
    h = np.zeros((K, N, 2))
    for i in range(K):
        R = np.array(_rot(seq.gt_quat[i]))
        pc = (pts - seq.gt_pos[i]) @ R          # camera frame: Rᵀ(p − c)
        h[i] = pc[:, :2] / pc[:, 2:3]
    h = (h + rng.normal(scale=2e-4, size=h.shape)).astype(np.float32)
    valid = np.ones((K, N), bool)
    valid[3:, :3] = False                        # lost tracks
    return seq, h, valid


def _rot(q):
    w, x, y, z = q
    return [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]


def _imu(seq):
    return (seq.times, seq.imu_dt, seq.imu_gyro, seq.imu_accel,
            seq.gravity_w)


def test_integrate_motion_matches_jax(scene):
    seq, _, _ = scene
    bg = np.float32([0.002, -0.001, 0.003])
    ba = np.float32([0.02, -0.015, 0.01])
    v0 = np.float32([0.01, -0.02, 0.005])
    got = vi_init.integrate_motion(
        *(torch.from_numpy(a) for a in _imu(seq)), v0=torch.from_numpy(v0),
        gyro_bias=torch.from_numpy(bg), accel_bias=torch.from_numpy(ba))
    ref = jvi.integrate_motion(*(jnp.asarray(a) for a in _imu(seq)),
                               v0=jnp.asarray(v0), gyro_bias=jnp.asarray(bg),
                               accel_bias=jnp.asarray(ba))
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)


def test_align_and_reprojection_match_jax(scene):
    seq, h, valid = scene
    R, tc, tau, _ = jvi.integrate_motion(*(jnp.asarray(a)
                                           for a in _imu(seq)))
    ref = jvi.align(jnp.asarray(h), jnp.asarray(valid), R, tc, tau)
    got = vi_init.align(torch.from_numpy(h), torch.from_numpy(valid),
                        *(torch.tensor(np.asarray(a)) for a in (R, tc, tau)))
    np.testing.assert_array_equal(got.depth_ok.numpy(),
                                  np.asarray(ref.depth_ok))
    assert got.depth_ok.sum() >= N - 3
    _close(got.v0_world, ref.v0_world, 1e-3)
    _close(got.depths0, ref.depths0, 1e-3)
    _close(vi_init.reprojection_errors(got, torch.from_numpy(h),
                                       torch.from_numpy(valid)),
           jvi.reprojection_errors(ref, jnp.asarray(h), jnp.asarray(valid)),
           1e-4)


@pytest.mark.parametrize("accel_bias", [True, False])
def test_align_with_gyro_bias_matches_jax(scene, accel_bias):
    seq, h, valid = scene
    got, bg, ba = vi_init.align_with_gyro_bias(
        *(torch.from_numpy(a) for a in _imu(seq)), torch.from_numpy(h),
        torch.from_numpy(valid), rounds=2, estimate_accel_bias=accel_bias)
    ref, rbg, rba = jvi.align_with_gyro_bias(
        *(jnp.asarray(a) for a in _imu(seq)), jnp.asarray(h),
        jnp.asarray(valid), rounds=2, estimate_accel_bias=accel_bias)
    np.testing.assert_array_equal(got.depth_ok.numpy(),
                                  np.asarray(ref.depth_ok))
    _close(bg, rbg, 1e-3)
    _close(ba, rba, 1e-3)
    _close(got.v0_world, ref.v0_world, 1e-3)
    _close(got.depths0, ref.depths0, 1e-3)
    if not accel_bias:
        assert not ba.any()
