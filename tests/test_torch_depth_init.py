"""Parity of the port's two-view depth initialization
(ekf_vio_tpu_torch/core/depth_init.py) with the JAX package on the CPU,
on observations of random points under a random motion, from a numpy
seed (some with no parallax, some behind the camera).

Bars: masks equal; depths within 1e-4 of the largest depth (the closed
form divides by the squared ray-crossing magnitude, which amplifies the
f32 roundoff of the cross products by 1/parallax, and 5 Gauss-Newton
steps follow); relative sigmas within 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import depth_init as jdi
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import depth_init
from test_torch_core import _base, _close

N = 32


def _views(seed):
    rng = np.random.RandomState(seed)
    ang = rng.normal(scale=0.05, size=3)
    th = np.linalg.norm(ang)
    k = np.array([[0, -ang[2], ang[1]], [ang[2], 0, -ang[0]],
                  [-ang[1], ang[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
    t = rng.normal(scale=0.05, size=3)
    p1 = np.stack([rng.uniform(-1, 1, N), rng.uniform(-0.8, 0.8, N),
                   rng.uniform(0.5, 6.0, N)], -1)
    p2 = p1 @ R.T + t
    h1 = p1[:, :2] / p1[:, 2:3]
    h2 = p2[:, :2] / p2[:, 2:3] + rng.normal(scale=1e-3, size=(N, 2))
    rh1 = np.concatenate([h1[:4], np.ones((4, 1))], -1) @ R.T
    h2[:4] = rh1[:, :2] / rh1[:, 2:3]    # rotation only: no parallax
    h2[4] = [5.0, -5.0]                  # inconsistent: a bad depth
    f = np.float32
    return f(h1), f(h2), f(R), f(t)


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_and_refined_depth_match_jax(seed):
    h1, h2, R, t = _views(seed)
    tt = torch.from_numpy
    z, ok = depth_init.linear_depth(tt(h1), tt(h2), tt(R), tt(t))
    rz, rok = jdi.linear_depth(jnp.asarray(h1), jnp.asarray(h2),
                               jnp.asarray(R), jnp.asarray(t))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    assert 10 < int(ok.sum()) < N
    _close(torch.where(ok, z, 0.0), np.where(np.asarray(rok), rz, 0.0), 1e-4)
    z0 = torch.where(ok, z, 0.5)
    _close(depth_init.refine_depth_gn(tt(h1), tt(h2), tt(R), tt(t), z0),
           jdi.refine_depth_gn(jnp.asarray(h1), jnp.asarray(h2),
                               jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(z0.numpy())), 1e-4)


@pytest.mark.parametrize("with_rt", [True, False])
def test_triangulate_depths_and_confidence_match_jax(with_rt):
    h1, h2, R, t = _views(2)
    base = _base(np.random.RandomState(3))
    base[7:16] *= 0.2
    dt = np.float32(0.05)
    tt = torch.from_numpy
    got = depth_init.triangulate_depths(
        tt(h1), tt(h2), tt(base), torch.tensor(dt), 0.5,
        Rt=(tt(R), tt(t)) if with_rt else None, return_rel_sigma=True)
    ref = jdi.triangulate_depths(
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(base), dt, 0.5,
        Rt=(jnp.asarray(R), jnp.asarray(t)) if with_rt else None,
        return_rel_sigma=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(got[0], ref[0], 1e-4)
    _close(got[2], ref[2], 1e-5)
    for exact in (True, False):
        for cfg, jcfg in ((VIOConfig(), JConfig()),
                          (VIOConfig(klt_measurement_variance_px=0.001),
                           JConfig(klt_measurement_variance_px=0.001))):
            ok, rel = depth_init.triangulation_confidence(
                cfg, 130.0, 128.5, got[2], exact_baseline=exact)
            rok, rrel = jdi.triangulation_confidence(
                jcfg, 130.0, 128.5, jnp.asarray(got[2].numpy()),
                exact_baseline=exact)
            np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
            _close(rel, rrel, 1e-6)


def test_relative_motion_matches_jax():
    base = _base(np.random.RandomState(4))
    R, t = depth_init.relative_motion(torch.from_numpy(base),
                                      torch.tensor(0.05))
    rR, rt = jdi.relative_motion(jnp.asarray(base), jnp.float32(0.05))
    _close(R, rR, 1e-6)
    _close(t, rt, 1e-6)
