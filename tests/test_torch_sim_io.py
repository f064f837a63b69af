"""Parity of the port's numpy copies with the JAX package's originals:
the rendered sequence generator (ekf_vio_tpu_torch/sim/rendered.py, the
mono-inertial slice's workload) and the trajectory evaluation
(ekf_vio_tpu_torch/io/trajectory.py, its ATE gate).

Bars: every field of a generated sequence bitwise equal, at the default
320x240 arguments, at a 160x120 argument set and on the aggressive scene
(a few frames each); association, Umeyama and ATE bitwise equal on a
seeded trajectory, and the alignment recovers a known similarity
transform within 1e-9 (so a wrong sign or a wrong scale cannot pass
both sides unseen).
"""
import numpy as np
import pytest

from ekf_vio_tpu.io import trajectory as jtraj
from ekf_vio_tpu.sim import rendered as jrendered
from ekf_vio_tpu_torch.io import trajectory
from ekf_vio_tpu_torch.sim import rendered

GENERATORS = {
    "default": lambda m: m.generate(num_frames=4),
    "160x120": lambda m: m.generate(num_frames=3, w=160, h=120, f=130.0,
                                    fps=30.0, seed=3, plane_depth=(1.2, 3.0),
                                    exposure_drift=0.05),
    "aggressive": lambda m: m.generate_aggressive(num_frames=3),
}


@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_generate_bitwise(case):
    ours = GENERATORS[case](rendered)
    ref = GENERATORS[case](jrendered)
    assert ours._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _trajectories(seed, noise):
    """An estimate, and ground truth = s R estimate + t (+ noise), on
    timestamps offset by a few ms, with a few estimate stamps that match
    no ground truth."""
    rng = np.random.RandomState(seed)
    t_gt = np.arange(200) * 0.005
    p_gt_clean = np.cumsum(rng.normal(scale=0.01, size=(200, 3)), 0)
    s, R, t = 0.37 + rng.uniform(), _rotation(rng), rng.normal(size=3)
    # the estimate lives in its own frame: invert the similarity
    p_est_all = (p_gt_clean - t) @ R / s
    idx = np.arange(0, 200, 4)
    t_est = t_gt[idx] + rng.uniform(-0.002, 0.002, idx.size)
    t_est[-3:] += 1.0                               # no ground truth near
    p_gt = p_gt_clean + rng.normal(scale=noise, size=p_gt_clean.shape)
    return t_est, p_est_all[idx], t_gt, p_gt, (s, R, t)


def test_associate_bitwise():
    t_est, _, t_gt, _, _ = _trajectories(0, 0.0)
    ie, ig = trajectory.associate(t_est, t_gt)
    je, jg = jtraj.associate(t_est, t_gt)
    np.testing.assert_array_equal(ie, je)
    np.testing.assert_array_equal(ig, jg)
    assert ie.size == t_est.size - 3


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_bitwise_and_recovers_transform(with_scale):
    t_est, p_est, t_gt, p_gt, (s, R, t) = _trajectories(1, 0.0)
    ie, ig = trajectory.associate(t_est, t_gt)
    src, dst = p_est[ie], p_gt[ig]
    got = trajectory.umeyama(src, dst, with_scale)
    ref = jtraj.umeyama(src, dst, with_scale)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if with_scale:
        # the timestamps were jittered, so align the exact pairs instead
        exact = trajectory.umeyama(p_est, p_gt[np.arange(0, 200, 4)])
        np.testing.assert_allclose(exact[0], s, rtol=1e-9)
        np.testing.assert_allclose(exact[1], R, atol=1e-9)
        np.testing.assert_allclose(exact[2], t, atol=1e-9)
        assert np.linalg.det(exact[1]) > 0


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_ate_rmse_bitwise(noise):
    t_est, p_est, t_gt, p_gt, _ = _trajectories(2, noise)
    got = trajectory.ate_rmse(t_est, p_est, t_gt, p_gt)
    assert got == jtraj.ate_rmse(t_est, p_est, t_gt, p_gt)
    exact = trajectory.ate_rmse(t_gt[::4], p_est, t_gt, p_gt)
    # exact pairs: the residual is the noise alone (3 axes of sigma)
    assert exact < 1e-9 if noise == 0.0 else exact < 3 * np.sqrt(3) * noise
    assert (trajectory.relative_pose_error(t_est, p_est, t_gt, p_gt, 0.2)
            == jtraj.relative_pose_error(t_est, p_est, t_gt, p_gt, 0.2))
