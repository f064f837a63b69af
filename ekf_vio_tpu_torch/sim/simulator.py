"""Closed-loop synthetic simulator: the filter with no image pipeline.

Port of ``ekf_vio_tpu/sim/simulator.py`` (test/analyzeEKFSimulation.cpp
of the reference): a seeded random scene of 3D points in front of the
camera, ground-truth kinematics advanced with the filter's own motion
model, and noiseless projections with covariance diag(1e-5) fed back into
the update.  The scene is drawn with a ``torch.Generator`` where the JAX
package uses ``jax.random`` (the two draw different points from one
seed); ``run_scenario`` also takes the scene's points, so both packages
can run the same scene.  The rollout is ``scan.scan`` over ``predict`` /
``update`` on ``device`` (one captured CUDA graph of the step on the
card, a Python loop on the CPU); in square-root form the state carries
the factor L through the loop and is squared at the end, as in the JAX
package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ekf_vio_tpu_torch import scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core import lie, sqrt_filter
from ekf_vio_tpu_torch.engine import resolve_device, use_cusolver


class Scenario(NamedTuple):
    feature_count: int
    depth_sigma: float
    depth_mu: float
    b_vel: tuple
    b_accel: tuple
    omega: tuple
    dt: float
    tf: float


# The six scenarios of increasing difficulty of the reference's simulation
# program (test/analyzeEKFSimulation.cpp:232-244).
REFERENCE_SCENARIOS = [
    Scenario(30, 1e-6, 0.5, (0.5, 0, 0), (0, 0, 0), (0, 0, 0), 0.05, 0.5),
    Scenario(30, 1e-6, 0.5, (0.1, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 1e-6, 0.5, (0, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 0.01, 0.5, (0, 0, -0.1), (0, 0, 0), (0, 0, 0.1), 0.05, 5.0),
    Scenario(30, 0.01, 0.5, (-0.1, 0, -0.1), (0, 0, 0), (0, 0.1, 0), 0.05, 5.0),
    Scenario(100, 0.01, 0.5, (-0.1, 0, -0.1), (0, 0, 0), (0, 0.1, 0), 0.05, 5.0),
]


def generate_scene(generator: torch.Generator | None, scn: Scenario,
                   n_max: int):
    """Random points: depth ~ N(mu, sigma), u, v ~ U(-1.5, 1.5)·z
    (analyzeEKFSimulation.cpp:11-29), padded to n_max slots.  Drawn on
    the CPU from ``generator``.  Returns (points [n_max, 3], valid)."""
    z = scn.depth_mu + scn.depth_sigma * torch.randn(n_max,
                                                     generator=generator)
    uv = (torch.rand(n_max, 2, generator=generator) * 3.0 - 1.5) * z[:, None]
    pts = torch.cat([uv, z[:, None]], -1)  # camera-frame points
    return pts, torch.arange(n_max) < scn.feature_count


def project(points_w, pos, quat):
    """Project world points into the camera at (pos, quat)
    (analyzeEKFSimulation.cpp:101-125)."""
    qi = lie.quat_conj(quat)
    p_cam = lie.quat_rotate(qi, points_w) - lie.quat_rotate(qi, pos)[None]
    return p_cam[:, :2] / p_cam[:, 2:3]


class GroundTruth(NamedTuple):
    pos: torch.Tensor
    quat: torch.Tensor
    vel: torch.Tensor
    accel: torch.Tensor


def advance_ground_truth(gt: GroundTruth, omega, dt) -> GroundTruth:
    """Advance GT kinematics with the filter's motion model
    (analyzeEKFSimulation.cpp:57-84)."""
    pos = gt.pos + lie.quat_rotate(gt.quat,
                                   dt * gt.vel + 0.5 * dt * dt * gt.accel)
    dq = lie.quat_exp_omega(omega, dt)
    dqi = lie.quat_conj(dq)
    vel = lie.quat_rotate(dqi, gt.vel + dt * gt.accel)
    accel = lie.quat_rotate(dqi, gt.accel)
    quat = lie.quat_mul(gt.quat, dq)
    return GroundTruth(pos, quat, vel, accel)


def _closed_loop_step(carry, scn: Scenario, cfg: VIOConfig, pts, valid,
                      omega, meas_cov):
    """One step of the closed loop, a ``scan`` body: predict, advance the
    ground truth, project the scene, update.  ``carry`` is (state,
    GroundTruth); the output is (min_diag, asym, pos_err, feat_err)."""
    state, gt = carry
    sq = cfg.square_root_form  # the state carries L
    if sq:
        state = sqrt_filter.predict_sqrt_factor(state, cfg, scn.dt)
    else:
        state = ekf.predict(state, cfg, scn.dt)
    gt = advance_ground_truth(gt, omega, scn.dt)
    z = project(pts, gt.pos, gt.quat)
    if sq:
        state = sqrt_filter.update_sqrt_factor(state, cfg, z, meas_cov, valid)
        # diag(L Lᵀ) = row norms >= 0 by construction; L Lᵀ is exactly
        # symmetric
        min_diag = torch.min(sqrt_filter.sigma_diag_factor(state.Sigma))
        asym = torch.zeros((), device=state.device)
    else:
        state = ekf.update_with_feature_positions(state, cfg, z, meas_cov,
                                                  valid)
        min_diag, asym = ekf.check_sigma(state)
    pos_err = torch.linalg.vector_norm(state.base_mu[0:3] - gt.pos)
    feat_err = torch.sum(torch.where(
        valid, torch.linalg.vector_norm(state.feat_mu[:, :2] - z, dim=-1),
        0.0)) / torch.clamp(valid.sum(), min=1)
    return (state, gt), (min_diag, asym, pos_err, feat_err)


def run_scenario(scn: Scenario, cfg: VIOConfig, num_steps: int,
                 generator: torch.Generator | None = None, points=None,
                 device="cuda"):
    """Closed-loop rollout on ``device``, through ``scan`` (one captured
    CUDA graph of the step on the card; ``scn.dt`` is a constant of it).
    The scene is ``points`` ([N, 3] camera-frame points, the first
    ``scn.feature_count`` valid) when given, else ``generate_scene(
    generator, ...)``.  Returns (final state with a dense Σ, final
    GroundTruth, telemetry): telemetry is (min_diag, asym, pos_err,
    feat_err), each [num_steps]."""
    dev = resolve_device(device)
    use_cusolver(dev)
    n = cfg.max_features
    if points is None:
        points, _ = generate_scene(generator, scn, n)
    pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
    valid = torch.arange(n, device=dev) < scn.feature_count

    state = ekf.init_state(cfg, device=dev)
    state = ekf.add_features(state, cfg, pts[:, :2] / pts[:, 2:3], valid)
    omega = torch.tensor(scn.omega, dtype=torch.float32, device=dev)
    gt = GroundTruth(
        pos=torch.zeros(3, device=dev),
        quat=torch.tensor([1.0, 0, 0, 0], device=dev),
        vel=torch.tensor(scn.b_vel, dtype=torch.float32, device=dev),
        accel=torch.tensor(scn.b_accel, dtype=torch.float32, device=dev))
    meas_cov = (torch.eye(2, device=dev) * 1e-5).expand(n, 2, 2)

    if cfg.square_root_form:  # the loop carries L; squared at the end
        state = sqrt_filter.to_factor(state)
    (state, gt), telem = scan.scan(
        lambda c, _: _closed_loop_step(c, scn, cfg, pts, valid, omega,
                                       meas_cov),
        (state, gt), None, length=num_steps)
    if cfg.square_root_form:
        state = sqrt_filter.to_covariance(state)
    return state, gt, telem


def run_reference_scenarios(cfg: VIOConfig | None = None, seed: int = 0,
                            device="cuda"):
    """All six reference scenarios; a list of (scenario, state, gt,
    telemetry).  Scenario i draws its scene from a generator seeded with
    seed + i."""
    results = []
    for i, scn in enumerate(REFERENCE_SCENARIOS):
        c = (cfg or VIOConfig()).replace(
            max_features=max(scn.feature_count, 32))
        gen = torch.Generator().manual_seed(seed + i)
        state, gt, telem = run_scenario(scn, c, int(round(scn.tf / scn.dt)),
                                        generator=gen, device=device)
        results.append((scn, state, gt, telem))
    return results
