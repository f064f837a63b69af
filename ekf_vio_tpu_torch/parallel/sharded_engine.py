"""The full per-frame VIO pipeline on the split-Σ state.

Port of ``ekf_vio_tpu/parallel/sharded_engine.py``.  The image front end
(pyramid, KLT through ``klt.track`` and the ``lk_level`` kernel, FAST
through ``replenish`` and the ``fast9`` kernel) runs whole on every rank
of the ``state`` group: it is O(HW) work on frames every rank holds.
Every O(D²)-and-up covariance product runs on the rank's Σ blocks
through ``parallel/sharded_filter.py`` (BASELINE.json config 5 for the
whole per-frame pipeline).  The frame flow mirrors the JAX module's (and
so ``engine.step``, EKFVIO.cpp:139-196): IMU remainder as a sample,
the structure and χ² gates, the IMU-mode depth bootstrap, the at-birth
two-view depths in vision mode only, tracking-lost recovery before
replenishment.  The parts that touch no Σ block are ``engine``'s own
helpers (``_track_and_gate``, ``_depth_boot_select``,
``_two_view_depths``, ``_replenish_candidates`` and the recovered base
state); only the covariance operations differ.  The reference defect ``mean_nis = 0.0`` is reproduced.

``step`` reads nothing back to the host.  ``run_sequence`` and
``run_sequence_imu`` run it over the frames on the mesh's device: on a
NCCL mesh through ``scan.scan`` (one captured CUDA graph of the step and
its collectives, replayed once a frame), as the port's ``engine`` does;
on a gloo mesh through ``scan.loop``, since gloo runs its collectives on
host threads, which no CUDA graph can capture.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch import engine, scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core.state import register_dataclass_pytree
from ekf_vio_tpu_torch.frontend import klt
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.parallel import sharded_filter as sf
from ekf_vio_tpu_torch.parallel.mesh import (all_gather, all_true, axis,
                                             capturable, mesh_device)


@dataclasses.dataclass
class ShardedEngineState:
    filt: sf.ShardedFilterState
    prev_pyr: tuple           # pyramid of the previous processed frame
    frame_idx: torch.Tensor   # int32
    lin_base: torch.Tensor    # FEJ anchor (engine.EngineState.lin_base)


register_dataclass_pytree(ShardedEngineState)


def _from_dense(dense: engine.EngineState,
                mesh: DeviceMesh) -> ShardedEngineState:
    return ShardedEngineState(filt=sf.split_state(dense.filt, mesh),
                              prev_pyr=dense.prev_pyr,
                              frame_idx=dense.frame_idx,
                              lin_base=dense.filt.base_mu)


def initialize(img, t, cfg: VIOConfig, cam: Camera,
               mesh: DeviceMesh) -> ShardedEngineState:
    """First-frame bootstrap (``engine.initialize``), then this rank's
    blocks of Σ."""
    return _from_dense(engine.initialize(img, t, cfg, cam,
                                         device=mesh_device(mesh)), mesh)


def step(estate: ShardedEngineState, img, t, cfg: VIOConfig, cam: Camera,
         mesh: DeviceMesh, imu_batch: imu_mod.ImuSample | None = None,
         gravity_w=None):
    """One full frame on the split state (the analog of ``engine.step``).
    Returns (ShardedEngineState, engine.StepOutputs)."""
    filt = estate.filt
    dev = filt.bb.device
    img = engine._f32(img, dev)
    t = engine._f32(t, dev)
    filt = filt.replace(age=torch.where(filt.active, filt.age + 1, 0))
    dt = torch.clamp(t - filt.t, min=0.0)

    # --- predict
    frame_qt = None
    if imu_batch is not None:
        lin = estate.lin_base if cfg.use_fej else None
        # the interval's remainder as a zero-order-hold sample
        rem = torch.clamp(t - (filt.t + torch.sum(imu_batch.dt)), min=0.0)
        batch = imu_mod.extend_batch_with_remainder(imu_batch, rem)
        filt, frame_qt = sf.sharded_propagate_imu_batch(
            filt, cfg, batch, gravity_w, mesh, lin_base=lin)
    else:
        filt = sf.sharded_predict(filt, cfg, dt, mesh)
    filt = filt.replace(t=t.to(filt.t.dtype))
    new_lin_base = filt.base_mu

    # --- track and gate (the front end, whole on every rank)
    cur_pyr, _, _, passed, measured_uv = engine._track_and_gate(
        estate.prev_pyr, filt, img, cfg, cam,
        lambda uv: _innovation_nis_sharded(filt, cfg, uv, cam, mesh))

    if imu_batch is not None and cfg.triangulate_new_features:
        # depth bootstrap (engine.step's re-init of young wrong-depth
        # features): wipe ρ rows/cols of Σ, set the triangulated prior
        boot, sig_tri, rho = engine._depth_boot_select(
            filt, cfg, cam, measured_uv, passed, dt, frame_qt)
        zb = torch.zeros_like(boot)
        wipe3 = torch.stack([zb, zb, boot], -1).reshape(-1)
        zf = torch.zeros_like(sig_tri)
        diag3 = torch.stack(
            [zf, zf, torch.where(boot, sig_tri * sig_tri, 0.0)], -1)
        filt = sf.sigma_slot_reset(filt, wipe3, diag3.to(filt.bb.dtype),
                                   mesh)
        filt = filt.replace(feat_mu=torch.cat([filt.feat_mu[:, :2],
                                               rho[:, None]], 1))

    # --- update
    meas_cov = klt.measurement_covariance_metric(cam.fx, cam.fy,
                                                 cfg.max_features, cfg,
                                                 device=dev)
    innov = ekf.innovation_stats(filt, measured_uv, passed)
    filt = sf.sharded_update(filt, cfg, measured_uv, meas_cov, passed, mesh)
    num_tracked = torch.sum(passed & filt.active, dtype=torch.int32)
    filt = sf.sharded_drop_features(filt, filt.active & ~passed, mesh)

    # --- failure detection + recovery (before replenish, as engine.step)
    g, k, _ = axis(mesh, sf.AXIS)
    n3b = filt.ff.shape[0]
    ff_finite = all_true(torch.isfinite(filt.ff.diagonal(k * n3b)).all(), g)
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(filt.base_mu).all()
            | ~torch.isfinite(torch.diagonal(filt.bb)).all()
            | ~ff_finite)
    if cfg.recover_on_tracking_lost:
        filt = _recover_tracking_lost(filt, cfg, lost)
        new_lin_base = torch.where(lost, filt.base_mu, new_lin_base)

    # --- replenish
    cand_px, cand_valid, cand_uv = engine._replenish_candidates(img, filt,
                                                                cfg, cam)
    depths = depth_vars = None
    if cfg.triangulate_new_features and imu_batch is None:
        # at-birth two-view depths, vision-only mode (the IMU mode's
        # per-frame bootstrap above covers the transient)
        depths, depth_vars = engine._two_view_depths(
            filt, cfg, cam, estate.prev_pyr, cur_pyr, cand_px, cand_uv,
            cand_valid, dt)
    filt = sf.sharded_add_features(filt, cfg, cand_uv, cand_valid, mesh,
                                   depths=depths, depth_vars=depth_vars)

    out = engine.StepOutputs(
        base_mu=filt.base_mu,
        num_tracked=num_tracked,
        num_active=torch.sum(filt.active, dtype=torch.int32),
        mean_innovation=innov,
        pose_cov_diag=torch.diagonal(filt.bb)[:7],
        tracking_lost=lost,
        pos_cov=filt.bb[:3, :3],
        # the reference defect: consistency telemetry on the dense path only
        mean_nis=torch.zeros((), dtype=torch.float32, device=dev),
    )
    return ShardedEngineState(filt=filt, prev_pyr=cur_pyr,
                              frame_idx=estate.frame_idx + 1,
                              lin_base=new_lin_base), out


def _innovation_nis_sharded(filt: sf.ShardedFilterState, cfg: VIOConfig,
                            measured_uv, cam: Camera,
                            mesh: DeviceMesh) -> torch.Tensor:
    """[N] per-feature NIS on the split state (the statistic of
    ``update.innovation_nis_per_feature`` with constant metric R): each
    rank reads the 2x2 uv blocks of its features off the diagonal of its
    ff rows; one all-gather assembles the [N, 2, 2] blocks."""
    g, k, _ = axis(mesh, sf.AXIS)
    nb_feat = filt.ff.shape[0] // 3
    n = filt.n_max
    rows = filt.ff.reshape(nb_feat, 3, n, 3)[:, :2, :, :2]    # [Nb,2,N,2]
    mine = torch.arange(nb_feat, device=rows.device) + k * nb_feat
    Suv = all_gather(rows[torch.arange(nb_feat), :, mine], g, dim=0)
    r = cfg.klt_measurement_variance_px
    Rm = torch.tensor([[r / (cam.fx * cam.fx), 0.0],
                       [0.0, r / (cam.fy * cam.fy)]], device=Suv.device)
    S = Suv + Rm[None]
    y = measured_uv - filt.feat_mu[:, :2]
    det = torch.clamp(S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0],
                      min=1e-30)
    return (S[:, 1, 1] * y[:, 0] ** 2 - 2 * S[:, 0, 1] * y[:, 0] * y[:, 1]
            + S[:, 0, 0] * y[:, 1] ** 2) / det


def _recover_tracking_lost(filt: sf.ShardedFilterState, cfg: VIOConfig,
                           lost) -> sf.ShardedFilterState:
    """``engine._recover_tracking_lost`` on the split state: keep pose and
    biases, free every slot, wipe every cross-correlation (bf, ff),
    re-inflate the kinematic variances; every field selected by
    ``torch.where`` on ``lost``."""
    base = engine._recovered_base(filt.base_mu)
    bb_diag = engine._recovered_base_variances(torch.diagonal(filt.bb), cfg)
    rec = filt.replace(base_mu=base, active=torch.zeros_like(filt.active),
                       bb=torch.diag(bb_diag), bf=torch.zeros_like(filt.bf),
                       ff=torch.zeros_like(filt.ff),
                       age=torch.zeros_like(filt.age))
    return sf.ShardedFilterState(**{
        f.name: torch.where(lost, getattr(rec, f.name), getattr(filt, f.name))
        for f in dataclasses.fields(sf.ShardedFilterState)})


def _rollout(mesh: DeviceMesh):
    """``scan.scan`` on a NCCL mesh, ``scan.loop`` on a gloo one."""
    return scan.scan if capturable(mesh) else scan.loop


def run_sequence(images, times, cfg: VIOConfig, cam: Camera,
                 mesh: DeviceMesh):
    """Vision-only rollout on the split state: ``initialize`` on frame 0,
    then one ``step`` per frame.  Returns (final ShardedEngineState,
    StepOutputs stacked over frames 1..T-1)."""
    dev = mesh_device(mesh)
    images, times = engine._f32(images, dev), engine._f32(times, dev)
    estate = initialize(images[0], times[0], cfg, cam, mesh)
    return _rollout(mesh)(
        lambda es, x: step(es, x[0], x[1], cfg, cam, mesh), estate,
        (images[1:], times[1:]))


def run_sequence_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                     cfg: VIOConfig, cam: Camera, mesh: DeviceMesh,
                     init_frames: int = 0):
    """Mono-inertial rollout on the split state (the analog of
    ``engine.run_sequence_imu``): the closed-form VI initialization runs
    whole on every rank (O(N) work on a few frames), then the state
    splits and every frame runs the sharded ``step``."""
    dev = mesh_device(mesh)
    images, times = engine._f32(images, dev), engine._f32(times, dev)
    imu_dt, imu_gyro = engine._f32(imu_dt, dev), engine._f32(imu_gyro, dev)
    imu_accel = engine._f32(imu_accel, dev)
    gravity_w = engine._f32(gravity_w, dev)
    if init_frames > 1:
        dense = engine.initialize_imu(images, times, imu_dt, imu_gyro,
                                      imu_accel, gravity_w, cfg, cam,
                                      init_frames, device=dev)
        start = init_frames
    else:
        dense = engine.initialize(images[0], times[0], cfg, cam, device=dev)
        start = 1
    estate = _from_dense(dense, mesh)

    def body(es, x):
        img, t, dt, gyro, accel = x
        return step(es, img, t, cfg, cam, mesh,
                    imu_batch=imu_mod.ImuSample(dt=dt, gyro=gyro,
                                                accel=accel),
                    gravity_w=gravity_w)

    return _rollout(mesh)(body, estate, engine.imu_frames(
        images, times, imu_dt, imu_gyro, imu_accel, start))
