"""Engine: the per-frame VIO pipeline, vision-only, covariance form.

Port of ``ekf_vio_tpu/engine.py`` (the orchestrator's addFrame,
EKFVIO.cpp:139-196):

    predict(dt) → KLT track seeded at the EKF-predicted positions →
    masked EKF update → drop failed features → FAST replenishment

``step`` is one frame over an ``EngineState`` of tensors; it reads
nothing back from the device (no ``.item()``, no boolean-mask indexing,
no ``if`` on a tensor), so a later change can capture it in a CUDA graph.
``run_sequence`` bootstraps on frame 0 and loops over the rest in Python.
Each layer of ``step`` runs in a ``vio.*`` ``record_function`` span, so a
``torch.profiler`` trace attributes host and device time per layer.
Branches that are not ported yet raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core.update import innovation_nis
from ekf_vio_tpu_torch.frontend import camera as cam_mod
from ekf_vio_tpu_torch.frontend import klt, pyramid, replenish
from ekf_vio_tpu_torch.frontend.camera import Camera


@dataclasses.dataclass
class EngineState:
    filt: ekf.FilterState
    prev_pyr: tuple           # pyramid of the previous processed frame
    frame_idx: torch.Tensor   # int32 — frames processed so far
    lin_base: torch.Tensor    # [22] base state as predicted at this frame


class StepOutputs(NamedTuple):
    base_mu: torch.Tensor        # [22]
    num_tracked: torch.Tensor    # features that passed this frame
    num_active: torch.Tensor     # live features after replenishment
    mean_innovation: torch.Tensor
    pose_cov_diag: torch.Tensor  # [7] position + quaternion variance
    tracking_lost: torch.Tensor  # bool — too few tracks or non-finite state
    pos_cov: torch.Tensor        # [3, 3]
    mean_nis: torch.Tensor       # mean per-feature NIS, pre-update


def use_f32_matmul() -> None:
    """Run matmuls and convolutions in true f32: TF32 keeps ~3 decimal
    digits, which the covariance's 1e-5..1e2 spectrum cannot afford (the
    GPU twin of the JAX package's bf16 finding)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_slice(cfg: VIOConfig) -> None:
    """Reject the options this port does not run yet."""
    off_slice = {
        "square_root_form": cfg.square_root_form,
        "triangulate_new_features": cfg.triangulate_new_features,
        "innovation_gate_chi2 > 0": cfg.innovation_gate_chi2 > 0,
        "min_eigen_rel_gate > 0": cfg.min_eigen_rel_gate > 0,
        "klt_covariance == 'sample'": cfg.klt_covariance == "sample",
    }
    for name, on in off_slice.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")


def initialize(img: torch.Tensor, t, cfg: VIOConfig,
               cam: Camera) -> EngineState:
    """First-frame bootstrap (EKFVIO.cpp:141-153): start the filter clock
    and detect the initial feature set on ``img``'s device."""
    use_f32_matmul()
    _check_slice(cfg)
    dev = img.device
    filt = ekf.init_state(cfg, device=dev)
    filt = filt.replace(t=torch.as_tensor(t, dtype=filt.t.dtype,
                                          device=dev).reshape(()))
    n = cfg.max_features
    px, valid = replenish.replenish(
        img, torch.zeros(n, 2, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev), cfg, n)
    uv = cam_mod.pixel_to_metric(cam, px)
    filt = ekf.add_features(filt, cfg, uv, valid)
    filt = filt.replace(klt_ref=torch.where(valid[:, None], uv, filt.klt_ref))
    pyr = pyramid.build_pyramid(img, cfg.klt_max_pyramid_level)
    return EngineState(filt=filt, prev_pyr=pyr,
                       frame_idx=torch.ones((), dtype=torch.int32, device=dev),
                       lin_base=filt.base_mu)


def _recover_tracking_lost(filt: ekf.FilterState, cfg: VIOConfig,
                           lost: torch.Tensor) -> ekf.FilterState:
    """Re-bootstrap when tracking collapses (the action on the flag the
    reference only logs, EKFVIO.cpp:192): keep pose and biases, free every
    slot, wipe all cross-correlations and re-inflate the kinematic
    variances.  Every field is selected by ``torch.where`` on ``lost``."""
    dtype, dev = filt.Sigma.dtype, filt.device
    n = filt.n_max
    init_mu = torch.zeros(22, dtype=dtype, device=dev)
    init_mu[3] = 1.0
    base = torch.where(torch.isfinite(filt.base_mu), filt.base_mu, init_mu)
    qn = torch.linalg.vector_norm(base[3:7])
    q = torch.where(qn > 1e-6, base[3:7] / torch.clamp(qn, min=1e-6),
                    init_mu[3:7])
    base = torch.cat([base[:3], q, base[7:]])

    diag = torch.diagonal(filt.Sigma)

    def safe(d, fallback):
        return torch.clamp(torch.where(torch.isfinite(d), d, fallback), min=0.0)

    sig_diag = torch.cat([
        safe(diag[:7], cfg.init_pose_variance),
        torch.full((9,), cfg.init_kinematic_variance, dtype=dtype, device=dev),
        safe(diag[16:22], cfg.init_bias_variance),
        torch.zeros(3 * n, dtype=dtype, device=dev),
    ])
    rec = filt.replace(base_mu=base,
                       active=torch.zeros_like(filt.active),
                       Sigma=torch.diag(sig_diag),
                       age=torch.zeros_like(filt.age))
    return ekf.FilterState(**{
        f.name: torch.where(lost, getattr(rec, f.name), getattr(filt, f.name))
        for f in dataclasses.fields(ekf.FilterState)})


def step(estate: EngineState, img: torch.Tensor, t: torch.Tensor,
         cfg: VIOConfig, cam: Camera, imu_batch=None):
    """One frame (steady-state branch of addFrame, EKFVIO.cpp:154-173),
    vision-only.  Returns (new EngineState, StepOutputs)."""
    if imu_batch is not None:
        raise NotImplementedError("the IMU (mono-inertial) step is not "
                                  "ported yet")
    _check_slice(cfg)

    filt = estate.filt
    filt = filt.replace(age=torch.where(filt.active, filt.age + 1, 0))
    dt = torch.clamp(t - filt.t, min=0.0)  # dt >= 0 (EKFVIO.cpp:162)

    # --- predict (process, EKFVIO.cpp:163)
    with record_function("vio.predict"):
        filt = ekf.predict(filt, cfg, dt)
    filt = filt.replace(t=t.to(filt.t.dtype))
    new_lin_base = filt.base_mu

    # --- track (updateStateWithNewImage, EKFVIO.cpp:207-219)
    with record_function("vio.pyramid"):
        cur_pyr = pyramid.build_pyramid(img, cfg.klt_max_pyramid_level)
    with record_function("vio.track"):
        prev_px = cam_mod.metric_to_pixel(cam, filt.klt_ref)
        seed_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
        res = klt.track(estate.prev_pyr, cur_pyr, prev_px, seed_px,
                        filt.active, cfg)
        passed = res.status & cam_mod.in_kill_box(cam, res.points,
                                                  cfg.kill_pad)

    # --- update, then failed features free their slots
    # (TightlyCoupledEKF.cpp:525-529)
    with record_function("vio.update"):
        measured_uv = cam_mod.pixel_to_metric(cam, res.points)
        meas_cov = klt.measurement_covariance_metric(
            cam.fx, cam.fy, cfg.max_features, cfg, device=img.device)
        innov = ekf.innovation_stats(filt, measured_uv, passed)
        nis = innovation_nis(filt, measured_uv, meas_cov, passed)
        filt = ekf.update_with_feature_positions(filt, cfg, measured_uv,
                                                 meas_cov, passed)
        num_tracked = torch.sum(passed & filt.active, dtype=torch.int32)
        filt = ekf.drop_features(filt, filt.active & ~passed)

    # tracking lost: too few surviving tracks or a non-finite state
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(filt.base_mu).all()
            | ~torch.isfinite(torch.diagonal(filt.Sigma)).all())
    if cfg.recover_on_tracking_lost:
        filt = _recover_tracking_lost(filt, cfg, lost)
        new_lin_base = torch.where(lost, filt.base_mu, new_lin_base)

    # --- replenish (EKFVIO.cpp:224-311)
    with record_function("vio.replenish"):
        feat_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
        cand_px, cand_valid = replenish.replenish(img, feat_px, filt.active,
                                                  cfg, cfg.max_features)
        cand_uv = cam_mod.pixel_to_metric(cam, cand_px)
        filt = ekf.add_features(filt, cfg, cand_uv, cand_valid)

    out = StepOutputs(
        base_mu=filt.base_mu,
        num_tracked=num_tracked,
        num_active=filt.num_active(),
        mean_innovation=innov,
        pose_cov_diag=torch.diagonal(filt.Sigma)[:7],
        tracking_lost=lost,
        pos_cov=filt.Sigma[:3, :3],
        mean_nis=nis,
    )
    return EngineState(filt=filt, prev_pyr=cur_pyr,
                       frame_idx=estate.frame_idx + 1,
                       lin_base=new_lin_base), out


def run_sequence(images: torch.Tensor, times: torch.Tensor, cfg: VIOConfig,
                 cam: Camera):
    """Whole-sequence rollout on ``images``' device: bootstrap on frame 0,
    then one ``step`` per frame.

    images: [T, H, W] processed-scale grayscale f32; times: [T] f32.
    Returns (final EngineState, StepOutputs stacked over frames 1..T-1)."""
    use_f32_matmul()
    estate = initialize(images[0], times[0], cfg, cam)
    outs = []
    for i in range(1, images.shape[0]):
        estate, out = step(estate, images[i], times[i], cfg, cam)
        outs.append(out)
    stacked = StepOutputs(*(torch.stack(field) for field in zip(*outs)))
    return estate, stacked
