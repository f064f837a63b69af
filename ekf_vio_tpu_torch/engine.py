"""Engine: the per-frame VIO pipeline, in covariance or square-root form.

Port of ``ekf_vio_tpu/engine.py`` (the orchestrator's addFrame,
EKFVIO.cpp:139-196):

    predict(dt) or IMU propagation → KLT track seeded at the predicted
    positions → gates → (IMU depth bootstrap) → masked EKF update → drop
    failed features → FAST replenishment (with two-view depths)

``step`` is one frame over an ``EngineState`` of tensors; it reads
nothing back from the device (no ``.item()``, no boolean-mask indexing,
no ``if`` on a tensor) and builds no tensor from host data, so a CUDA
graph can capture it.  ``run_sequence`` (vision-only) and
``run_sequence_imu`` (mono-inertial, with the closed-form VI
initialization of ``initialize_imu``) run it over the frames through
``scan.scan``: on the card one captured graph of ``step``, replayed once
a frame (the JAX package's ``jax.jit`` + ``lax.scan``); on the CPU a
Python loop.  The entry points run on the card unless the
caller passes ``device="cpu"``.  Each layer of ``step`` runs in a
``vio.*`` ``record_function`` span, so a ``torch.profiler`` trace
attributes host and device time per layer.  With
``VIOConfig.square_root_form`` the state's ``Sigma`` field holds the lower
Cholesky factor L across frames (core/sqrt_filter.py): factored once at
initialization, then predict, update, drop, add and the depth bootstrap
all act on L.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ekf_vio_tpu_torch import scan
from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import depth_init
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import lie, sqrt_filter, vi_init
from ekf_vio_tpu_torch.core.state import (device_constant,
                                          register_dataclass_pytree)
from ekf_vio_tpu_torch.core.update import (innovation_nis,
                                           innovation_nis_per_feature)
from ekf_vio_tpu_torch.frontend import camera as cam_mod
from ekf_vio_tpu_torch.frontend import klt, pyramid, replenish
from ekf_vio_tpu_torch.frontend.camera import Camera


@dataclasses.dataclass
class EngineState:
    filt: ekf.FilterState
    prev_pyr: tuple           # pyramid of the previous processed frame
    frame_idx: torch.Tensor   # int32 — frames processed so far
    lin_base: torch.Tensor    # [22] base state as predicted at this frame


register_dataclass_pytree(EngineState)


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


def use_cusolver(dev: torch.device) -> None:
    """On the card, every factorization in cuSOLVER: for batched ones
    (vmapped lanes) PyTorch's default is MAGMA, whose queue set-up calls
    cudaMalloc, which a capturing stream refuses (scan.py).  Like
    ``use_f32_matmul``, a setting of the whole process, made by the entry
    points whose rollouts ``scan`` captures."""
    if dev.type == "cuda":
        torch.backends.cuda.preferred_linalg_library("cusolver")


def _filter_sigma_diag(filt: ekf.FilterState,
                       cfg: VIOConfig) -> torch.Tensor:
    """diag(Σ) for either state form (factor mode stores L in .Sigma)."""
    if cfg.square_root_form:
        return sqrt_filter.sigma_diag_factor(filt.Sigma)
    return torch.diagonal(filt.Sigma)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU, and an error rather than a silent CPU run without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def initialize(img, t, cfg: VIOConfig, cam: Camera,
               device="cuda") -> EngineState:
    """First-frame bootstrap (EKFVIO.cpp:141-153): start the filter clock
    and detect the initial feature set, on ``device``."""
    use_f32_matmul()
    dev = resolve_device(device)
    use_cusolver(dev)
    img = _f32(img, dev)
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
    if cfg.square_root_form:  # factor once; the loop never re-factors
        filt = sqrt_filter.to_factor(filt)
    pyr = pyramid.build_pyramid(img, cfg.klt_max_pyramid_level)
    return EngineState(filt=filt, prev_pyr=pyr,
                       frame_idx=torch.ones((), dtype=torch.int32, device=dev),
                       lin_base=filt.base_mu)


def _rel_eig_keep(min_eig: torch.Tensor, mask: torch.Tensor,
                  rel: float) -> torch.Tensor:
    """Keep mask of the relative min-eigen structure gate: min_eig above
    (median over ``mask`` features) / rel.  With no masked feature the
    median is NaN and every comparison is False."""
    med = torch.nanquantile(torch.where(mask, min_eig, torch.nan), 0.5)
    return min_eig > med / rel


def _rho_vec(vals: torch.Tensor, n: int) -> torch.Tensor:
    """[D] vector with ``vals`` at the ρ slots (22 + 3i + 2), else 0."""
    z = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return torch.cat([torch.zeros(BASE_STATE_SIZE, dtype=vals.dtype,
                                  device=vals.device),
                      torch.stack([z, z, vals], -1).reshape(-1)])


def _depth_boot_select(filt, cfg: VIOConfig, cam: Camera, measured_uv,
                       passed, dt, frame_qt):
    """The IMU-mode depth bootstrap's choice (engine.py:240-293), on a
    dense or a split state: young tracked features whose depth,
    triangulated against the exact IMU baseline ``frame_qt``, disagrees
    with their estimate.  Returns (boot [N] bool, the new ρ σ [N], ρ [N]
    with the booted slots re-initialized)."""
    Rt = (lie.quat_to_matrix(frame_qt[0:4]), frame_qt[4:7])
    z_boot, tri_ok, rel_sig = depth_init.triangulate_depths(
        filt.klt_ref, measured_uv, filt.base_mu, dt, cfg.default_point_depth,
        Rt=Rt, return_rel_sigma=True)
    rho_new = 1.0 / z_boot
    good, rel = depth_init.triangulation_confidence(
        cfg, cam.fx, cam.fy, rel_sig, exact_baseline=True)
    sig_tri = rel * rho_new
    rho_old = filt.feat_mu[:, 2]
    disagrees = torch.abs(rho_new - rho_old) > sig_tri
    boot = ((filt.age <= cfg.bootstrap_max_age) & tri_ok & good & passed
            & filt.active & disagrees)
    return boot, sig_tri, torch.where(boot, rho_new, rho_old)


def _depth_bootstrap(filt: ekf.FilterState, cfg: VIOConfig, cam: Camera,
                     measured_uv, passed, dt, frame_qt) -> ekf.FilterState:
    """IMU-mode depth bootstrap: the booted features (``_depth_boot_select``)
    get ρ and its variance re-initialized; the ρ row and column of Σ are
    wiped first (in factor form by one re-triangularization)."""
    boot, sig_tri, rho = _depth_boot_select(filt, cfg, cam, measured_uv,
                                            passed, dt, frame_qt)
    n, dtype = filt.n_max, filt.Sigma.dtype
    if cfg.square_root_form:
        Sigma = sqrt_filter.wipe_rows_factor(
            filt.Sigma, _rho_vec(boot.to(dtype), n),
            _rho_vec((sig_tri * sig_tri).to(dtype), n))
    else:
        keep = 1.0 - _rho_vec(boot.to(dtype), n)
        Sigma = filt.Sigma * (keep[:, None] * keep[None, :])
        # booted rows were just wiped to a zero diagonal: adding the new
        # prior sets it exactly; other rows add zero
        Sigma = Sigma + torch.diag(
            _rho_vec(torch.where(boot, sig_tri * sig_tri, 0.0).to(dtype), n))
    return filt.replace(feat_mu=torch.cat([filt.feat_mu[:, :2], rho[:, None]],
                                          1), Sigma=Sigma)


def _measurement_covariance(cfg: VIOConfig, cam: Camera, prev_img, cur_img,
                            prev_px, points) -> torch.Tensor:
    """[N, 2, 2] metric R: constant, or with ``klt_covariance='sample'``
    the SSD response-surface estimate (KLTTracker.cpp:111-175) floored at
    the constant value, scaled px² → metric² by 1/f²."""
    if cfg.klt_covariance != "sample":
        return klt.measurement_covariance_metric(
            cam.fx, cam.fy, cfg.max_features, cfg, device=cur_img.device)
    cov_px = klt.estimate_uncertainty_sample_based(prev_img, cur_img,
                                                   prev_px, points)
    eye2 = torch.eye(2, device=cur_img.device)
    cov_px = cov_px + cfg.klt_measurement_variance_px * eye2[None]
    scale = device_constant(
        [1.0 / (cam.fx * cam.fx), 1.0 / (cam.fx * cam.fy),
         1.0 / (cam.fx * cam.fy), 1.0 / (cam.fy * cam.fy)],
        device=cur_img.device).reshape(2, 2)
    return cov_px * scale[None]


def _two_view_depths(filt, cfg: VIOConfig, cam: Camera, prev_pyr, cur_pyr,
                     cand_px, cand_uv, cand_valid, dt):
    """Vision-only depth init of new candidates (engine.py:351-379), on a
    dense or a split state: track them back into the previous frame and
    triangulate against the filter's own frame-to-frame motion.  Returns
    (depths, depth_vars)."""
    back = klt.track(cur_pyr, prev_pyr, cand_px, cand_px, cand_valid, cfg)
    h_prev = cam_mod.pixel_to_metric(cam, back.points)
    z_cur, tri_ok, rel_sig = depth_init.triangulate_depths(
        h_prev, cand_uv, filt.base_mu, dt, cfg.default_point_depth,
        return_rel_sigma=True)
    good, rel = depth_init.triangulation_confidence(
        cfg, cam.fx, cam.fy, rel_sig, exact_baseline=False)
    used = tri_ok & back.status & good
    depths = torch.where(used, z_cur, cfg.default_point_depth)
    sig_rho = rel / torch.clamp(depths, min=1e-3)
    depth_vars = torch.where(used, sig_rho * sig_rho,
                             cfg.default_point_depth_variance)
    return depths, depth_vars


def _recovered_base(base_mu: torch.Tensor) -> torch.Tensor:
    """The base state a tracking-lost recovery keeps: non-finite entries
    reset to the identity pose, the quaternion renormalized."""
    init_mu = device_constant([0.0] * 3 + [1.0] + [0.0] * 18, base_mu.dtype,
                              base_mu.device)
    base = torch.where(torch.isfinite(base_mu), base_mu, init_mu)
    qn = torch.linalg.vector_norm(base[3:7])
    q = torch.where(qn > 1e-6, base[3:7] / torch.clamp(qn, min=1e-6),
                    init_mu[3:7])
    return torch.cat([base[:3], q, base[7:]])


def _recovered_base_variances(diag: torch.Tensor,
                              cfg: VIOConfig) -> torch.Tensor:
    """[22] base variances after a recovery, from Σ's diagonal ``diag``:
    pose and biases kept (non-finite ones reset to their initial value),
    the kinematic ones re-inflated."""
    def safe(d, fallback):
        return torch.clamp(torch.where(torch.isfinite(d), d, fallback), min=0.0)

    return torch.cat([
        safe(diag[:7], cfg.init_pose_variance),
        torch.full((9,), cfg.init_kinematic_variance, dtype=diag.dtype,
                   device=diag.device),
        safe(diag[16:22], cfg.init_bias_variance),
    ])


def _track_and_gate(prev_pyr, filt, img, cfg: VIOConfig, cam: Camera,
                    nis_of):
    """The front end of a step, on a dense or a split state: the new
    pyramid, KLT seeded at the predicted positions, the kill box, the
    relative structure gate and the χ² innovation gate (``nis_of``:
    measured uv [N, 2] -> per-feature NIS [N]).  Returns (cur_pyr, the
    track result, prev_px, passed, measured_uv)."""
    with record_function("vio.pyramid"):
        cur_pyr = pyramid.build_pyramid(img, cfg.klt_max_pyramid_level)
    with record_function("vio.track"):
        prev_px = cam_mod.metric_to_pixel(cam, filt.klt_ref)
        seed_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
        res = klt.track(prev_pyr, cur_pyr, prev_px, seed_px, filt.active,
                        cfg)
        passed = res.status & cam_mod.in_kill_box(cam, res.points,
                                                  cfg.kill_pad)
    measured_uv = cam_mod.pixel_to_metric(cam, res.points)
    if cfg.min_eigen_rel_gate > 0 or cfg.innovation_gate_chi2 > 0:
        with record_function("vio.gates"):
            if cfg.min_eigen_rel_gate > 0:
                passed = passed & _rel_eig_keep(res.min_eig, passed,
                                                cfg.min_eigen_rel_gate)
            if cfg.innovation_gate_chi2 > 0:
                passed = passed & (nis_of(measured_uv)
                                   <= cfg.innovation_gate_chi2)
    return cur_pyr, res, prev_px, passed, measured_uv


def _replenish_candidates(img, filt, cfg: VIOConfig, cam: Camera):
    """FAST candidates away from the live features (EKFVIO.cpp:224-311).
    Returns (cand_px, cand_valid, cand_uv)."""
    feat_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
    cand_px, cand_valid = replenish.replenish(img, feat_px, filt.active, cfg,
                                              cfg.max_features)
    return cand_px, cand_valid, cam_mod.pixel_to_metric(cam, cand_px)


def _recover_tracking_lost(filt: ekf.FilterState, cfg: VIOConfig,
                           lost: torch.Tensor) -> ekf.FilterState:
    """Re-bootstrap when tracking collapses (the action on the flag the
    reference only logs, EKFVIO.cpp:192): keep pose and biases, free every
    slot, wipe all cross-correlations and re-inflate the kinematic
    variances.  Every field is selected by ``torch.where`` on ``lost``."""
    dtype, dev = filt.Sigma.dtype, filt.device
    n = filt.n_max
    base = _recovered_base(filt.base_mu)
    sig_diag = torch.cat([
        _recovered_base_variances(_filter_sigma_diag(filt, cfg), cfg),
        torch.zeros(3 * n, dtype=dtype, device=dev),
    ])
    # diag(σ²) in covariance form; its own Cholesky factor diag(σ) in
    # factor form
    new_sigma = torch.diag(torch.sqrt(sig_diag) if cfg.square_root_form
                           else sig_diag)
    rec = filt.replace(base_mu=base,
                       active=torch.zeros_like(filt.active),
                       Sigma=new_sigma,
                       age=torch.zeros_like(filt.age))
    return ekf.FilterState(**{
        f.name: torch.where(lost, getattr(rec, f.name), getattr(filt, f.name))
        for f in dataclasses.fields(ekf.FilterState)})


def step(estate: EngineState, img, t, cfg: VIOConfig, cam: Camera,
         imu_batch: imu_mod.ImuSample | None = None, gravity_w=None):
    """One frame (steady-state branch of addFrame, EKFVIO.cpp:154-173) on
    the state's device.  With ``imu_batch`` (this camera interval's
    samples) the predict is the IMU strapdown propagation; otherwise the
    vision-driven random-walk process.  Returns (EngineState, outputs)."""
    sq = cfg.square_root_form  # factor-native mode: filt.Sigma holds L
    filt = estate.filt
    dev = filt.device
    img = _f32(img, dev)
    t = _f32(t, dev)
    filt = filt.replace(age=torch.where(filt.active, filt.age + 1, 0))
    dt = torch.clamp(t - filt.t, min=0.0)  # dt >= 0 (EKFVIO.cpp:162)

    # --- predict (process, EKFVIO.cpp:163)
    frame_qt = None  # exact inter-frame camera motion (IMU mode)
    if imu_batch is not None:
        with record_function("vio.imu"):
            lin = estate.lin_base if cfg.use_fej else None
            # the remainder of the interval not spanned by IMU samples is
            # appended as a zero-order-hold sample (dt = 0: a no-op)
            rem = torch.clamp(t - (filt.t + torch.sum(imu_batch.dt)), min=0.0)
            batch = imu_mod.extend_batch_with_remainder(imu_batch, rem)
            propagate = (sqrt_filter.propagate_imu_factor if sq
                         else imu_mod.propagate_imu_batch_with_motion)
            filt, frame_qt = propagate(filt, cfg, batch, gravity_w,
                                       lin_base=lin)
    else:
        with record_function("vio.predict"):
            predict = sqrt_filter.predict_sqrt_factor if sq else ekf.predict
            filt = predict(filt, cfg, dt)
    filt = filt.replace(t=t.to(filt.t.dtype))
    new_lin_base = filt.base_mu  # FEJ anchor for the next interval

    # --- track (updateStateWithNewImage, EKFVIO.cpp:207-219), then the
    # relative structure gate and the χ² innovation gate (constant R)
    def nis_of(measured_uv):
        gate_cov = klt.measurement_covariance_metric(
            cam.fx, cam.fy, cfg.max_features, cfg, device=dev)
        return innovation_nis_per_feature(filt, measured_uv, gate_cov,
                                          factor=sq)

    cur_pyr, res, prev_px, passed, measured_uv = _track_and_gate(
        estate.prev_pyr, filt, img, cfg, cam, nis_of)

    if imu_batch is not None and cfg.triangulate_new_features:
        with record_function("vio.depth_boot"):
            filt = _depth_bootstrap(filt, cfg, cam, measured_uv, passed, dt,
                                    frame_qt)

    # --- update, then failed features free their slots
    # (TightlyCoupledEKF.cpp:525-529)
    with record_function("vio.update"):
        meas_cov = _measurement_covariance(cfg, cam, estate.prev_pyr[0],
                                           cur_pyr[0], prev_px, res.points)
        innov = ekf.innovation_stats(filt, measured_uv, passed)
        nis = innovation_nis(filt, measured_uv, meas_cov, passed, factor=sq)
        update = (sqrt_filter.update_sqrt_factor if sq
                  else ekf.update_with_feature_positions)
        filt = update(filt, cfg, measured_uv, meas_cov, passed)
        num_tracked = torch.sum(passed & filt.active, dtype=torch.int32)
        drop = sqrt_filter.drop_features_factor if sq else ekf.drop_features
        filt = drop(filt, filt.active & ~passed)

    # tracking lost: too few surviving tracks or a non-finite state
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(filt.base_mu).all()
            | ~torch.isfinite(_filter_sigma_diag(filt, cfg)).all())
    if cfg.recover_on_tracking_lost:
        filt = _recover_tracking_lost(filt, cfg, lost)
        new_lin_base = torch.where(lost, filt.base_mu, new_lin_base)

    # --- replenish (EKFVIO.cpp:224-311)
    with record_function("vio.replenish"):
        cand_px, cand_valid, cand_uv = _replenish_candidates(img, filt, cfg,
                                                             cam)
        depths = depth_vars = None
        if cfg.triangulate_new_features and imu_batch is None:
            # IMU mode skips this second tracker call: its depth
            # bootstrap re-triangulates young features every frame
            depths, depth_vars = _two_view_depths(
                filt, cfg, cam, estate.prev_pyr, cur_pyr, cand_px, cand_uv,
                cand_valid, dt)
        add = sqrt_filter.add_features_factor if sq else ekf.add_features
        filt = add(filt, cfg, cand_uv, cand_valid, depths=depths,
                   depth_vars=depth_vars)

    if sq:
        L3 = filt.Sigma[:3, :]
        pos_cov = L3 @ L3.T
    else:
        pos_cov = filt.Sigma[:3, :3]
    out = StepOutputs(
        base_mu=filt.base_mu,
        num_tracked=num_tracked,
        num_active=filt.num_active(),
        mean_innovation=innov,
        pose_cov_diag=_filter_sigma_diag(filt, cfg)[:7],
        tracking_lost=lost,
        pos_cov=pos_cov,
        mean_nis=nis,
    )
    return EngineState(filt=filt, prev_pyr=cur_pyr,
                       frame_idx=estate.frame_idx + 1,
                       lin_base=new_lin_base), out


def run_sequence(images, times, cfg: VIOConfig, cam: Camera,
                 device="cuda"):
    """Vision-only rollout on ``device``: bootstrap on frame 0, then one
    ``step`` per frame, through ``scan`` (one CUDA graph of the step,
    replayed once a frame, on the card).

    images: [T, H, W] processed-scale grayscale; times: [T].
    Returns (final EngineState, StepOutputs stacked over frames 1..T-1)."""
    dev = resolve_device(device)
    images, times = _f32(images, dev), _f32(times, dev)
    estate = initialize(images[0], times[0], cfg, cam, device=dev)
    return scan.scan(lambda es, x: step(es, x[0], x[1], cfg, cam),
                     estate, (images[1:], times[1:]))


def initialize_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                   cfg: VIOConfig, cam: Camera, init_frames: int,
                   device="cuda") -> EngineState:
    """Closed-form visual-inertial initialization over the first
    ``init_frames`` frames (core/vi_init.py): an EngineState at frame
    init_frames-1 with a metric velocity, IMU biases and metrically
    consistent feature depths.  The world frame is frame 0's camera."""
    use_f32_matmul()
    dev = resolve_device(device)
    use_cusolver(dev)
    images, times = _f32(images, dev), _f32(times, dev)
    imu_dt, imu_gyro = _f32(imu_dt, dev), _f32(imu_gyro, dev)
    imu_accel, gravity_w = _f32(imu_accel, dev), _f32(gravity_w, dev)
    k, n = init_frames, cfg.max_features

    # frame-0 detection, then chained tracking through frames 1..K-1
    px, valid = replenish.replenish(
        images[0], torch.zeros(n, 2, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev), cfg, n)
    pyr = pyramid.build_pyramid(images[0], cfg.klt_max_pyramid_level)
    hs, vs = [cam_mod.pixel_to_metric(cam, px)], [valid]
    for i in range(1, k):
        pyr_i = pyramid.build_pyramid(images[i], cfg.klt_max_pyramid_level)
        res = klt.track(pyr, pyr_i, px, px, valid, cfg)
        valid = valid & res.status & cam_mod.in_kill_box(cam, res.points,
                                                         cfg.kill_pad)
        if cfg.min_eigen_rel_gate > 0:  # structure gate, as in step()
            valid = valid & _rel_eig_keep(res.min_eig, valid,
                                          cfg.min_eigen_rel_gate)
        pyr, px = pyr_i, res.points
        hs.append(cam_mod.pixel_to_metric(cam, px))
        vs.append(valid)
    h_obs, valid_obs = torch.stack(hs), torch.stack(vs)      # [K, N, ...]

    # IMU integration + joint (v0, depths[, biases]) alignment
    imu = (times[:k], imu_dt[:k - 1], imu_gyro[:k - 1], imu_accel[:k - 1],
           gravity_w)
    if cfg.vi_init_estimate_gyro_bias:
        res_a, bg0, ba0 = vi_init.align_with_gyro_bias(
            *imu, h_obs, valid_obs, rounds=cfg.vi_init_gn_rounds,
            estimate_accel_bias=cfg.vi_init_estimate_accel_bias)
    else:
        res_a = vi_init.align(h_obs, valid_obs,
                              *vi_init.integrate_motion(*imu)[:3])
        bg0 = ba0 = torch.zeros(3, device=dev)
    base22 = vi_init.integrate_motion(*imu, v0=res_a.v0_world,
                                      gyro_bias=bg0, accel_bias=ba0)[3]
    base22 = torch.cat([base22[:16], ba0, bg0])

    # aligned features expressed in frame K-1
    RK, tcK = res_a.R_i[k - 1], res_a.tc_i[k - 1]
    tK = tcK - res_a.tau_i[k - 1] * (RK @ res_a.v0_world)
    h0 = torch.cat([h_obs[0], torch.ones(n, 1, device=dev)], -1)
    pK = (h0 @ RK.T) * res_a.depths0[:, None] + tK
    keep = valid_obs[k - 1] & res_a.depth_ok & (pK[:, 2] > 0.02)

    filt = ekf.init_state(cfg, device=dev)
    filt = filt.replace(base_mu=base22, t=times[k - 1].clone())
    filt = ekf.add_features(filt, cfg, h_obs[k - 1], keep, depths=pK[:, 2])

    # tightened post-alignment variances: solved velocity, bias priors,
    # aligned depths with a relative sigma
    d = torch.diagonal(filt.Sigma).clone()
    d[7:10] = cfg.init_aligned_velocity_variance
    d[16:19] = cfg.init_accel_bias_sigma ** 2
    d[19:22] = cfg.init_gyro_bias_sigma ** 2
    rho_idx = BASE_STATE_SIZE + 3 * torch.arange(n, device=dev) + 2
    sig_rho = cfg.bootstrap_depth_sigma_rel * filt.feat_mu[:, 2]
    d[rho_idx] = torch.where(filt.active, sig_rho * sig_rho, d[rho_idx])
    Sigma = filt.Sigma.clone()
    Sigma.diagonal().copy_(d)
    filt = filt.replace(Sigma=Sigma)
    if cfg.square_root_form:  # factor once; the loop never re-factors
        filt = sqrt_filter.to_factor(filt)
    return EngineState(filt=filt, prev_pyr=pyr,
                       frame_idx=torch.full((), k, dtype=torch.int32,
                                            device=dev),
                       lin_base=filt.base_mu)


def run_sequence_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                     cfg: VIOConfig, cam: Camera, init_frames: int = 0,
                     device="cuda"):
    """Mono-inertial rollout on ``device``: IMU strapdown between frames,
    vision update at frames, through ``scan`` after the VI initialization
    (which runs eagerly, once).

    images [T, H, W]; times [T]; imu_dt [T-1, K] per-interval sample dts
    (0 = padding); imu_gyro, imu_accel [T-1, K, 3]; gravity_w [3].  With
    init_frames > 1 the first frames run ``initialize_imu``.  Returns
    (final EngineState, StepOutputs stacked over the filtered frames)."""
    dev = resolve_device(device)
    images, times = _f32(images, dev), _f32(times, dev)
    imu_dt, imu_gyro = _f32(imu_dt, dev), _f32(imu_gyro, dev)
    imu_accel, gravity_w = _f32(imu_accel, dev), _f32(gravity_w, dev)
    if init_frames > 1:
        estate = initialize_imu(images, times, imu_dt, imu_gyro, imu_accel,
                                gravity_w, cfg, cam, init_frames, device=dev)
        start = init_frames
    else:
        estate = initialize(images[0], times[0], cfg, cam, device=dev)
        start = 1
    return scan.scan(imu_step_body(cfg, cam, gravity_w), estate,
                     imu_frames(images, times, imu_dt, imu_gyro, imu_accel,
                                start))


def imu_frames(images, times, imu_dt, imu_gyro, imu_accel, start: int):
    """The ``xs`` of a mono-inertial rollout from frame ``start`` on: each
    frame with the IMU samples of the interval that ends at it."""
    n = images.shape[0]
    return (images[start:], times[start:], imu_dt[start - 1:n - 1],
            imu_gyro[start - 1:n - 1], imu_accel[start - 1:n - 1])


def imu_step_body(cfg: VIOConfig, cam: Camera, gravity_w):
    """``step`` in mono-inertial mode as a ``scan`` body over
    ``imu_frames``."""
    def body(estate, x):
        img, t, dt, gyro, accel = x
        return step(estate, img, t, cfg, cam,
                    imu_batch=imu_mod.ImuSample(dt=dt, gyro=gyro,
                                                accel=accel),
                    gravity_w=gravity_w)

    return body
