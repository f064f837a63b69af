"""Engine: the per-frame VIO pipeline, one frame flow for every form of Σ.

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
``vio.*`` span (``utils/profiling.py``): a ``record_function`` range that
a ``torch.profiler`` trace of an eager step attributes host and device
time to and, with the recorder on, host spans and device stamps that a
replayed graph of the step re-runs, so the per-layer device time of the
compiled rollout is measured too.  A step is a ``vio.step`` frame and an
initialization a ``vio.init`` frame of the recorder, which also counts
the tracked, gated, added and lost features where they are decided.

Every operation ``step`` applies to Σ goes through a form
(``core/filter.CovarianceForm`` lists them), so the flow itself never
asks how Σ is held: ``filter.form_of(cfg)`` picks, from the
configuration, the covariance form (Σ dense) or the factor form
(core/sqrt_filter.py: L across frames, a carried non-square factor and
two QRs inside a step); the sharded engine passes the split form
(parallel/sharded_filter.py: this rank's blocks of Σ).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ekf_vio_tpu_torch import scan
from ekf_vio_tpu_torch.config import BASE_STATE_SIZE, VIOConfig
from ekf_vio_tpu_torch.core import depth_init
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.core import lie, vi_init
from ekf_vio_tpu_torch.core.state import (device_constant,
                                          register_dataclass_pytree)
from ekf_vio_tpu_torch.frontend import camera as cam_mod
from ekf_vio_tpu_torch.frontend import klt, pyramid, replenish
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.utils import profiling


@dataclasses.dataclass
class EngineState:
    filt: ekf.FilterState     # or a ShardedFilterState (the split form)
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


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU, and an error rather than a silent CPU run without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def as_f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


@profiling.framed("vio.init")
def initialize(img, t, cfg: VIOConfig, cam: Camera,
               device="cuda") -> EngineState:
    """First-frame bootstrap (EKFVIO.cpp:141-153): start the filter clock
    and detect the initial feature set, on ``device``."""
    use_f32_matmul()
    dev = resolve_device(device)
    use_cusolver(dev)
    img = as_f32(img, dev)
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
    filt = ekf.form_of(cfg).from_covariance(filt)  # the loop never re-factors
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


def _depth_boot_select(filt, cfg: VIOConfig, cam: Camera, measured_uv,
                       passed, dt, frame_qt):
    """The IMU-mode depth bootstrap's choice (engine.py:240-293): young
    tracked features whose depth, triangulated against the exact IMU
    baseline ``frame_qt``, disagrees with their estimate.  Returns (boot
    [N] bool, the new ρ σ [N], ρ [N] with the booted slots
    re-initialized)."""
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


def _two_view_depths(filt, cfg: VIOConfig, cam: Camera, prev_pyr, cur_pyr,
                     cand_px, cand_uv, cand_valid, dt):
    """Vision-only depth init of new candidates (engine.py:351-379): track
    them back into the previous frame and triangulate against the
    filter's own frame-to-frame motion.  Returns (depths, depth_vars)."""
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
    """The front end of a step: the new pyramid, KLT seeded at the
    predicted positions, the kill box, the relative structure gate and the
    χ² innovation gate (``nis_of``: measured uv [N, 2] -> per-feature NIS
    [N]).  Returns (cur_pyr, the track result, prev_px, passed,
    measured_uv)."""
    with profiling.span("vio.pyramid"):
        cur_pyr = pyramid.build_pyramid(img, cfg.klt_max_pyramid_level)
    with profiling.span("vio.track"):
        prev_px = cam_mod.metric_to_pixel(cam, filt.klt_ref)
        seed_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
        res = klt.track(prev_pyr, cur_pyr, prev_px, seed_px, filt.active,
                        cfg)
        passed = res.status & cam_mod.in_kill_box(cam, res.points,
                                                  cfg.kill_pad)
    measured_uv = cam_mod.pixel_to_metric(cam, res.points)
    if cfg.min_eigen_rel_gate > 0 or cfg.innovation_gate_chi2 > 0:
        with profiling.span("vio.gates"):
            kept = passed
            if cfg.min_eigen_rel_gate > 0:
                passed = passed & _rel_eig_keep(res.min_eig, passed,
                                                cfg.min_eigen_rel_gate)
            if cfg.innovation_gate_chi2 > 0:
                passed = passed & (nis_of(measured_uv)
                                   <= cfg.innovation_gate_chi2)
            profiling.count("gated", kept, passed)  # passed ⊆ kept
    return cur_pyr, res, prev_px, passed, measured_uv


def _replenish_candidates(img, filt, cfg: VIOConfig, cam: Camera):
    """FAST candidates away from the live features (EKFVIO.cpp:224-311).
    Returns (cand_px, cand_valid, cand_uv)."""
    feat_px = cam_mod.metric_to_pixel(cam, filt.feat_mu[:, :2])
    cand_px, cand_valid = replenish.replenish(img, feat_px, filt.active, cfg,
                                              cfg.max_features)
    return cand_px, cand_valid, cam_mod.pixel_to_metric(cam, cand_px)


def _recover_tracking_lost(filt, cfg: VIOConfig, lost: torch.Tensor, form):
    """Re-bootstrap when tracking collapses (the action on the flag the
    reference only logs, EKFVIO.cpp:192): keep pose and biases, free every
    slot, wipe all cross-correlations and re-inflate the kinematic
    variances.  Every field is selected by ``torch.where`` on ``lost``."""
    base = _recovered_base(filt.base_mu)
    sigma = form.recovered_sigma(filt, _recovered_base_variances(
        form.sigma_diag(filt), cfg))
    rec = filt.replace(base_mu=base, active=torch.zeros_like(filt.active),
                       **sigma, age=torch.zeros_like(filt.age))
    return type(filt)(**{
        f.name: torch.where(lost, getattr(rec, f.name), getattr(filt, f.name))
        for f in dataclasses.fields(filt)})


@profiling.framed("vio.step")
def step(estate: EngineState, img, t, cfg: VIOConfig, cam: Camera,
         imu_batch: imu_mod.ImuSample | None = None, gravity_w=None,
         form=None):
    """One frame (steady-state branch of addFrame, EKFVIO.cpp:154-173) on
    the state's device.  With ``imu_batch`` (this camera interval's
    samples) the predict is the IMU strapdown propagation; otherwise the
    vision-driven random-walk process.  ``form`` applies every operation
    on Σ (default ``filter.form_of(cfg)``; the sharded engine passes the
    split form).  Returns (EngineState, outputs)."""
    form = ekf.form_of(cfg) if form is None else form
    filt = estate.filt
    dev = filt.device
    img = as_f32(img, dev)
    t = as_f32(t, dev)
    filt = filt.replace(age=torch.where(filt.active, filt.age + 1, 0))
    dt = torch.clamp(t - filt.t, min=0.0)  # dt >= 0 (EKFVIO.cpp:162)

    # --- predict (process, EKFVIO.cpp:163)
    frame_qt = None  # exact inter-frame camera motion (IMU mode)
    if imu_batch is not None:
        with profiling.span("vio.imu"):
            lin = estate.lin_base if cfg.use_fej else None
            # the remainder of the interval not spanned by IMU samples is
            # appended as a zero-order-hold sample (dt = 0: a no-op)
            rem = torch.clamp(t - (filt.t + torch.sum(imu_batch.dt)), min=0.0)
            batch = imu_mod.extend_batch_with_remainder(imu_batch, rem)
            filt, frame_qt = form.propagate_imu(filt, cfg, batch, gravity_w,
                                                lin)
    else:
        with profiling.span("vio.predict"):
            filt = form.predict(filt, cfg, dt)
    filt = filt.replace(t=t.to(filt.t.dtype))
    new_lin_base = filt.base_mu  # FEJ anchor for the next interval

    # --- track (updateStateWithNewImage, EKFVIO.cpp:207-219), then the
    # relative structure gate and the χ² innovation gate (constant R)
    cur_pyr, res, prev_px, passed, measured_uv = _track_and_gate(
        estate.prev_pyr, filt, img, cfg, cam,
        lambda uv: form.gate_nis(filt, cfg, cam, uv))

    if imu_batch is not None and cfg.triangulate_new_features:
        # young features whose depth disagrees with the triangulated one
        # get ρ and its variance re-initialized
        with profiling.span("vio.depth_boot"):
            boot, sig_tri, rho = _depth_boot_select(
                filt, cfg, cam, measured_uv, passed, dt, frame_qt)
            filt = form.reprime_depths(filt, boot, sig_tri)
            filt = filt.replace(feat_mu=torch.cat([filt.feat_mu[:, :2],
                                                   rho[:, None]], 1))

    # --- update, then failed features free their slots
    # (TightlyCoupledEKF.cpp:525-529)
    with profiling.span("vio.update"):
        meas_cov = form.measurement_covariance(
            cfg, cam, estate.prev_pyr[0], cur_pyr[0], prev_px, res.points)
        innov = ekf.innovation_stats(filt, measured_uv, passed)
        filt, nis = form.update(filt, cfg, measured_uv, meas_cov, passed)
        num_tracked = torch.sum(passed & filt.active, dtype=torch.int32)
        profiling.count("tracked", num_tracked)
        filt = form.drop(filt, filt.active & ~passed)

    # tracking lost: too few surviving tracks or a non-finite state
    lost = ((num_tracked < cfg.minimum_trackable_features)
            | ~torch.isfinite(filt.base_mu).all()
            | ~form.sigma_finite(filt))
    profiling.count("lost", lost)
    if cfg.recover_on_tracking_lost:
        filt = _recover_tracking_lost(filt, cfg, lost, form)
        new_lin_base = torch.where(lost, filt.base_mu, new_lin_base)

    # --- replenish (EKFVIO.cpp:224-311)
    with profiling.span("vio.replenish"):
        cand_px, cand_valid, cand_uv = _replenish_candidates(img, filt, cfg,
                                                             cam)
        depths = depth_vars = None
        if cfg.triangulate_new_features and imu_batch is None:
            # IMU mode skips this second tracker call: its depth
            # bootstrap re-triangulates young features every frame
            depths, depth_vars = _two_view_depths(
                filt, cfg, cam, estate.prev_pyr, cur_pyr, cand_px, cand_uv,
                cand_valid, dt)
        live = filt.active
        filt = form.add(filt, cfg, cand_uv, cand_valid, depths, depth_vars)
        profiling.count("added", live, filt.active)  # live ⊆ active

    pos_cov = form.pos_cov(filt)
    out = StepOutputs(
        base_mu=filt.base_mu,
        num_tracked=num_tracked,
        num_active=filt.num_active(),
        mean_innovation=innov,
        pose_cov_diag=form.sigma_diag(filt)[:7],
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
    images, times = as_f32(images, dev), as_f32(times, dev)
    estate = initialize(images[0], times[0], cfg, cam, device=dev)
    return scan.scan(lambda es, x: step(es, x[0], x[1], cfg, cam),
                     estate, (images[1:], times[1:]))


@profiling.framed("vio.init")
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
    images, times = as_f32(images, dev), as_f32(times, dev)
    imu_dt, imu_gyro = as_f32(imu_dt, dev), as_f32(imu_gyro, dev)
    imu_accel, gravity_w = as_f32(imu_accel, dev), as_f32(gravity_w, dev)
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
    filt = ekf.form_of(cfg).from_covariance(filt.replace(Sigma=Sigma))
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
    estate, gravity_w, xs = imu_rollout_start(
        images, times, imu_dt, imu_gyro, imu_accel, gravity_w, cfg, cam,
        init_frames, resolve_device(device))
    return scan.scan(imu_step_body(cfg, cam, gravity_w), estate, xs)


def imu_rollout_start(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                      cfg: VIOConfig, cam: Camera, init_frames: int,
                      dev: torch.device):
    """What a mono-inertial rollout starts from, on ``dev``: the state
    (``initialize_imu`` over the first ``init_frames`` frames if
    init_frames > 1, else ``initialize`` on frame 0), gravity_w as a
    tensor, and ``imu_frames`` of the frames after it."""
    images, times, imu_dt, imu_gyro, imu_accel, gravity_w = (
        as_f32(x, dev)
        for x in (images, times, imu_dt, imu_gyro, imu_accel, gravity_w))
    if init_frames > 1:
        estate = initialize_imu(images, times, imu_dt, imu_gyro, imu_accel,
                                gravity_w, cfg, cam, init_frames, device=dev)
        start = init_frames
    else:
        estate = initialize(images[0], times[0], cfg, cam, device=dev)
        start = 1
    return estate, gravity_w, imu_frames(images, times, imu_dt, imu_gyro,
                                         imu_accel, start)


def imu_frames(images, times, imu_dt, imu_gyro, imu_accel, start: int):
    """The ``xs`` of a mono-inertial rollout from frame ``start`` on: each
    frame with the IMU samples of the interval that ends at it."""
    n = images.shape[0]
    return (images[start:], times[start:], imu_dt[start - 1:n - 1],
            imu_gyro[start - 1:n - 1], imu_accel[start - 1:n - 1])


def imu_step_body(cfg: VIOConfig, cam: Camera, gravity_w, form=None):
    """``step`` in mono-inertial mode as a ``scan`` body over
    ``imu_frames``."""
    def body(estate, x):
        img, t, dt, gyro, accel = x
        return step(estate, img, t, cfg, cam,
                    imu_batch=imu_mod.ImuSample(dt=dt, gyro=gyro,
                                                accel=accel),
                    gravity_w=gravity_w, form=form)

    return body
