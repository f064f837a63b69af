"""The full per-frame VIO pipeline on the split-Σ state.

Port of ``ekf_vio_tpu/parallel/sharded_engine.py``.  The frame flow is
``engine.step``'s own (EKFVIO.cpp:139-196: IMU remainder as a sample,
the structure and χ² gates, the IMU-mode depth bootstrap, the at-birth
two-view depths in vision mode only, tracking-lost recovery before
replenishment), run with the split form (``sharded_filter.SplitForm``):
every O(D²)-and-up covariance operation runs on the rank's Σ blocks
(BASELINE.json config 5 for the whole per-frame pipeline).  The image
front end (pyramid, KLT through ``klt.track`` and the ``lk_level``
kernel, FAST through ``replenish`` and the ``fast9`` kernel) runs whole
on every rank of the ``state`` group: it is O(HW) work on frames every
rank holds.  The split form keeps the JAX module's constant R and its
reference defect ``mean_nis = 0.0``.

The initialization runs dense (``engine.initialize`` /
``initialize_imu``), then each rank keeps its blocks of the state's
``Sigma`` field.  ``run_sequence`` and ``run_sequence_imu`` run the step
over the frames on the mesh's device: on a NCCL mesh through
``scan.scan`` (one captured CUDA graph of the step and its collectives,
replayed once a frame), as the port's ``engine`` does; on a gloo mesh
through ``scan.loop``, since gloo runs its collectives on host threads,
which no CUDA graph can capture.
"""
from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch import engine, scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import imu as imu_mod
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.parallel import sharded_filter as sf
from ekf_vio_tpu_torch.parallel.mesh import capturable, mesh_device


def _split(dense: engine.EngineState, mesh: DeviceMesh) -> engine.EngineState:
    return dataclasses.replace(dense, filt=sf.split_state(dense.filt, mesh))


def initialize(img, t, cfg: VIOConfig, cam: Camera,
               mesh: DeviceMesh) -> engine.EngineState:
    """First-frame bootstrap (``engine.initialize``), then this rank's
    blocks of Σ."""
    return _split(engine.initialize(img, t, cfg, cam,
                                    device=mesh_device(mesh)), mesh)


def step(estate: engine.EngineState, img, t, cfg: VIOConfig, cam: Camera,
         mesh: DeviceMesh, imu_batch: imu_mod.ImuSample | None = None,
         gravity_w=None):
    """One full frame on the split state: ``engine.step`` in the split
    form.  Returns (EngineState, engine.StepOutputs)."""
    return engine.step(estate, img, t, cfg, cam, imu_batch, gravity_w,
                       form=sf.SplitForm(mesh))


def _rollout(mesh: DeviceMesh):
    """``scan.scan`` on a NCCL mesh, ``scan.loop`` on a gloo one."""
    return scan.scan if capturable(mesh) else scan.loop


def run_sequence(images, times, cfg: VIOConfig, cam: Camera,
                 mesh: DeviceMesh):
    """Vision-only rollout on the split state: ``initialize`` on frame 0,
    then one ``step`` per frame.  Returns (final EngineState, StepOutputs
    stacked over frames 1..T-1)."""
    dev = mesh_device(mesh)
    images, times = engine.as_f32(images, dev), engine.as_f32(times, dev)
    form = sf.SplitForm(mesh)
    return _rollout(mesh)(
        lambda es, x: engine.step(es, x[0], x[1], cfg, cam, form=form),
        initialize(images[0], times[0], cfg, cam, mesh),
        (images[1:], times[1:]))


def run_sequence_imu(images, times, imu_dt, imu_gyro, imu_accel, gravity_w,
                     cfg: VIOConfig, cam: Camera, mesh: DeviceMesh,
                     init_frames: int = 0):
    """Mono-inertial rollout on the split state (the analog of
    ``engine.run_sequence_imu``): the closed-form VI initialization runs
    whole on every rank (O(N) work on a few frames), then the state
    splits and every frame runs the split-form ``step``."""
    dense, gravity_w, xs = engine.imu_rollout_start(
        images, times, imu_dt, imu_gyro, imu_accel, gravity_w, cfg, cam,
        init_frames, mesh_device(mesh))
    return _rollout(mesh)(
        engine.imu_step_body(cfg, cam, gravity_w, sf.SplitForm(mesh)),
        _split(dense, mesh), xs)
