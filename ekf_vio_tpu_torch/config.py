"""Configuration of the PyTorch engine.

The same ``VIOConfig`` as ``ekf_vio_tpu/config.py``: same fields, same
defaults, same validation, so one profile drives either package.  It is a
copy rather than an import because importing ``ekf_vio_tpu`` pulls in JAX.
Field comments name the reference parameter each knob mirrors; the JAX
package's copy carries the longer rationale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    # ---- filter capacity / layout
    num_features: int = 100          # D_NUM_FEATURES (Params.h:46)
    max_features: int = 128          # slot capacity N_max (>= num_features)

    # ---- front-end: FAST detection
    fast_threshold: int = 50         # D_FAST_THRESHOLD (Params.h:24)
    fast_blur_sigma: float = 0.0     # D_FAST_BLUR_SIGMA (Params.h:26)
    min_new_feature_dist: float = 30.0  # D_MIN_NEW_FEATURE_DIST (Params.h:43)

    # ---- front-end: KLT tracking
    klt_window_size: int = 21        # D_WINDOW_SIZE (Params.h:104)
    klt_max_pyramid_level: int = 3   # D_MAX_PYRAMID_LEVEL (Params.h:103)
    klt_iterations: int = 30         # TermCriteria COUNT (KLTTracker.cpp:63-64)
    klt_eps: float = 0.01            # TermCriteria EPS (KLTTracker.cpp:64)
    klt_min_eigen: float = 1e-4      # D_KLT_MIN_EIGEN (Params.h:36)
    kill_pad: int = 11               # D_KILL_PAD (Params.h:33)
    use_pallas_klt: bool = True      # JAX package only: its TPU tracker switch

    # ---- image handling
    inverse_image_scale: int = 4     # D_INVERSE_IMAGE_SCALE (Params.h:28)

    # ---- feature initialization
    triangulate_new_features: bool = False
    bootstrap_max_age: int = 20
    bootstrap_depth_sigma_rel: float = 0.25
    triangulation_max_rel_error: float = 0.5
    vi_init_frames: int = 10
    vi_init_estimate_gyro_bias: bool = True
    vi_init_estimate_accel_bias: bool = True
    vi_init_gn_rounds: int = 2
    init_aligned_velocity_variance: float = 1e-2
    default_point_depth: float = 0.5           # D_DEFAULT_POINT_DEPTH (Params.h:83)
    default_point_depth_variance: float = 100.0  # (Params.h:84)
    default_point_homogenous_variance: float = 1e-5  # (Params.h:86)

    # ---- measurement model
    klt_measurement_variance_px: float = 1e-5  # constant R (KLTTracker.cpp:100-106)
    innovation_gate_chi2: float = 0.0   # 0 disables the chi-square gate
    min_eigen_rel_gate: float = 0.0     # 0 disables the relative structure gate
    klt_covariance: str = "constant"    # "constant" | "sample"

    # ---- process noise (per-second rates, TightlyCoupledEKF.cpp:126-131)
    q_pos: float = 1e-4
    q_vel: float = 0.01
    q_omega: float = 5.0
    q_accel: float = 5.0
    q_bias: float = 1e-3
    q_feature: float = 1e-4

    # ---- initial base-state variances (TightlyCoupledEKF.cpp:29-54)
    init_pose_variance: float = 0.0
    init_kinematic_variance: float = 30.0
    init_bias_variance: float = 0.5

    # ---- pipeline thresholds
    minimum_trackable_features: int = 4  # D_MINIMUM_TRACKABLE_FEATURES (Params.h:55)
    recover_on_tracking_lost: bool = True

    # ---- IMU fusion
    use_imu: bool = False
    imu_rate_hz: float = 200.0
    imu_gyro_noise: float = 1.7e-4
    imu_accel_noise: float = 2.0e-3
    imu_gyro_bias_walk: float = 1.9e-5
    imu_accel_bias_walk: float = 3.0e-3
    gravity: float = 9.81
    init_gyro_bias_sigma: float = 0.003
    init_accel_bias_sigma: float = 0.03
    use_fej: bool = True

    # ---- numerics
    square_root_form: bool = False
    joseph_form: str = "expanded"    # "expanded" | "product"
    sigma_jitter: float = 0.0        # absolute diagonal jitter on S
    sigma_jitter_rel: float = 1e-4   # relative spectral floor on S

    def __post_init__(self):
        if self.max_features < self.num_features:
            object.__setattr__(self, "num_features", self.max_features)
        if self.joseph_form not in ("expanded", "product"):
            raise ValueError(
                f"joseph_form must be 'expanded' or 'product', "
                f"got {self.joseph_form!r}")
        if self.klt_covariance not in ("constant", "sample"):
            raise ValueError(
                f"klt_covariance must be 'constant' or 'sample', "
                f"got {self.klt_covariance!r}")

    BASE_STATE_SIZE = 22  # TightlyCoupledEKF.h:11-12

    @property
    def state_dim(self) -> int:
        return self.BASE_STATE_SIZE + 3 * self.max_features

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "VIOConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_yaml(cls, path: str) -> "VIOConfig":
        """Load overrides from a YAML profile (``configs/*.yaml``)."""
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def replace(self, **kw) -> "VIOConfig":
        return dataclasses.replace(self, **kw)


# Base-state index map (TightlyCoupledEKF.cpp:328-393):
#   [0:3] position (world)  [3:7] quaternion [w, x, y, z]  [7:10] velocity
#   [10:13] angular rate  [13:16] acceleration  [16:19] accel bias
#   [19:22] gyro bias (all body frame except position)
POS = slice(0, 3)
QUAT = slice(3, 7)
VEL = slice(7, 10)
OMEGA = slice(10, 13)
ACCEL = slice(13, 16)
BIAS_ACC = slice(16, 19)
BIAS_GYRO = slice(19, 22)
BASE_STATE_SIZE = 22
