"""ekf_vio_tpu_torch — the EKF visual-inertial odometry engine in PyTorch,
with hand-written CUDA kernels for the H100.

A port of the JAX package ``ekf_vio_tpu`` (the reference it is tested
against), module for module: ``config``, ``core`` (state, dynamics,
update, filter), ``frontend`` (camera, pyramid, FAST, LK, replenishment),
``engine`` (vision-only ``initialize`` / ``step`` / ``run_sequence``).
Kernels live in ``csrc/`` and are built with nvcc at first use
(``cuda_lib``); on CPU tensors every kernel wrapper runs its plain
PyTorch twin instead.  Importing this package imports neither JAX nor
``ekf_vio_tpu``.
"""

from ekf_vio_tpu_torch.config import VIOConfig

__all__ = ["VIOConfig"]
