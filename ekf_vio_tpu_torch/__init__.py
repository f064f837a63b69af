"""ekf_vio_tpu_torch — the EKF visual-inertial odometry engine in PyTorch,
with hand-written CUDA kernels for the H100.

A port of the JAX package ``ekf_vio_tpu`` (the reference it is tested
against), module for module: ``config``, ``core`` (state, dynamics,
update, filter, imu, depth_init, vi_init), ``frontend`` (camera, pyramid,
FAST, LK, replenishment), ``engine`` (``initialize`` / ``step`` /
``run_sequence``, and the mono-inertial ``initialize_imu`` /
``run_sequence_imu``), ``parallel`` (batched lanes), ``io`` (EuRoC,
checkpoints, the frame loader, trajectories), ``sim`` (sequences and the
closed-loop simulator), ``utils.profiling``, ``viz.insight`` and the CLI
(``python -m ekf_vio_tpu_torch``).  The entry points run on the card
unless the caller passes ``device="cpu"``.
Kernels live in ``csrc/`` and are built with nvcc at first use
(``cuda_lib``); on CPU tensors every kernel wrapper runs its plain
PyTorch twin instead.  Importing this package imports neither JAX nor
``ekf_vio_tpu``.
"""

from ekf_vio_tpu_torch.config import VIOConfig

__all__ = ["VIOConfig"]
