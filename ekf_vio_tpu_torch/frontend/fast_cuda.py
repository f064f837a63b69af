"""FAST-9 + NMS on the card: the ``fast9`` CUDA kernel and its dispatch.

Port of ``ekf_vio_tpu/frontend/pallas_fast.py``: ``detect`` launches
``csrc/fast9.cu`` for a CUDA tensor and runs the plain twin
``frontend/fast.py detect`` for a CPU tensor.  Unlike the JAX package, no
frame is too small for the kernel: a GPU floor, if any, is for a
measurement on the card to set.  A [B, H, W] stack of frames is one
launch (grid.z = B), each frame bitwise equal to a one-frame launch;
``detect`` goes through the custom operator ``ekf_vio_tpu_torch::fast9``,
whose vmap rule folds the lanes of ``torch.func.vmap`` into that launch
(a vmap over ``pallas_fast.detect_pallas`` in the JAX package).  The
margin order is the frame size's, as for one frame.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ekf_vio_tpu_torch import cuda_lib
from ekf_vio_tpu_torch.frontend import fast
from ekf_vio_tpu_torch.frontend.lanes import fold_lanes, unfold_lanes

SOURCE = "ekf_vio_tpu_torch/csrc/fast9.cu"
REPLACES = "ekf_vio_tpu/frontend/pallas_fast.py:43"

NAME = "fast9"


def launches() -> int:
    """Kernel launches since the last ``reset_launches``, counted on the
    card by each launch itself (``csrc/launch_count.cuh``), the replays
    of a CUDA graph included; 0 where the kernel never ran."""
    return cuda_lib.launch_count(NAME)


def reset_launches() -> None:
    """Set ``launches()`` to 0."""
    cuda_lib.reset_launch_count(NAME)


@functools.cache
def _lib():
    lib = cuda_lib.load(NAME)
    lib.fast9_detect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.fast9_detect.restype = ctypes.c_int
    return lib


def detect_cuda(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """NMS'd FAST-9 score map of a [H, W] float32 CUDA image, or of each
    frame of a [B, H, W] stack, with the margin order of ``fast.detect``,
    in one launch."""
    if not img.is_cuda:
        raise ValueError("detect_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"expected a [H, W] or [B, H, W] float32 image, "
                         f"got {img.dtype} {tuple(img.shape)}")
    img = img.contiguous()
    h, w = img.shape[-2:]
    lanes = img.shape[0] if img.dim() == 3 else 1
    out = torch.empty_like(img)
    lib = _lib()
    rc = lib.fast9_detect(img.data_ptr(), lanes, h, w, float(threshold),
                          int(fast.mask_before_nms(h, w)), out.data_ptr(),
                          img.device.index, cuda_lib.stream_ptr(img))
    cuda_lib.check(lib, rc, "fast9_detect")
    cuda_lib.note_device(NAME, img.device.index)
    return out


@torch.library.custom_op("ekf_vio_tpu_torch::fast9", mutates_args=())
def _fast_op(img: Tensor, threshold: float) -> Tensor:
    """Lane-shaped ``detect``: [B, H, W] frames; the kernel on CUDA."""
    return detect_cuda(img, threshold)


@_fast_op.register_kernel("cpu")
def _fast_op_cpu(img, threshold):
    return fast.detect(img, threshold)


@_fast_op.register_vmap
def _fast_op_vmap(info, in_dims, img, threshold):
    img, threshold = fold_lanes(info, in_dims, img, threshold)
    out, dims = unfold_lanes(info, (_fast_op(img, threshold),))
    return out[0], dims[0]


def detect(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Drop-in for ``fast.detect(img, threshold)`` on a [H, W] frame or a
    [B, H, W] stack: the kernel on a CUDA tensor, the plain twin on a CPU
    tensor."""
    if img.dim() == 3:
        return _fast_op(img, float(threshold))
    return _fast_op(img[None], float(threshold))[0]
