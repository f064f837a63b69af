"""FAST-9 + NMS on the card: the ``fast9`` CUDA kernel and its dispatch.

Port of ``ekf_vio_tpu/frontend/pallas_fast.py``: ``detect`` launches
``csrc/fast9.cu`` for a CUDA tensor and runs the plain twin
``frontend/fast.py detect`` for a CPU tensor.  Unlike the JAX package, no
frame is too small for the kernel: a GPU floor, if any, is for a
measurement on the card to set.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ekf_vio_tpu_torch import cuda_lib
from ekf_vio_tpu_torch.frontend import fast

SOURCE = "ekf_vio_tpu_torch/csrc/fast9.cu"
REPLACES = "ekf_vio_tpu/frontend/pallas_fast.py:43"

# kernel launches (one per call) since the last reset
launches = 0


@functools.cache
def _lib():
    lib = cuda_lib.load("fast9")
    lib.fast9_detect.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.fast9_detect.restype = ctypes.c_int
    return lib


def detect_cuda(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """NMS'd FAST-9 score map of a [H, W] float32 CUDA image, with the
    margin order of ``fast.detect``, in one launch."""
    global launches
    if not img.is_cuda:
        raise ValueError("detect_cuda needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError(f"expected a [H, W] float32 image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    img = img.contiguous()
    h, w = img.shape
    out = torch.empty_like(img)
    lib = _lib()
    rc = lib.fast9_detect(img.data_ptr(), h, w, float(threshold),
                          int(fast.mask_before_nms(h, w)), out.data_ptr(),
                          img.device.index, cuda_lib.stream_ptr(img))
    cuda_lib.check(lib, rc, "fast9_detect")
    launches += 1
    return out


def detect(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Drop-in for ``fast.detect(img, threshold)``: the kernel on a CUDA
    tensor, the plain twin on a CPU tensor."""
    if img.is_cuda:
        return detect_cuda(img, threshold)
    return fast.detect(img, threshold)
