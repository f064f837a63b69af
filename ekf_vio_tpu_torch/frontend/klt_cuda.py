"""One whole-level LK pass on the card: the ``klt_level`` CUDA kernel.

Port of ``ekf_vio_tpu/frontend/pallas_klt.py`` (its ``_kernel``, one
launch per level, ``csrc/klt_level.cu``).  ``track_level`` launches the
kernel for CUDA tensors and runs the plain version
``frontend/klt.py track_level_klt_plain`` for CPU tensors.  Any N is
taken; the JAX kernel's ``N % 32 == 0`` lives only in the dispatch rule
(``klt.klt_supported``).  The level must be at least 40x40.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ekf_vio_tpu_torch import cuda_lib
from ekf_vio_tpu_torch.frontend import lk_cuda

SOURCE = "ekf_vio_tpu_torch/csrc/klt_level.cu"
REPLACES = "ekf_vio_tpu/frontend/pallas_klt.py:138"
PATCH = 40  # pallas_klt.PATCH

# kernel launches (one per pyramid level) since the last reset
launches = 0


@functools.cache
def _lib():
    lib = cuda_lib.load("klt_level")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klt_track_level.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, ci, ci,
                                    cf, cf, vp, vp, vp, vp, ci, vp]
    lib.klt_track_level.restype = ctypes.c_int
    return lib


def track_level_cuda(prev, cur, q, g, valid, *, win: int, iters: int,
                     eps: float, min_eigen: float):
    """Launch the kernel for one level.  Returns (g [N,2], ok [N] bool,
    min_eig [N], err [N]); ok does NOT include ``valid``."""
    global launches
    if not prev.is_cuda:
        raise ValueError("track_level_cuda needs CUDA tensors")
    lk_cuda.check_inputs(prev, cur, q, g, valid)
    h, w = prev.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f"klt_level needs a level of at least {PATCH}x"
                         f"{PATCH}, got {h}x{w}")
    if not 1 <= win <= PATCH:
        raise ValueError(f"window {win} does not fit the {PATCH}-px patch")
    n = q.shape[0]
    g_out = torch.empty_like(g)
    ok = torch.empty_like(valid)
    eig = torch.empty(n, dtype=torch.float32, device=prev.device)
    err = torch.empty(n, dtype=torch.float32, device=prev.device)
    lib = _lib()
    rc = lib.klt_track_level(
        prev.data_ptr(), cur.data_ptr(), h, w, q.data_ptr(), g.data_ptr(),
        valid.data_ptr(), n, win, iters, float(eps) ** 2, float(min_eigen),
        g_out.data_ptr(), ok.data_ptr(), eig.data_ptr(), err.data_ptr(),
        prev.device.index, cuda_lib.stream_ptr(prev))
    cuda_lib.check(lib, rc, "klt_track_level")
    launches += 1
    return g_out, ok, eig, err


def track_level(prev, cur, q, g, valid, *, win: int, iters: int, eps: float,
                min_eigen: float):
    """One level of ``pallas_klt.track_level_pallas``: the kernel on CUDA
    tensors, the plain version on CPU tensors.  ok excludes ``valid``."""
    kw = dict(win=win, iters=iters, eps=eps, min_eigen=min_eigen)
    if prev.is_cuda:
        return track_level_cuda(prev, cur, q, g, valid, **kw)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_level_klt_plain(prev, cur, q, g, valid, **kw)
