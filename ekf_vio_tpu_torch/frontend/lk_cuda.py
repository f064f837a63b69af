"""One LK pyramid level on the card: the ``lk_level`` CUDA kernel.

Port of ``ekf_vio_tpu/frontend/pallas_lk.py`` (its ``_prep_kernel`` and
``_iter_kernel`` fused into one launch per level, ``csrc/lk_level.cu``).
``track_level`` launches the kernel for CUDA tensors and runs the plain
twin ``frontend/klt.py track_level_plain`` for CPU tensors.  Any N and any
window size are taken; the JAX kernel's ``N % 32 == 0`` and ``win == 21``
limits do not apply.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ekf_vio_tpu_torch import cuda_lib

SOURCE = "ekf_vio_tpu_torch/csrc/lk_level.cu"
# the fused kernel replaces _prep_kernel (:200) and _iter_kernel (:326)
REPLACES = "ekf_vio_tpu/frontend/pallas_lk.py:200"

# kernel launches (one per pyramid level) since the last reset
launches = 0


@functools.cache
def _lib():
    lib = cuda_lib.load("lk_level")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_track_level.argtypes = [vp, vp, ci, ci, vp, vp, vp, ci, ci, ci,
                                   cf, cf, ci, vp, vp, vp, vp, ci, vp]
    lib.lk_track_level.restype = ctypes.c_int
    return lib


def check_inputs(prev, cur, q, g, valid):
    """Raise on what the LK kernels do not take."""
    dev = prev.device
    for name, t in (("prev", prev), ("cur", cur), ("q", q), ("g", g),
                    ("valid", valid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, prev on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if prev.dim() != 2 or prev.shape != cur.shape:
        raise ValueError(f"level images must be [H, W] and equal: "
                         f"{tuple(prev.shape)} vs {tuple(cur.shape)}")
    n = q.shape[0]
    if q.shape != (n, 2) or g.shape != (n, 2) or valid.shape != (n,):
        raise ValueError(f"expected q, g [N, 2] and valid [N], got "
                         f"{tuple(q.shape)}, {tuple(g.shape)}, "
                         f"{tuple(valid.shape)}")
    for name, t, dt in (("prev", prev, torch.float32),
                        ("cur", cur, torch.float32), ("q", q, torch.float32),
                        ("g", g, torch.float32), ("valid", valid, torch.bool)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")


def track_level_cuda(prev, cur, q, g, valid, *, win: int, iters: int,
                     eps: float, min_eigen: float, gate_eig: bool):
    """Launch the kernel for one level.  Returns (g [N,2], ok [N] bool,
    min_eig [N], err [N]); ok already includes ``valid``."""
    global launches
    if not prev.is_cuda:
        raise ValueError("track_level_cuda needs CUDA tensors")
    check_inputs(prev, cur, q, g, valid)
    h, w = prev.shape
    n = q.shape[0]
    g_out = torch.empty_like(g)
    ok = torch.empty_like(valid)
    eig = torch.empty(n, dtype=torch.float32, device=prev.device)
    err = torch.empty(n, dtype=torch.float32, device=prev.device)
    lib = _lib()
    rc = lib.lk_track_level(
        prev.data_ptr(), cur.data_ptr(), h, w, q.data_ptr(), g.data_ptr(),
        valid.data_ptr(), n, win, iters, float(eps) ** 2, float(min_eigen),
        int(gate_eig), g_out.data_ptr(), ok.data_ptr(), eig.data_ptr(),
        err.data_ptr(), prev.device.index, cuda_lib.stream_ptr(prev))
    cuda_lib.check(lib, rc, "lk_track_level")
    launches += 1
    return g_out, ok, eig, err


def track_level(prev, cur, q, g, valid, cfg, gate_eig: bool):
    """One LK level with the status rules of the JAX ``klt._track_level``:
    the kernel on CUDA tensors, the plain twin on CPU tensors.
    ``gate_eig`` adds the level-0 min-eigenvalue gate."""
    kw = dict(win=cfg.klt_window_size, iters=cfg.klt_iterations,
              eps=cfg.klt_eps, min_eigen=cfg.klt_min_eigen,
              gate_eig=gate_eig)
    if prev.is_cuda:
        return track_level_cuda(prev, cur, q, g, valid, **kw)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_level_plain(prev, cur, q, g, valid, **kw)
