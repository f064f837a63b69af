"""Pyramidal LK on the card: the ``lk_level`` CUDA kernel.

Port of ``ekf_vio_tpu/frontend/pallas_lk.py`` (its ``_prep_kernel`` and
``_iter_kernel``, fused, ``csrc/lk_level.cu``).  One launch tracks every
feature through up to ``MAX_LEVELS`` consecutive pyramid levels, coarse to
fine, as ``klt.track``'s level loop does.  ``track_pyramid`` launches the
kernel for CUDA tensors and runs the plain twin
``frontend/klt.py track_pyramid_plain`` for CPU tensors;
``track_level_cuda`` is the same kernel on one level.  Any N and any
window up to 32 px are taken; the JAX kernel's ``N % 32 == 0`` and
``win == 21`` limits do not apply.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ekf_vio_tpu_torch import cuda_lib

SOURCE = "ekf_vio_tpu_torch/csrc/lk_level.cu"
# the fused kernel replaces _prep_kernel (:200) and _iter_kernel (:326)
REPLACES = "ekf_vio_tpu/frontend/pallas_lk.py:200"
MAX_LEVELS = 4   # csrc/lk_level.cu kMaxLevels
MAX_WINDOW = 32  # at most 4 window pixels per thread, 256 threads a feature

# kernel launches (one per pyramid call or level call) since the last reset
launches = 0


class Levels(ctypes.Structure):
    """csrc/lk_level.cu ``LkLevels`` and csrc/klt_level.cu ``KltLevels``
    (the same layout), passed by value: the levels of one call, finest
    first."""
    _fields_ = [("prev", ctypes.c_void_p * MAX_LEVELS),
                ("cur", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("inv_scale", ctypes.c_float * MAX_LEVELS)]

    @classmethod
    def of(cls, prevs, curs, inv_scales) -> "Levels":
        """The struct for these level images (finest first) and the
        factors from the caller's points to each level."""
        lv = cls()
        for e, (p, c, s) in enumerate(zip(prevs, curs, inv_scales)):
            lv.prev[e], lv.cur[e] = p.data_ptr(), c.data_ptr()
            lv.h[e], lv.w[e] = p.shape
            lv.inv_scale[e] = s
        return lv


@functools.cache
def _lib():
    lib = cuda_lib.load("lk_level")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_track_pyramid.argtypes = [Levels, ci, vp, vp, vp, ci, ci, ci, cf,
                                     cf, ci, vp, vp, vp, vp, ci, vp]
    lib.lk_track_pyramid.restype = ctypes.c_int
    if lib.lk_max_levels() != MAX_LEVELS:
        raise RuntimeError("lk_level.cu and lk_cuda.py disagree on the "
                           "number of levels")
    return lib


def _check(name, t, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the points on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _check_points(q, g, valid) -> None:
    n = q.shape[0]
    if q.shape != (n, 2) or g.shape != (n, 2) or valid.shape != (n,):
        raise ValueError(f"expected q, g [N, 2] and valid [N], got "
                         f"{tuple(q.shape)}, {tuple(g.shape)}, "
                         f"{tuple(valid.shape)}")
    for name, t, dtype in (("q", q, torch.float32), ("g", g, torch.float32),
                           ("valid", valid, torch.bool)):
        _check(name, t, dtype, q.device)


def _check_level(prev, cur, dev) -> None:
    _check("prev", prev, torch.float32, dev)
    _check("cur", cur, torch.float32, dev)
    if prev.dim() != 2 or prev.shape != cur.shape:
        raise ValueError(f"level images must be [H, W] and equal: "
                         f"{tuple(prev.shape)} vs {tuple(cur.shape)}")


def check_inputs(prev, cur, q, g, valid) -> None:
    """Raise on what the LK kernels do not take for one level."""
    _check_points(q, g, valid)
    _check_level(prev, cur, q.device)


def check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo: int,
                  hi: int) -> None:
    """Raise on what ``track_pyramid`` does not take: levels lo..hi must
    exist in both pyramids, be at most ``MAX_LEVELS`` and pass
    ``check_inputs`` each (the points are checked once)."""
    if not 0 <= lo <= hi < min(len(prev_pyr), len(cur_pyr)):
        raise ValueError(f"levels {lo}..{hi} outside pyramids of "
                         f"{len(prev_pyr)} and {len(cur_pyr)} levels")
    if hi - lo + 1 > MAX_LEVELS:
        raise ValueError(f"{hi - lo + 1} levels in one call; the kernel "
                         f"takes at most {MAX_LEVELS}")
    _check_points(prev_pts, init_pts, valid)
    for lvl in range(lo, hi + 1):
        _check_level(prev_pyr[lvl], cur_pyr[lvl], prev_pts.device)


def _launch(prevs, curs, inv_scales, pts, init, valid, *, win: int,
            iters: int, eps: float, min_eigen: float, gate_finest: bool):
    """One kernel launch over the given levels (finest first)."""
    global launches
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"window {win} outside 1..{MAX_WINDOW}")
    n = pts.shape[0]
    dev = pts.device
    g_out = torch.empty_like(pts)
    ok = torch.empty_like(valid)
    stats = torch.empty(2, n, dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.lk_track_pyramid(
        Levels.of(prevs, curs, inv_scales), len(prevs), pts.data_ptr(),
        init.data_ptr(), valid.data_ptr(), n, win, iters, float(eps) ** 2,
        float(min_eigen), int(gate_finest), g_out.data_ptr(), ok.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(), dev.index,
        cuda_lib.stream_ptr(pts))
    cuda_lib.check(lib, rc, "lk_track_pyramid")
    launches += 1
    return g_out, ok, stats[0], stats[1]


def track_level_cuda(prev, cur, q, g, valid, *, win: int, iters: int,
                     eps: float, min_eigen: float, gate_eig: bool):
    """One level through the kernel.  q, g: [N, 2] in this level's px.
    Returns (g [N,2], ok [N] bool, min_eig [N], err [N]); ok already
    includes ``valid``."""
    if not prev.is_cuda:
        raise ValueError("track_level_cuda needs CUDA tensors")
    check_inputs(prev, cur, q, g, valid)
    return _launch([prev], [cur], [1.0], q, g, valid, win=win, iters=iters,
                   eps=eps, min_eigen=min_eigen, gate_finest=gate_eig)


def track_pyramid_cuda(prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
                       lo: int, hi: int, win: int, iters: int, eps: float,
                       min_eigen: float):
    """Levels hi down to lo in one launch; see ``track_pyramid``."""
    if not prev_pts.is_cuda:
        raise ValueError("track_pyramid_cuda needs CUDA tensors")
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi)
    levels = range(lo, hi + 1)
    return _launch([prev_pyr[lvl] for lvl in levels],
                   [cur_pyr[lvl] for lvl in levels],
                   [2.0 ** -lvl for lvl in levels], prev_pts, init_pts,
                   valid, win=win, iters=iters, eps=eps, min_eigen=min_eigen,
                   gate_finest=lo == 0)


def track_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg, lo: int,
                  hi: int):
    """LK over levels hi down to lo, as ``klt.track``'s level loop runs
    them: the kernel on CUDA tensors, the plain twin on CPU tensors.

    prev_pts, init_pts: [N, 2] level-0 px (the guess enters level hi as
    init_pts / 2**hi); valid: [N] bool.  Returns level lo's (g [N,2] in
    its px, ok [N] bool, min_eig [N], err [N]); ok chains ``valid``
    through every level, with the min-eigenvalue gate at level 0."""
    kw = dict(lo=lo, hi=hi, win=cfg.klt_window_size,
              iters=cfg.klt_iterations, eps=cfg.klt_eps,
              min_eigen=cfg.klt_min_eigen)
    if prev_pts.is_cuda:
        return track_pyramid_cuda(prev_pyr, cur_pyr, prev_pts, init_pts,
                                  valid, **kw)
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_pyramid_plain(prev_pyr, cur_pyr, prev_pts, init_pts,
                                   valid, **kw)
