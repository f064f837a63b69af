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

Lanes: every tensor may carry a leading lane axis (levels [B, H, W],
points [B, N, 2], valid [B, N]), and B independent sequences are then one
launch, each lane bitwise equal to a one-lane launch on it.
``track_pyramid`` goes through the custom operator
``ekf_vio_tpu_torch::lk_track_pyramid``, whose vmap rule folds the lanes
of ``torch.func.vmap`` into that one launch (the counterpart of
``pallas_lk.track``'s ``custom_vmap`` rule); a ctypes launch needs real
tensors, which a vmapped tensor is not.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ekf_vio_tpu_torch import cuda_lib
from ekf_vio_tpu_torch.frontend.lanes import (call_with_lanes, fold_lanes,
                                              unfold_lanes)

SOURCE = "ekf_vio_tpu_torch/csrc/lk_level.cu"
# the fused kernel replaces _prep_kernel (:200) and _iter_kernel (:326)
REPLACES = "ekf_vio_tpu/frontend/pallas_lk.py:200"
MAX_LEVELS = 4   # csrc/lk_level.cu kMaxLevels
MAX_WINDOW = 32  # at most 4 window pixels per thread, 256 threads a feature

NAME = "lk_level"


def launches() -> int:
    """Kernel launches since the last ``reset_launches``, counted on the
    card by each launch itself (``csrc/launch_count.cuh``), the replays
    of a CUDA graph included; 0 where the kernel never ran."""
    return cuda_lib.launch_count(NAME)


def reset_launches() -> None:
    """Set ``launches()`` to 0."""
    cuda_lib.reset_launch_count(NAME)


class Levels(ctypes.Structure):
    """csrc/lk_level.cu ``LkLevels`` and csrc/klt_level.cu ``KltLevels``
    (the same layout), passed by value: the levels of one call, finest
    first, each a [H, W] image or a [B, H, W] stack of lanes."""
    _fields_ = [("prev", ctypes.c_void_p * MAX_LEVELS),
                ("cur", ctypes.c_void_p * MAX_LEVELS),
                ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS),
                ("inv_scale", ctypes.c_float * MAX_LEVELS),
                ("lane_stride", ctypes.c_longlong * MAX_LEVELS)]

    @classmethod
    def of(cls, prevs, curs, inv_scales) -> "Levels":
        """The struct for these level images (finest first) and the
        factors from the caller's points to each level."""
        lv = cls()
        for e, (p, c, s) in enumerate(zip(prevs, curs, inv_scales)):
            lv.prev[e], lv.cur[e] = p.data_ptr(), c.data_ptr()
            lv.h[e], lv.w[e] = p.shape[-2:]
            lv.inv_scale[e] = s
            lv.lane_stride[e] = p.shape[-2] * p.shape[-1]
        return lv


def check_layout(lib, prefix: str) -> None:
    """Raise unless the library's ``<prefix>_max_levels()`` and
    ``<prefix>_levels_size()`` agree with ``Levels``."""
    if getattr(lib, f"{prefix}_max_levels")() != MAX_LEVELS:
        raise RuntimeError(f"{prefix}_level.cu and the wrapper disagree on "
                           f"the number of levels")
    if getattr(lib, f"{prefix}_levels_size")() != ctypes.sizeof(Levels):
        raise RuntimeError(f"{prefix}_level.cu and lk_cuda.Levels disagree "
                           f"on the layout of the levels struct")


@functools.cache
def _lib():
    lib = cuda_lib.load(NAME)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lk_track_pyramid.argtypes = [Levels, ci, vp, vp, vp, ci, ci, ci, ci,
                                     cf, cf, ci, vp, vp, vp, vp, ci, vp]
    lib.lk_track_pyramid.restype = ctypes.c_int
    check_layout(lib, "lk")
    return lib


def _check(name, t, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the points on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def _check_points(q, g, valid) -> None:
    lanes = tuple(q.shape[:-2])  # () or (B,)
    n = q.shape[-2] if q.dim() >= 2 else -1
    if (len(lanes) > 1 or q.shape != (*lanes, n, 2)
            or g.shape != (*lanes, n, 2) or valid.shape != (*lanes, n)):
        raise ValueError(f"expected q, g [N, 2] and valid [N] (or [B, N, 2]"
                         f" and [B, N]), got {tuple(q.shape)}, "
                         f"{tuple(g.shape)}, {tuple(valid.shape)}")
    for name, t, dtype in (("q", q, torch.float32), ("g", g, torch.float32),
                           ("valid", valid, torch.bool)):
        _check(name, t, dtype, q.device)


def _check_level(prev, cur, q) -> None:
    _check("prev", prev, torch.float32, q.device)
    _check("cur", cur, torch.float32, q.device)
    if prev.dim() != q.dim() or prev.shape != cur.shape:
        raise ValueError(f"level images must be [H, W] (with points [N, 2])"
                         f" or [B, H, W] (with points [B, N, 2]) and equal:"
                         f" {tuple(prev.shape)} vs {tuple(cur.shape)}")
    if prev.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"{prev.shape[0]} lanes of images, "
                         f"{q.shape[0]} of points")


def check_inputs(prev, cur, q, g, valid) -> None:
    """Raise on what the LK kernels do not take for one level."""
    _check_points(q, g, valid)
    _check_level(prev, cur, q)


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
        _check_level(prev_pyr[lvl], cur_pyr[lvl], prev_pts)


def _launch(prevs, curs, inv_scales, pts, init, valid, *, win: int,
            iters: int, eps: float, min_eigen: float, gate_finest: bool):
    """One kernel launch over the given levels (finest first)."""
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"window {win} outside 1..{MAX_WINDOW}")
    n, lanes = pts.shape[-2], (pts.shape[0] if pts.dim() == 3 else 1)
    dev = pts.device
    g_out = torch.empty_like(pts)
    ok = torch.empty_like(valid)
    eig = torch.empty(valid.shape, dtype=torch.float32, device=dev)
    err = torch.empty_like(eig)
    lib = _lib()
    rc = lib.lk_track_pyramid(
        Levels.of(prevs, curs, inv_scales), len(prevs), pts.data_ptr(),
        init.data_ptr(), valid.data_ptr(), n, lanes, win, iters,
        float(eps) ** 2, float(min_eigen), int(gate_finest), g_out.data_ptr(),
        ok.data_ptr(), eig.data_ptr(), err.data_ptr(), dev.index,
        cuda_lib.stream_ptr(pts))
    cuda_lib.check(lib, rc, "lk_track_pyramid")
    cuda_lib.note_device(NAME, dev.index)
    return g_out, ok, eig, err


def track_level_cuda(prev, cur, q, g, valid, *, win: int, iters: int,
                     eps: float, min_eigen: float, gate_eig: bool):
    """One level through the kernel.  q, g: [N, 2] (or [B, N, 2] with
    [B, H, W] images) in this level's px.
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
    """Levels hi down to lo in one launch, every lane of lane-shaped
    inputs included; see ``track_pyramid``."""
    if not prev_pts.is_cuda:
        raise ValueError("track_pyramid_cuda needs CUDA tensors")
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi)
    levels = range(lo, hi + 1)
    return _launch([prev_pyr[lvl] for lvl in levels],
                   [cur_pyr[lvl] for lvl in levels],
                   [2.0 ** -lvl for lvl in levels], prev_pts, init_pts,
                   valid, win=win, iters=iters, eps=eps, min_eigen=min_eigen,
                   gate_finest=lo == 0)


@torch.library.custom_op("ekf_vio_tpu_torch::lk_track_pyramid",
                         mutates_args=())
def _lk_op(prev_pyr: list[Tensor], cur_pyr: list[Tensor], prev_pts: Tensor,
           init_pts: Tensor, valid: Tensor, lo: int, hi: int, win: int,
           iters: int, eps: float, min_eigen: float
           ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lane-shaped ``track_pyramid``: levels [B, H, W], points [B, N, 2],
    valid [B, N]; the kernel for CUDA tensors."""
    return track_pyramid_cuda(prev_pyr, cur_pyr, prev_pts, init_pts, valid,
                              lo=lo, hi=hi, win=win, iters=iters, eps=eps,
                              min_eigen=min_eigen)


@_lk_op.register_kernel("cpu")
def _lk_op_cpu(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi, win,
               iters, eps, min_eigen):
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_pyramid_plain(prev_pyr, cur_pyr, prev_pts, init_pts,
                                   valid, lo=lo, hi=hi, win=win, iters=iters,
                                   eps=eps, min_eigen=min_eigen)


@_lk_op.register_vmap
def _lk_op_vmap(info, in_dims, *args):
    return unfold_lanes(info,
                              _lk_op(*fold_lanes(info, in_dims, *args)))


def track_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg, lo: int,
                  hi: int):
    """LK over levels hi down to lo, as ``klt.track``'s level loop runs
    them: the kernel on CUDA tensors, the plain twin on CPU tensors.

    prev_pts, init_pts: [N, 2] level-0 px (the guess enters level hi as
    init_pts / 2**hi); valid: [N] bool; or, with [B, H, W] levels, [B, N,
    2] and [B, N], all lanes in one launch.  Returns level lo's (g [N,2]
    in its px, ok [N] bool, min_eig [N], err [N]), lane-shaped for lanes;
    ok chains ``valid`` through every level, with the min-eigenvalue gate
    at level 0."""
    return call_with_lanes(
        _lk_op, prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi,
        cfg.klt_window_size, cfg.klt_iterations, float(cfg.klt_eps),
        float(cfg.klt_min_eigen))
