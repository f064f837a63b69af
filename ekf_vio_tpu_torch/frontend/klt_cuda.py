"""Whole-level LK on the card: the ``klt_level`` CUDA kernel.

Port of ``ekf_vio_tpu/frontend/pallas_klt.py`` (its ``_kernel``,
``csrc/klt_level.cu``).  One launch tracks every feature through up to
``MAX_LEVELS`` consecutive pyramid levels, coarse to fine, as
``klt.track``'s level loop does under the 'pallas_klt' rule.
``track_pyramid`` launches the kernel for CUDA tensors and runs the plain
version ``frontend/klt.py track_pyramid_klt_plain`` for CPU tensors;
``track_level`` / ``track_level_cuda`` are the same kernel on one level.
Any N and any window up to 40 px are taken; the JAX kernel's
``N % 32 == 0`` lives only in the dispatch rule (``klt.klt_supported``).
Every level must be at least 40x40.  Lanes as in ``lk_cuda``: a leading
lane axis on every tensor makes B sequences one launch, and
``track_pyramid`` goes through the custom operator
``ekf_vio_tpu_torch::klt_track_pyramid``, whose vmap rule folds the lanes
of ``torch.func.vmap`` into that launch (a vmap over
``pallas_klt.track_level_pallas`` in the JAX package).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from ekf_vio_tpu_torch import cuda_lib
from ekf_vio_tpu_torch.frontend import lk_cuda
from ekf_vio_tpu_torch.frontend.lanes import (call_with_lanes, fold_lanes,
                                              unfold_lanes)

SOURCE = "ekf_vio_tpu_torch/csrc/klt_level.cu"
REPLACES = "ekf_vio_tpu/frontend/pallas_klt.py:138"
PATCH = 40  # pallas_klt.PATCH
MAX_LEVELS = lk_cuda.MAX_LEVELS  # csrc/klt_level.cu kMaxLevels

NAME = "klt_level"


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
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.klt_track_pyramid.argtypes = [lk_cuda.Levels, ci, vp, vp, vp, ci, ci,
                                      ci, ci, cf, cf, ci, ci, vp, vp, vp, vp,
                                      ci, vp]
    lib.klt_track_pyramid.restype = ctypes.c_int
    lk_cuda.check_layout(lib, "klt")
    return lib


def _check_sizes(levels, win: int) -> None:
    if not 1 <= win <= PATCH:
        raise ValueError(f"window {win} does not fit the {PATCH}-px patch")
    for img in levels:
        h, w = img.shape[-2:]
        if h < PATCH or w < PATCH:
            raise ValueError(f"klt_level needs levels of at least {PATCH}x"
                             f"{PATCH}, got {h}x{w}")


def _launch(prevs, curs, inv_scales, pts, init, valid, *, win: int,
            iters: int, eps: float, min_eigen: float, gate_finest: bool,
            include_valid: bool):
    """One kernel launch over the given levels (finest first)."""
    n, lanes = pts.shape[-2], (pts.shape[0] if pts.dim() == 3 else 1)
    dev = pts.device
    g_out = torch.empty_like(pts)
    ok = torch.empty_like(valid)
    eig = torch.empty(valid.shape, dtype=torch.float32, device=dev)
    err = torch.empty_like(eig)
    lib = _lib()
    rc = lib.klt_track_pyramid(
        lk_cuda.Levels.of(prevs, curs, inv_scales), len(prevs),
        pts.data_ptr(), init.data_ptr(), valid.data_ptr(), n, lanes, win,
        iters, float(eps) ** 2, float(min_eigen), int(gate_finest),
        int(include_valid), g_out.data_ptr(), ok.data_ptr(), eig.data_ptr(),
        err.data_ptr(), dev.index, cuda_lib.stream_ptr(pts))
    cuda_lib.check(lib, rc, "klt_track_pyramid")
    cuda_lib.note_device(NAME, dev.index)
    return g_out, ok, eig, err


def track_level_cuda(prev, cur, q, g, valid, *, win: int, iters: int,
                     eps: float, min_eigen: float):
    """One level through the kernel.  q, g: [N, 2] (or [B, N, 2] with
    [B, H, W] images) in this level's px.
    Returns (g [N,2], ok [N] bool, min_eig [N], err [N]); ok does NOT
    include ``valid``."""
    if not prev.is_cuda:
        raise ValueError("track_level_cuda needs CUDA tensors")
    lk_cuda.check_inputs(prev, cur, q, g, valid)
    _check_sizes([prev], win)
    return _launch([prev], [cur], [1.0], q, g, valid, win=win, iters=iters,
                   eps=eps, min_eigen=min_eigen, gate_finest=True,
                   include_valid=False)


def track_level(prev, cur, q, g, valid, *, win: int, iters: int, eps: float,
                min_eigen: float):
    """One level of ``pallas_klt.track_level_pallas``: the kernel on CUDA
    tensors, the plain version on CPU tensors.  ok excludes ``valid``."""
    kw = dict(win=win, iters=iters, eps=eps, min_eigen=min_eigen)
    if prev.is_cuda:
        return track_level_cuda(prev, cur, q, g, valid, **kw)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_level_klt_plain(prev, cur, q, g, valid, **kw)


def check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo: int,
                  hi: int, win: int) -> None:
    """Raise on what ``track_pyramid`` does not take: what
    ``lk_cuda.check_pyramid`` refuses, a level under 40x40, a window over
    40 px."""
    lk_cuda.check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo,
                          hi)
    _check_sizes(prev_pyr[lo: hi + 1], win)


def track_pyramid_cuda(prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
                       lo: int, hi: int, win: int, iters: int, eps: float,
                       min_eigen: float):
    """Levels hi down to lo in one launch, every lane of lane-shaped
    inputs included; see ``track_pyramid``."""
    if not prev_pts.is_cuda:
        raise ValueError("track_pyramid_cuda needs CUDA tensors")
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi, win)
    levels = range(lo, hi + 1)
    return _launch([prev_pyr[lvl] for lvl in levels],
                   [cur_pyr[lvl] for lvl in levels],
                   [2.0 ** -lvl for lvl in levels], prev_pts, init_pts,
                   valid, win=win, iters=iters, eps=eps, min_eigen=min_eigen,
                   gate_finest=lo == 0, include_valid=True)


@torch.library.custom_op("ekf_vio_tpu_torch::klt_track_pyramid",
                         mutates_args=())
def _klt_op(prev_pyr: list[Tensor], cur_pyr: list[Tensor], prev_pts: Tensor,
            init_pts: Tensor, valid: Tensor, lo: int, hi: int, win: int,
            iters: int, eps: float, min_eigen: float
            ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Lane-shaped ``track_pyramid``: levels [B, H, W], points [B, N, 2],
    valid [B, N]; the kernel for CUDA tensors."""
    return track_pyramid_cuda(prev_pyr, cur_pyr, prev_pts, init_pts, valid,
                              lo=lo, hi=hi, win=win, iters=iters, eps=eps,
                              min_eigen=min_eigen)


@_klt_op.register_kernel("cpu")
def _klt_op_cpu(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi, win,
                iters, eps, min_eigen):
    check_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi, win)
    from ekf_vio_tpu_torch.frontend import klt

    return klt.track_pyramid_klt_plain(
        prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo=lo, hi=hi, win=win,
        iters=iters, eps=eps, min_eigen=min_eigen)


@_klt_op.register_vmap
def _klt_op_vmap(info, in_dims, *args):
    return unfold_lanes(
        info, _klt_op(*fold_lanes(info, in_dims, *args)))


def track_pyramid(prev_pyr, cur_pyr, prev_pts, init_pts, valid, cfg, lo: int,
                  hi: int):
    """Whole-level LK over levels hi down to lo, as ``klt.track``'s level
    loop runs them under the 'pallas_klt' rule: the kernel on CUDA
    tensors, the plain version on CPU tensors.

    prev_pts, init_pts: [N, 2] level-0 px (the guess enters level hi as
    init_pts / 2**hi); valid: [N] bool; or, with [B, H, W] levels, [B, N,
    2] and [B, N], all lanes in one launch.  Returns level lo's (g [N,2]
    in its px, ok [N] bool, min_eig [N], err [N]), lane-shaped for lanes;
    ok is ``valid`` and every level's ok, with the min-eigenvalue gate at
    level 0 only."""
    return call_with_lanes(
        _klt_op, prev_pyr, cur_pyr, prev_pts, init_pts, valid, lo, hi,
        cfg.klt_window_size, cfg.klt_iterations, float(cfg.klt_eps),
        float(cfg.klt_min_eigen))
