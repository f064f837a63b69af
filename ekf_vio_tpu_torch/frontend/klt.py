"""Pyramidal Lucas-Kanade feature tracker.

Port of ``ekf_vio_tpu/frontend/klt.py`` (cv::calcOpticalFlowPyrLK
semantics, KLTTracker.cpp:61-64): 21x21 window, 30 iterations, eps 0.01,
initial-flow seeding at the EKF-predicted positions, ±5 px search per
level, and the min-eigenvalue gate at level 0.

``track_level_plain`` is the plain PyTorch LK for one level: the CPU path,
the reference the ``lk_level`` CUDA kernel is compared with on the card,
and a port of the JAX ``_track_level`` (bf16-rounded integer-aligned
patches, Scharr gradients, bilinear windows resampled each iteration).
``track`` runs the level loop and hands each level to
``lk_cuda.track_level``, which launches the kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import lk_cuda

_SEARCH_MARGIN = 5  # px of in-patch search range per level beyond the seed
_SMOOTH = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)  # Scharr smoothing
_DERIV = (-1.0, 0.0, 1.0)


class TrackResult(NamedTuple):
    points: torch.Tensor   # [N, 2] tracked positions (px, level-0 coords)
    status: torch.Tensor   # [N] bool — tracked successfully
    error: torch.Tensor    # [N] mean |residual| over the window (level 0)
    min_eig: torch.Tensor  # [N] min eigenvalue of G / window area (level 0)


def _extract_patches(img: torch.Tensor, anchor: torch.Tensor,
                     p: int) -> torch.Tensor:
    """[N, p, p] patches with top-left ``anchor`` ([N, 2] floored floats,
    finite), rows/cols clamped at the image border, values rounded to
    bf16 as the reference's one-hot bf16 extraction rounds them."""
    h, w = img.shape
    ar = torch.arange(p, device=img.device)
    ax = anchor[:, 0].clamp(-p - w, p + w).long()
    ay = anchor[:, 1].clamp(-p - h, p + h).long()
    ys = (ay[:, None] + ar).clamp(0, h - 1)
    xs = (ax[:, None] + ar).clamp(0, w - 1)
    patch = img[ys[:, :, None], xs[:, None, :]]
    return patch.to(torch.bfloat16).to(torch.float32)


def _patch_gradients(patch: torch.Tensor):
    """Scharr x/y gradients of [N, p, p] patches, edge-replicated; the taps
    are summed in the reference's left fold."""
    def sep(x, ky, kx):
        n = x.shape[1]
        xp = torch.cat([x[:, :1], x, x[:, -1:]], 1)
        x = sum(xp[:, i: i + n, :] * ky[i] for i in range(3))
        xp = torch.cat([x[:, :, :1], x, x[:, :, -1:]], 2)
        return sum(xp[:, :, i: i + n] * kx[i] for i in range(3))

    return sep(patch, _SMOOTH, _DERIV), sep(patch, _DERIV, _SMOOTH)


def _window_taps(floor_base: torch.Tensor, frac: torch.Tensor, win: int,
                 p: int):
    """Bilinear taps of a window along one axis (the reference's
    ``_lerp_selector``): row i blends patch rows (i0+i, i0+i+1), clamped
    into the patch; a clamped pair that coincides carries both weights."""
    i0 = torch.nan_to_num(floor_base).clamp(-2 * p, 2 * p).long()
    idx = i0[:, None] + torch.arange(win, device=frac.device)
    a = idx.clamp(0, p - 1)
    b = (idx + 1).clamp(0, p - 1)
    wa = (1.0 - frac)[:, None].expand(-1, win)
    wb = frac[:, None].expand(-1, win)
    same = a == b
    return a, b, torch.where(same, wa + wb, wa), torch.where(same, 0.0, wb)


def _sample_windows(patch: torch.Tensor, center: torch.Tensor,
                    win: int) -> torch.Tensor:
    """Bilinear [N, win, win] windows centred at ``center`` (in-patch
    coords): rows interpolated first, then columns."""
    n, p, _ = patch.shape
    base = center - (win - 1) / 2.0
    fl = torch.floor(base)
    frac = base - fl
    ya, yb, wya, wyb = _window_taps(fl[:, 1], frac[:, 1], win, p)
    xa, xb, wxa, wxb = _window_taps(fl[:, 0], frac[:, 0], win, p)
    rows = lambda i: torch.gather(patch, 1, i[:, :, None].expand(n, win, p))  # noqa: E731
    tmp = rows(ya) * wya[:, :, None] + rows(yb) * wyb[:, :, None]
    cols = lambda i: torch.gather(tmp, 2, i[:, None, :].expand(n, win, win))  # noqa: E731
    return cols(xa) * wxa[:, None, :] + cols(xb) * wxb[:, None, :]


def track_level_plain(prev, cur, q, g, valid, *, win: int, iters: int,
                      eps: float, min_eigen: float, gate_eig: bool):
    """One pyramid level of LK for all N features in plain PyTorch.

    q: [N, 2] positions in this level's prev image; g: [N, 2] guesses in
    its cur image; valid: [N] bool.  Returns (g [N,2], ok [N] bool,
    min_eig [N], err [N]) where ok = valid & in bounds & H invertible &
    within the search margin (& min_eig > min_eigen when gate_eig).

    Runs all ``iters`` iterations with converged features frozen, which
    gives what an early exit gives without reading the device."""
    n = q.shape[0]
    half = (win - 1) // 2
    m = _SEARCH_MARGIN
    p = win + 2 * m + 1  # +1 for the bilinear neighbour
    h, w = prev.shape
    off = float(half + m)

    a0 = torch.floor(torch.nan_to_num(q)) - off
    prev_patch = _extract_patches(prev, a0, p)
    pix, piy = _patch_gradients(prev_patch)
    c_prev = q - a0
    template = _sample_windows(prev_patch, c_prev, win).reshape(n, -1)
    ix = _sample_windows(pix, c_prev, win).reshape(n, -1)
    iy = _sample_windows(piy, c_prev, win).reshape(n, -1)

    gxx = torch.sum(ix * ix, -1)
    gxy = torch.sum(ix * iy, -1)
    gyy = torch.sum(iy * iy, -1)
    tr = gxx + gyy
    det_half = torch.sqrt(torch.clamp((gxx - gyy) ** 2 / 4.0 + gxy * gxy,
                                      min=0.0))
    min_eig = (tr / 2.0 - det_half) / (win * win)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = torch.where(inv_ok, det, 1.0)
    i00, i01, i11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe

    g0 = g
    c0 = torch.floor(torch.nan_to_num(g0)) - off
    cur_patch = _extract_patches(cur, c0, p)
    done = torch.zeros_like(valid)
    for _ in range(iters):
        r = template - _sample_windows(cur_patch, g - c0, win).reshape(n, -1)
        bx = torch.sum(r * ix, -1)
        by = torch.sum(r * iy, -1)
        delta = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], -1)
        step_ok = valid & ~done & inv_ok
        g = g + torch.where(step_ok[:, None], delta, 0.0)
        done = done | (torch.sum(delta * delta, -1) < eps ** 2)

    r = template - _sample_windows(cur_patch, g - c0, win).reshape(n, -1)
    err = torch.mean(torch.abs(r), -1)

    within = torch.all(torch.abs(g - g0) <= m, -1)
    in_bounds = ((g[:, 0] >= 1) & (g[:, 1] >= 1)
                 & (g[:, 0] < w - 2) & (g[:, 1] < h - 2)
                 & (q[:, 0] >= 1) & (q[:, 1] >= 1)
                 & (q[:, 0] < w - 2) & (q[:, 1] < h - 2))
    ok = valid & in_bounds & inv_ok & within
    if gate_eig:
        ok = ok & (min_eig > min_eigen)
    return g, ok, min_eig, err


def selected_backend(device) -> str:
    """Which LK ``track`` runs for tensors on ``device``: the CUDA kernel
    ('cuda_lk') or the plain PyTorch twin ('torch')."""
    return "cuda_lk" if torch.device(device).type == "cuda" else "torch"


def track(prev_pyr: tuple, cur_pyr: tuple, prev_pts: torch.Tensor,
          init_pts: torch.Tensor, valid: torch.Tensor,
          cfg: VIOConfig) -> TrackResult:
    """Pyramidal LK over all features at once.

    prev_pts: [N, 2] level-0 px in the previous frame; init_pts: [N, 2]
    level-0 px guesses in the current frame (OPTFLOW_USE_INITIAL_FLOW,
    KLTTracker.cpp:53-64); valid: [N] bool.  Levels smaller than the
    window are skipped, as cv::buildOpticalFlowPyramid clamps maxLevel."""
    win = cfg.klt_window_size
    top = 0
    for lvl, img in enumerate(prev_pyr):
        if min(img.shape) >= win:
            top = lvl
    g = init_pts / float(2 ** top)
    ok = valid
    for lvl in range(top, -1, -1):
        q = prev_pts / float(2 ** lvl)
        g, ok, min_eig, err = lk_cuda.track_level(
            prev_pyr[lvl], cur_pyr[lvl], q, g, ok, cfg, gate_eig=lvl == 0)
        if lvl > 0:
            g = g * 2.0
    return TrackResult(points=g, status=ok, error=err, min_eig=min_eig)


def measurement_covariance_metric(cam_fx: float, cam_fy: float, n: int,
                                  cfg: VIOConfig, device=None) -> torch.Tensor:
    """Constant per-feature 2x2 R in metric units: diag(σ²_px) / f²
    (KLTTracker.cpp:75-84, 100-106)."""
    var = cfg.klt_measurement_variance_px
    vx = torch.full((n,), var / (cam_fx * cam_fx), device=device)
    vy = torch.full((n,), var / (cam_fy * cam_fy), device=device)
    return torch.diag_embed(torch.stack([vx, vy], -1))
