"""Pyramidal Lucas-Kanade feature tracker.

Port of ``ekf_vio_tpu/frontend/klt.py`` (cv::calcOpticalFlowPyrLK
semantics, KLTTracker.cpp:61-64): 21x21 window, 30 iterations, eps 0.01,
initial-flow seeding at the EKF-predicted positions, ±5 px search per
level, and the min-eigenvalue gate at level 0.

Two level trackers, each a plain PyTorch function and a CUDA kernel:

* ``track_level_plain`` ports the JAX ``_track_level`` (bf16-rounded
  integer-aligned patches of side win + 11, Scharr gradients, bilinear
  windows, iterations until convergence); ``track_pyramid_plain`` loops
  it over consecutive levels.  Their kernel is ``lk_level`` (``lk_cuda``),
  one launch per run of levels, which also stands in for the JAX
  ``pallas_lk`` tracker.
* ``track_level_klt_plain`` ports ``pallas_klt._kernel`` (40x40 patches
  at origins clamped into the image, a fixed iteration count with a
  multiplicative live mask); ``track_pyramid_klt_plain`` loops it over
  consecutive levels.  Their kernel is ``klt_level`` (``klt_cuda``), one
  launch per run of levels.

``track`` picks between them per level by the JAX package's own rule
(``selected_backend``), reading ``cfg.use_pallas_klt`` where the JAX
package asks whether it runs on a TPU, so the border model depends on
the configuration and the shapes only.  The device then decides between
kernel (CUDA tensors) and plain version (CPU tensors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core.state import device_constant
from ekf_vio_tpu_torch.frontend import klt_cuda, lk_cuda
from ekf_vio_tpu_torch.frontend.lanes import per_lane

_SEARCH_MARGIN = 5  # px of in-patch search range per level beyond the seed
_SMOOTH = (3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0)  # Scharr smoothing
_DERIV = (-1.0, 0.0, 1.0)
KLT_PATCH = 40   # pallas_klt.PATCH: per-feature patch side
_KLT_PAD = 17    # pallas_klt._PAD: patch origin floor(pos) - 17
_KLT_BLOCK = 32  # pallas_klt._BLOCK: features per Pallas program


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


def track_pyramid_plain(prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
                        lo: int, hi: int, win: int, iters: int, eps: float,
                        min_eigen: float):
    """Levels hi down to lo of ``track_level_plain``, as ``track`` loops
    over them: the plain twin of one ``lk_level`` pyramid launch.

    prev_pts, init_pts: [N, 2] level-0 px; the guess enters level hi as
    init_pts / 2**hi and each finer level as twice the coarser result,
    and ``valid`` of a level is the status of the coarser one.  Returns
    level lo's (g [N,2] in its px, ok [N] bool, min_eig [N], err [N]),
    with the min-eigenvalue gate at level 0.  Lane-shaped inputs ([B, H,
    W] levels, [B, N, 2] points) run lane by lane."""
    kw = dict(lo=lo, hi=hi, win=win, iters=iters, eps=eps,
              min_eigen=min_eigen)
    if prev_pts.dim() == 3:
        return per_lane(track_pyramid_plain, prev_pyr, cur_pyr, prev_pts,
                        init_pts, valid, **kw)
    g = init_pts / float(2 ** hi)
    ok = valid
    for lvl in range(hi, lo - 1, -1):
        q = prev_pts / float(2 ** lvl)
        g, ok, min_eig, err = track_level_plain(
            prev_pyr[lvl], cur_pyr[lvl], q, g, ok, win=win, iters=iters,
            eps=eps, min_eigen=min_eigen, gate_eig=lvl == 0)
        if lvl > lo:
            g = g * 2.0
    return g, ok, min_eig, err


def _klt_origin(pts: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, 2] patch origins floor(nan_to_num(p)) - 17, clamped so the
    40x40 patch lies inside the h x w level (as floats)."""
    o = torch.floor(torch.nan_to_num(pts)) - _KLT_PAD
    return torch.stack([o[:, 0].clamp(0, w - KLT_PATCH),
                        o[:, 1].clamp(0, h - KLT_PATCH)], -1)


def _klt_gradients(patch: torch.Tensor):
    """Scharr gradients of [N, p, p] patches in ``pallas_klt._scharr``'s
    order: gx = (vertical smooth) shifted right minus shifted left, gy =
    (horizontal smooth) shifted down minus shifted up, edge-replicated at
    the patch border."""
    up = torch.cat([patch[:, :1], patch[:, :-1]], 1)      # row r-1
    down = torch.cat([patch[:, 1:], patch[:, -1:]], 1)    # row r+1
    left = torch.cat([patch[:, :, :1], patch[:, :, :-1]], 2)
    right = torch.cat([patch[:, :, 1:], patch[:, :, -1:]], 2)
    s0, s1, s2 = _SMOOTH
    sm_r = up * s0 + patch * s1 + down * s2
    sm_c = left * s0 + patch * s1 + right * s2
    gx = (torch.cat([sm_r[:, :, 1:], sm_r[:, :, -1:]], 2)
          - torch.cat([sm_r[:, :, :1], sm_r[:, :, :-1]], 2))
    gy = (torch.cat([sm_c[:, 1:], sm_c[:, -1:]], 1)
          - torch.cat([sm_c[:, :1], sm_c[:, :-1]], 1))
    return gx, gy


def track_level_klt_plain(prev, cur, q, g, valid, *, win: int, iters: int,
                          eps: float, min_eigen: float):
    """One pyramid level of ``pallas_klt._kernel`` in plain PyTorch.

    q: [N, 2] positions in this level's prev image; g: [N, 2] guesses in
    its cur image; valid: [N] bool.  The level must be at least 40x40.
    Returns (g [N,2], ok [N] bool, min_eig [N], err [N]) where ok = in
    bounds & H invertible & within the search margin & min_eig >
    min_eigen — NOT including ``valid``: the caller ANDs it, as
    ``klt.track`` does.  Runs exactly ``iters`` iterations; a feature
    moves while it is live (valid, H invertible, not yet converged), and
    a non-finite step reaches g even when it is not (NaN x 0 = NaN)."""
    h, w = prev.shape
    po = _klt_origin(q, h, w)
    co = _klt_origin(g, h, w)
    ps = _extract_patches(prev, po, KLT_PATCH)
    cs = _extract_patches(cur, co, KLT_PATCH)

    c_prev = q - po
    tpl = _sample_windows(ps, c_prev, win)                    # [N, win, win]
    gxp, gyp = _klt_gradients(ps)
    ix = _sample_windows(gxp, c_prev, win)
    iy = _sample_windows(gyp, c_prev, win)

    def wsum(a, b):  # row sums, then their sum (the kernel's order)
        return torch.sum(torch.sum(a * b, -1), -1)

    gxx, gxy, gyy = wsum(ix, ix), wsum(ix, iy), wsum(iy, iy)
    tr = gxx + gyy
    det_half = torch.sqrt(torch.clamp((gxx - gyy) ** 2 / 4.0 + gxy * gxy,
                                      min=0.0))
    min_eig = (tr / 2.0 - det_half) / (win * win)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = torch.where(inv_ok, det, 1.0)
    i00, i01, i11 = gyy / det_safe, -gxy / det_safe, gxx / det_safe

    g0 = g
    live = (valid & inv_ok).to(torch.float32)[:, None]
    for _ in range(iters):
        r = tpl - _sample_windows(cs, g - co, win)
        bx, by = wsum(r, ix), wsum(r, iy)
        delta = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], -1)
        g = g + delta * live
        conv = (torch.sum(delta * delta, -1, keepdim=True)
                < eps * eps).to(torch.float32)
        live = live * (1.0 - conv)

    r = tpl - _sample_windows(cs, g - co, win)
    err = torch.mean(torch.mean(torch.abs(r), -1), -1)
    within = torch.all(torch.abs(g - g0) <= _SEARCH_MARGIN, -1)
    inb = ((g[:, 0] >= 1) & (g[:, 1] >= 1)
           & (g[:, 0] < w - 2) & (g[:, 1] < h - 2)
           & (q[:, 0] >= 1) & (q[:, 1] >= 1)
           & (q[:, 0] < w - 2) & (q[:, 1] < h - 2))
    ok = inb & inv_ok & within & (min_eig > min_eigen)
    return g, ok, min_eig, err


def track_pyramid_klt_plain(prev_pyr, cur_pyr, prev_pts, init_pts, valid, *,
                            lo: int, hi: int, win: int, iters: int,
                            eps: float, min_eigen: float):
    """Levels hi down to lo of ``track_level_klt_plain``, as ``track``
    loops over them under the 'pallas_klt' rule: the plain version of one
    ``klt_level`` pyramid launch.

    prev_pts, init_pts: [N, 2] level-0 px; the guess enters level hi as
    init_pts / 2**hi and each finer level as twice the coarser result;
    ``valid`` of a level is ``valid`` and the ok of every coarser one;
    the min-eigenvalue gate holds at level 0 only (min_eigen = -1
    elsewhere).  Returns level lo's (g [N,2] in its px, ok [N] bool
    including ``valid``, min_eig [N], err [N]).  Lane-shaped inputs run
    lane by lane."""
    if prev_pts.dim() == 3:
        return per_lane(track_pyramid_klt_plain, prev_pyr, cur_pyr,
                        prev_pts, init_pts, valid, lo=lo, hi=hi, win=win,
                        iters=iters, eps=eps, min_eigen=min_eigen)
    g = init_pts / float(2 ** hi)
    ok = valid
    for lvl in range(hi, lo - 1, -1):
        g, inb, min_eig, err = track_level_klt_plain(
            prev_pyr[lvl], cur_pyr[lvl], prev_pts / float(2 ** lvl), g, ok,
            win=win, iters=iters, eps=eps,
            min_eigen=min_eigen if lvl == 0 else -1.0)
        ok = ok & inb
        if lvl > lo:
            g = g * 2.0
    return g, ok, min_eig, err


def lk_supported(n: int, win: int) -> bool:
    """``pallas_lk.supported``: the corr-table tracker's envelope (the
    image size does not enter it)."""
    return win == 21 and n % _KLT_BLOCK == 0


def klt_supported(level_shape, n: int) -> bool:
    """``pallas_klt.supported``: the whole-level kernel's envelope."""
    h, w = level_shape
    return (h >= KLT_PATCH and w >= KLT_PATCH and n % _KLT_BLOCK == 0
            and 2 * h * w * 4 <= 6 * 1024 * 1024)


def tracker_rule(level0_shape, n: int, cfg: VIOConfig) -> str:
    """The JAX package's dispatch (``klt.selected_backend``), rule for
    rule, with ``cfg.use_pallas_klt`` read as "on a TPU": 'pallas_lk',
    'pallas_klt' or 'xla'."""
    if cfg.use_pallas_klt and lk_supported(n, cfg.klt_window_size):
        return "pallas_lk"
    if cfg.use_pallas_klt and level0_shape[0] * level0_shape[1] >= 64 * 1024:
        return "pallas_klt"
    return "xla"


def selected_backend(level0_shape, n: int, cfg: VIOConfig, device) -> str:
    """Which tracker ``track`` runs: 'cuda_klt' / 'torch_klt' when the
    rule is 'pallas_klt' (klt_level on the levels it takes, lk_level on
    the rest), else 'cuda_lk' / 'torch_lk' (lk_level on every level) —
    the kernels for CUDA tensors, the plain versions for CPU tensors."""
    dev = "cuda" if torch.device(device).type == "cuda" else "torch"
    kind = "klt" if tracker_rule(level0_shape, n, cfg) == "pallas_klt" \
        else "lk"
    return f"{dev}_{kind}"


def track(prev_pyr: tuple, cur_pyr: tuple, prev_pts: torch.Tensor,
          init_pts: torch.Tensor, valid: torch.Tensor,
          cfg: VIOConfig) -> TrackResult:
    """Pyramidal LK over all features at once (``klt.track``).

    prev_pts: [N, 2] level-0 px in the previous frame; init_pts: [N, 2]
    level-0 px guesses in the current frame (OPTFLOW_USE_INITIAL_FLOW,
    KLTTracker.cpp:53-64); valid: [N] bool.  Levels smaller than the
    window are skipped, as cv::buildOpticalFlowPyramid clamps maxLevel.
    Under the 'pallas_klt' rule every run of consecutive levels that
    ``klt_supported`` takes is one ``klt_cuda.track_pyramid`` call (eigen
    gate at level 0 only, min_eigen = -1 on coarse levels); every run of
    consecutive other levels (all levels under the 'lk' rule) is one
    ``lk_cuda.track_pyramid`` call.  A call takes at most
    ``lk_cuda.MAX_LEVELS`` levels."""
    win = cfg.klt_window_size
    n = prev_pts.shape[0]
    top = 0
    for lvl, img in enumerate(prev_pyr):
        if min(img.shape) >= win:
            top = lvl
    use_klt = tracker_rule(prev_pyr[0].shape, n, cfg) == "pallas_klt"

    def by_klt(lvl):
        return use_klt and klt_supported(prev_pyr[lvl].shape, n)

    g = None  # the guess at level `lvl`, once a coarser level has run
    ok = valid
    lvl = top
    while lvl >= 0:
        kernel = klt_cuda if by_klt(lvl) else lk_cuda
        lo = lvl  # the finest level of this call
        while (lo > 0 and by_klt(lo - 1) == by_klt(lvl)
               and lvl - lo + 1 < kernel.MAX_LEVELS):
            lo -= 1
        # a pyramid call takes level-0 guesses; scaling by a power of two
        # and back is exact
        init = init_pts if g is None else g * float(2 ** lvl)
        g, ok, min_eig, err = kernel.track_pyramid(
            prev_pyr, cur_pyr, prev_pts, init, ok, cfg, lo, lvl)
        if lo > 0:
            g = g * 2.0
        lvl = lo - 1
    return TrackResult(points=g, status=ok, error=err, min_eig=min_eig)


def measurement_covariance_metric(cam_fx: float, cam_fy: float, n: int,
                                  cfg: VIOConfig, device=None) -> torch.Tensor:
    """Constant per-feature 2x2 R in metric units: diag(σ²_px) / f²
    (KLTTracker.cpp:75-84, 100-106)."""
    var = cfg.klt_measurement_variance_px
    vx = torch.full((n,), var / (cam_fx * cam_fx), device=device)
    vy = torch.full((n,), var / (cam_fy * cam_fy), device=device)
    return torch.diag_embed(torch.stack([vx, vy], -1))


def sample_bilinear(img: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of img [H, W] at pts [..., 2] (x, y);
    out-of-range coordinates clamp to the border."""
    h, w = img.shape
    x, y = pts[..., 0], pts[..., 1]
    x0 = torch.clamp(torch.floor(x), 0, w - 2)
    y0 = torch.clamp(torch.floor(y), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    idx = y0.long() * w + x0.long()
    v00, v01 = flat[idx], flat[idx + 1]
    v10, v11 = flat[idx + w], flat[idx + w + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _window_offsets(win: int, device=None) -> torch.Tensor:
    """[win², 2] integer (x, y) offsets centred on 0, x fastest."""
    half = (win - 1) // 2
    r = torch.arange(win, dtype=torch.float32, device=device) - half
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], -1)


def estimate_uncertainty_sample_based(prev_img, cur_img, mu_ref, mu,
                                      k: float = 0.01, window_size: int = 5):
    """Sample-based SSD covariance estimator (KLTTracker.cpp:111-175):
    SSD between the reference window and windows on a 5x5 grid of ±10 px
    offsets, Gaussian-weighted into a [N, 2, 2] covariance (px²)."""
    dev = prev_img.device
    offs = torch.arange(-10.0, 10.1, 5.0, device=dev)
    du, dv = torch.meshgrid(offs, offs, indexing="ij")
    duv = torch.stack([du.reshape(-1), dv.reshape(-1)], -1)   # [25, 2]
    woffs = _window_offsets(window_size, dev)                 # [ws², 2]
    ref = sample_bilinear(prev_img, mu_ref[:, None, :] + woffs[None])
    pts = (mu[:, None, None, :] + duv[None, :, None, :]
           + woffs[None, None, :, :])
    smp = sample_bilinear(cur_img, pts)                       # [N, 25, ws²]
    ssd = torch.mean((ref[:, None, :] - smp) ** 2, -1)
    rd = torch.exp(-k * ssd)
    s = torch.sum(rd, -1)
    xx = torch.sum(rd * duv[None, :, 0] ** 2, -1) / s
    yy = torch.sum(rd * duv[None, :, 1] ** 2, -1) / s
    xy = torch.sum(rd * duv[None, :, 0] * duv[None, :, 1], -1) / s
    return torch.stack([torch.stack([xx, xy], -1),
                        torch.stack([xy, yy], -1)], -2)


def measurement_covariance(cfg: VIOConfig, cam, prev_img, cur_img, prev_px,
                           points) -> torch.Tensor:
    """[N, 2, 2] metric R of a frame's tracks: constant, or with
    ``klt_covariance='sample'`` the SSD response-surface estimate
    (KLTTracker.cpp:111-175) floored at the constant value, scaled px² →
    metric² by 1/f²."""
    if cfg.klt_covariance != "sample":
        return measurement_covariance_metric(
            cam.fx, cam.fy, cfg.max_features, cfg, device=cur_img.device)
    cov_px = estimate_uncertainty_sample_based(prev_img, cur_img, prev_px,
                                               points)
    eye2 = torch.eye(2, device=cur_img.device)
    cov_px = cov_px + cfg.klt_measurement_variance_px * eye2[None]
    scale = device_constant(
        [1.0 / (cam.fx * cam.fx), 1.0 / (cam.fx * cam.fy),
         1.0 / (cam.fx * cam.fy), 1.0 / (cam.fy * cam.fy)],
        device=cur_img.device).reshape(2, 2)
    return cov_px * scale[None]
