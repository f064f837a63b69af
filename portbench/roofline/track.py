"""The least work any tracker must do for one ``vio.track`` call.

Counted from what the call had to produce, not from how a kernel does it:
for every feature that came through the call tracked, at every pyramid
level the call uses, a tracker must read the ``win x win`` template around
the feature's previous position in the previous image and the ``win x
win`` window around its final position in the current image, and do at
least one Lucas-Kanade iteration on them: per window pixel the residual
(1), the two gradient products (2), their two sums (2) and the bilinear
blend of the current window (6), 11 operations.  Bytes count each image
pixel once however many windows cover it (the union of the windows at
each level), as the card's caches would let the best implementation read
them; every feature entering the call has its inputs (previous point,
guess, live flag: 17 bytes) read and its outputs (point, status,
min-eigenvalue, error: 17 bytes) written once.  Features that failed are
not charged any window or iteration, so the count stays below every
implementation's work and a share of it cannot pass 100 %.
"""
from __future__ import annotations

import json
from pathlib import Path

FLOPS_PER_WINDOW_PIXEL = 11
IO_BYTES_PER_FEATURE = 17 + 17


def level_shapes(height: int, width: int, max_level: int, win: int) -> list:
    """(h, w) of the levels 0..top whose image holds the window (smaller
    ones are skipped, as cv::buildOpticalFlowPyramid clamps maxLevel);
    each level halves the last, rounding up, as 2x decimation does."""
    shapes, h, w = [], height, width
    for _ in range(max_level + 1):
        if min(h, w) < win:
            break
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return shapes


def _union_pixels(pts, shape, win: int) -> int:
    """Distinct pixels of an (h, w) image under win x win windows centred
    at ``pts`` [M, 2] (x, y), clipped to the image."""
    import torch

    h, w = shape
    if pts.shape[0] == 0:
        return 0
    half = (win - 1) // 2
    lo = torch.floor(pts).long() - half
    ar = torch.arange(win, device=pts.device)
    ys = (lo[:, 1, None] + ar)
    xs = (lo[:, 0, None] + ar)
    mask = torch.zeros(h + 2 * win, w + 2 * win, dtype=torch.bool,
                       device=pts.device)
    mask[(ys + win)[:, :, None], (xs + win)[:, None, :]] = True
    return int(mask[win:win + h, win:win + w].sum())


def work(prev_px, cur_px, tracked, entering: int, shapes, win: int) -> tuple:
    """(bytes, flops) of one track call: ``prev_px`` / ``cur_px`` [N, 2]
    level-0 pixel positions before and after the call, ``tracked`` [N]
    the features that came through it, ``entering`` the live features
    that went in, ``shapes`` the levels' (h, w)."""
    import torch

    finite = torch.isfinite(prev_px).all(-1) & torch.isfinite(cur_px).all(-1)
    keep = tracked & finite
    p, c = prev_px[keep], cur_px[keep]
    nbytes = entering * IO_BYTES_PER_FEATURE
    for lvl, shape in enumerate(shapes):
        s = float(2 ** lvl)
        nbytes += 4 * (_union_pixels(p / s, shape, win)
                       + _union_pixels(c / s, shape, win))
    flops = int(keep.sum()) * len(shapes) * FLOPS_PER_WINDOW_PIXEL * win * win
    return nbytes, flops


def peaks(kind: str) -> dict:
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    if kind not in table:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return table[kind]


def bound_s(nbytes: int, flops: int, kind: str) -> float:
    """Seconds the card needs at least for (bytes, flops): the larger of
    bytes over the HBM rate and operations over the f32 rate."""
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["f32_flops_per_s"])
