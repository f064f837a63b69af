"""FAST-9/16 corner detection, whole-image, in plain PyTorch.

Port of ``ekf_vio_tpu/frontend/fast.py`` (cv::FAST with NMS,
EKFVIO.cpp:242, after the optional blur of EKFVIO.cpp:228-230).  This is
the plain twin of the ``fast9`` CUDA kernel (``frontend/fast_cuda.py``):
the CPU path, and what the kernel is compared with on the card.

The 3-px margin follows the JAX package's dispatch
(``pallas_fast.detect``): from ``MASK_BEFORE_NMS_PIXELS`` up, where the
JAX package runs its Pallas kernel, the margin is zeroed before NMS, as
that kernel does; below it, after NMS, as ``fast.detect`` does.  The two
orders differ next to row and column 3.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ekf_vio_tpu_torch.frontend.lanes import per_lane

# Bresenham circle of radius 3, clockwise from 12 o'clock, as (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9
MARGIN = 3   # ring radius: border pixels are never corners
# h*w from which the margin is applied before NMS (pallas_fast._MIN_PIXELS)
MASK_BEFORE_NMS_PIXELS = 128 * 256


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """0 for non-corners, else the max over qualifying 9-arcs (all
    brighter than c+t or all darker than c−t) of Σ(|ring − c| − t).
    The ring reads an edge-padded image."""
    img = img.to(torch.float32)
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w]
                        for dy, dx in CIRCLE])
    diff = ring - img[None]
    bright = diff > threshold
    dark = diff < -threshold
    excess = torch.abs(diff) - threshold
    wrap = ARC_LEN - 1
    bright2 = torch.cat([bright, bright[:wrap]])
    dark2 = torch.cat([dark, dark[:wrap]])
    excess2 = torch.cat([excess, excess[:wrap]])

    score = torch.zeros_like(img)
    for s in range(16):
        b_ok = torch.all(bright2[s: s + ARC_LEN], dim=0)
        d_ok = torch.all(dark2[s: s + ARC_LEN], dim=0)
        # left fold, as the kernel sums: scores reach ~2e3, where one ulp
        # (2.4e-4) of reordering exceeds the 1e-4 bar
        arc_sad = sum(excess2[s + k] for k in range(ARC_LEN))
        score = torch.maximum(score, torch.where(b_ok | d_ok, arc_sad, 0.0))
    return score


def non_max_suppress(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3-neighbourhood maxima; outside the image counts as −inf."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score, 0.0)


def border_mask(score: torch.Tensor) -> torch.Tensor:
    """Zero the 3-px margin where the ring would read padding."""
    h, w = score.shape
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    keep = ((ys >= MARGIN) & (ys < h - MARGIN)
            & (xs >= MARGIN) & (xs < w - MARGIN))
    return torch.where(keep, score, 0.0)


def mask_before_nms(h: int, w: int) -> bool:
    """The margin order of the JAX package at an h x w frame."""
    return h * w >= MASK_BEFORE_NMS_PIXELS


def detect(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Full-frame FAST-9 score map, NMS'd, with the 3-px margin zeroed
    before NMS from ``MASK_BEFORE_NMS_PIXELS`` up and after it below.  A
    [B, H, W] stack runs frame by frame."""
    if img.dim() == 3:
        return per_lane(detect, img, threshold)
    score = fast_score_map(img, threshold)
    if mask_before_nms(*img.shape):
        return non_max_suppress(border_mask(score))
    return border_mask(non_max_suppress(score))


def gaussian_blur(img: torch.Tensor, sigma: float, ksize: int = 5) -> torch.Tensor:
    """Separable Gaussian blur with edge replication (EKFVIO.cpp:228-230)."""
    if sigma <= 0.0:
        return img
    half = ksize // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32)
    kt = torch.exp(-0.5 * (x / sigma) ** 2)
    kt = (kt / kt.sum()).tolist()  # taps as f32-exact Python floats
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, half, half), mode="replicate")[0, 0]
    img = sum(p[i: i + h, :] * kt[i] for i in range(ksize))
    p = F.pad(img[None, None], (half, half, 0, 0), mode="replicate")[0, 0]
    return sum(p[:, i: i + w] * kt[i] for i in range(ksize))
