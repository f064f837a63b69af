"""Image pyramid: 5-tap binomial blur + 2x decimation (cv::pyrDown).

Port of ``ekf_vio_tpu/frontend/pyramid.py``.  The taps are summed in the
same left fold as the JAX package (Python ``sum``), so integer-valued
frames give bitwise-equal levels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_pad(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate-pad a [H, W] image by ph rows and pw columns each side."""
    return F.pad(img[None, None], (pw, pw, ph, ph), mode="replicate")[0, 0]


def _sep_filter5(img: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    p = _edge_pad(img, 2, 0)
    img = sum(p[i: i + h, :] * _K5[i] for i in range(5))
    p = _edge_pad(img, 0, 2)
    return sum(p[:, i: i + w] * _K5[i] for i in range(5))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur, then keep the even rows and columns."""
    return _sep_filter5(img)[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> tuple:
    """(level0, ..., level_levels), level L downscaled by 2^L
    (calcOpticalFlowPyrLK's maxLevel convention)."""
    out = [img.to(torch.float32)]
    for _ in range(levels):
        out.append(pyr_down(out[-1]))
    return tuple(out)
