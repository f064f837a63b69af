"""Camera / frame model: pixel↔metric maps, kill-pad test, downscaling.

Port of ``ekf_vio_tpu/frontend/camera.py`` (Feature.h:60-66,
Frame.cpp:15-55).  Intrinsics are plain Python floats, so the maps are
scalar tensor ops with no host-to-device copies inside a step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Pinhole intrinsics of the processed-scale image."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @classmethod
    def from_K(cls, K, width: int, height: int) -> "Camera":
        """From a 3x3 K; entries are rounded to f32 as the JAX package
        stores them (``engine.make_hashable_camera``)."""
        import numpy as np

        k = np.asarray(K, dtype=np.float32).tolist()
        return cls(k[0][0], k[1][1], k[0][2], k[1][2], int(width), int(height))

    def K(self) -> list:
        return [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                [0.0, 0.0, 1.0]]


def pixel_to_metric(cam: Camera, px: torch.Tensor) -> torch.Tensor:
    """[..., 2] pixel → normalized metric coords (Feature.h:60-62)."""
    return torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                        (px[..., 1] - cam.cy) / cam.fy], -1)


def metric_to_pixel(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """[..., 2] normalized metric → pixel coords (Feature.h:64-66)."""
    return torch.stack([uv[..., 0] * cam.fx + cam.cx,
                        uv[..., 1] * cam.fy + cam.cy], -1)


def in_kill_box(cam: Camera, px: torch.Tensor, kill_pad: float) -> torch.Tensor:
    """True where the pixel is at least kill_pad from every border
    (Frame.cpp:44-55, KLTTracker.cpp:73)."""
    x, y = px[..., 0], px[..., 1]
    return ((x >= kill_pad) & (y >= kill_pad)
            & (cam.width - x >= kill_pad) & (cam.height - y >= kill_pad))


def downscale_image(img: torch.Tensor, inverse_scale: int) -> torch.Tensor:
    """Area-mean downscale by an integer factor over the last two axes
    (Frame.cpp:18-19; cv::INTER_AREA for integer factors)."""
    if inverse_scale == 1:
        return img
    s = inverse_scale
    h2, w2 = img.shape[-2] // s, img.shape[-1] // s
    img = img[..., : h2 * s, : w2 * s]
    img = img.reshape(*img.shape[:-2], h2, s, w2, s)
    return img.mean(dim=(-3, -1))
