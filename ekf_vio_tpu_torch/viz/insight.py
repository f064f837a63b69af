"""Runtime visualization — the "insight" debug rendering.

The port's own copy of ``ekf_vio_tpu/viz/insight.py`` (which needs no
JAX): the reference's annotated feature image (EKFVIO.cpp:379-442),
covariance error ellipses (EKFVIO.cpp:316-377) and landmark point cloud
(EKFVIO.cpp:479-518) as numpy arrays.  Every function takes tensors (on
any device) or arrays.  ``write_png`` stores an image with ``zlib`` and
``struct`` alone, in place of ``cv2.imwrite``.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def _np(x):
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _draw_square(img, x, y, size, color):
    h, w = img.shape[:2]
    s = size // 2
    x0, x1 = max(x - s, 0), min(x + s, w - 1)
    y0, y1 = max(y - s, 0), min(y + s, h - 1)
    if x1 <= x0 or y1 <= y0:
        return
    img[y0, x0:x1] = color
    img[y1, x0:x1] = color
    img[y0:y1, x0] = color
    img[y0:y1, x1] = color


def error_ellipse(cov2: np.ndarray, chi2: float = 0.99):
    """(half_major, half_minor, angle_rad) of the covariance ellipse —
    eigen-decomposition scaled by the chi-square value, the reference's
    getErrorEllipse recipe (EKFVIO.cpp:316-377) minus the OpenCV types."""
    vals, vecs = np.linalg.eigh(_np(cov2))
    order = np.argsort(vals)[::-1]
    vals = vals[order]
    vecs = vecs[:, order]
    angle = float(np.arctan2(vecs[1, 0], vecs[0, 0]))
    if angle < 0:
        angle += 2 * np.pi
    half_major = max(chi2 * np.sqrt(max(vals[0], 0.0)), 0.1)
    half_minor = max(chi2 * np.sqrt(max(vals[1], 0.0)), 0.1)
    return half_major, half_minor, angle


def _draw_ellipse(img, cx, cy, a, b, angle, color, n=64):
    h, w = img.shape[:2]
    t = np.linspace(0, 2 * np.pi, n)
    ca, sa = np.cos(angle), np.sin(angle)
    xs = cx + a * np.cos(t) * ca - b * np.sin(t) * sa
    ys = cy + a * np.cos(t) * sa + b * np.sin(t) * ca
    xs = np.clip(np.round(xs).astype(int), 0, w - 1)
    ys = np.clip(np.round(ys).astype(int), 0, h - 1)
    img[ys, xs] = color


def render_insight(
    img: np.ndarray,
    feat_px: np.ndarray,
    active: np.ndarray,
    feat_cov_px: np.ndarray | None = None,
    marker: int = 22,
):
    """Annotated BGR frame: green squares at tracked features, optional
    cyan covariance ellipses (the publishInsight rendering,
    EKFVIO.cpp:379-442)."""
    img, feat_px, active = _np(img), _np(feat_px), _np(active)
    if feat_cov_px is not None:
        feat_cov_px = _np(feat_cov_px)
    out = np.repeat(np.asarray(img, np.uint8)[..., None], 3, axis=-1)
    green = np.array([0, 255, 0], np.uint8)
    cyan = np.array([0, 255, 255], np.uint8)  # RGB (writers convert to BGR)
    for i in range(len(feat_px)):
        if not active[i]:
            continue
        x, y = int(round(feat_px[i, 0])), int(round(feat_px[i, 1]))
        _draw_square(out, x, y, marker, green)
        if feat_cov_px is not None:
            a, b, ang = error_ellipse(feat_cov_px[i])
            _draw_ellipse(out, feat_px[i, 0], feat_px[i, 1], a, b, ang, cyan)
    return out


def landmarks_point_cloud(feat_mu: np.ndarray, active: np.ndarray,
                          img: np.ndarray | None = None,
                          feat_px: np.ndarray | None = None):
    """[K, 3] camera-frame landmark positions (+ optional [K] intensity),
    un-inverting depth — the publishPoints output (EKFVIO.cpp:479-518)."""
    sel = np.asarray(_np(active), bool)
    mu = _np(feat_mu)[sel]
    z = 1.0 / mu[:, 2]
    pts = np.stack([mu[:, 0] * z, mu[:, 1] * z, z], -1)
    if img is None or feat_px is None:
        return pts, None
    img = _np(img)
    px = _np(feat_px)[sel]
    h, w = img.shape[:2]
    xs = np.clip(np.round(px[:, 0]).astype(int), 0, w - 1)
    ys = np.clip(np.round(px[:, 1]).astype(int), 0, h - 1)
    return pts, np.asarray(img)[ys, xs]


def feature_pixel_covariances(Sigma, cam_fx, cam_fy, n_max: int):
    """[N, 2, 2] per-feature uv covariance in pixel units (metric Σ block
    scaled by the metric→pixel map, getMetric2PixelMap semantics,
    TightlyCoupledEKF.cpp:683-689)."""
    Sigma = _np(Sigma)
    out = np.zeros((n_max, 2, 2), np.float32)
    J = np.diag([float(cam_fx), float(cam_fy)])
    for i in range(n_max):
        s = 22 + 3 * i
        out[i] = J @ Sigma[s : s + 2, s : s + 2] @ J.T
    return out


def write_png(path: str, img) -> None:
    """Store a uint8 image ([H, W] gray or [H, W, 3] RGB) as an 8-bit PNG
    (filter type 0 on every row), with ``zlib`` and ``struct`` only."""
    img = np.ascontiguousarray(_np(img), np.uint8)
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                           0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
