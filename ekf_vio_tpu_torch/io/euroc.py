"""EuRoC MAV dataset loader (cam0 + IMU + ground truth), without OpenCV.

Port of ``ekf_vio_tpu/io/euroc.py``: the ASL folder layout
(mav0/cam0/data.csv, mav0/imu0/data.csv,
mav0/state_groundtruth_estimate0/data.csv) becomes a [T, H, W] image
stack, per-frame-interval IMU batches and a ground-truth table.  The csv
and IMU code is a copy (integer nanosecond stamps).  Images decode
through ``io/frame_loader.py``; undistortion and downscaling, which the
JAX package leaves to ``cv2``, are numpy here and follow OpenCV's
arithmetic:

* ``undistort_map``: ``cv2.initUndistortRectifyMap`` (radtan, new K = K,
  no rectification), computed in float64 and stored as float32;
* ``remap_bilinear``: ``cv2.remap(..., INTER_LINEAR)`` with float maps
  as OpenCV 5 computes it for float images (an exact bilinear blend,
  rows then columns, each a fused multiply-add; taps outside the image
  read 0).  OpenCV 4 rounds the coordinates to 1/32 px first
  (``INTER_TAB_SIZE = 32``); against it the difference is a fraction of
  a gray level;
* ``resize_linear``: ``cv2.resize(img, (w // s, h // s))``, that is
  ``INTER_LINEAR`` (which OpenCV runs as the 2x2 mean at an exact factor
  of 2): at an integer factor it blends the two pixels nearest
  s·d + (s − 1)/2 on each axis, not the s x s box mean.
"""
from __future__ import annotations

import csv
import os
from typing import NamedTuple

import numpy as np

# where find_euroc looks for a sequence folder: $EUROC_ROOT, then the
# usual dataset folders
SEARCH_PATHS = tuple(p for p in (
    os.environ.get("EUROC_ROOT"),
    "/data/euroc",
    os.path.expanduser("~/datasets/euroc"),
    os.path.expanduser("~/euroc"),
) if p)

# cam0 intrinsics/extrinsics from the EuRoC calibration (identical across
# MH/V sequences; values from the dataset's sensor.yaml)
CAM0_K = np.array(
    [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]],
    np.float32,
)
CAM0_DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                     np.float32)  # radtan
CAM0_SIZE = (752, 480)
# body(=IMU)->cam0 extrinsic rotation/translation
T_BC = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float32,
)


class EurocSequence(NamedTuple):
    name: str
    image_times: np.ndarray   # [T] seconds
    image_paths: list         # [T] png paths
    imu_times: np.ndarray     # [M]
    imu_gyro: np.ndarray      # [M, 3]
    imu_accel: np.ndarray     # [M, 3]
    gt_times: np.ndarray      # [G]
    gt_pos: np.ndarray        # [G, 3]
    gt_quat: np.ndarray       # [G, 4] (w, x, y, z)


def find_euroc(sequence: str = "MH_01_easy"):
    for root in SEARCH_PATHS:
        for cand in (os.path.join(root, sequence),
                     os.path.join(root, sequence, "mav0")):
            if os.path.isdir(os.path.join(cand, "mav0")):
                return os.path.join(cand, "mav0")
            if os.path.isdir(os.path.join(cand, "cam0")):
                return cand
    return None


def _read_rows(path):
    with open(path) as f:
        return [row for row in csv.reader(f)
                if row and not row[0].lstrip().startswith("#")]


def _read_csv(path, value_cols):
    """ASL csv → (int64 stamps [ns], float64 values).

    Stamps MUST be parsed as integers: EuRoC nanosecond timestamps
    (~1.4e18) exceed float64's exact-integer range (2^53), so a float
    round-trip corrupts the low digits (and any filename derived from
    them).
    """
    rows = _read_rows(path)
    stamps = np.asarray([int(r[0]) for r in rows], np.int64)
    vals = np.asarray([[r[i] for i in value_cols] for r in rows], np.float64)
    return stamps, vals


def load_sequence(mav0: str, name: str = "euroc") -> EurocSequence:
    cam_rows = _read_rows(os.path.join(mav0, "cam0", "data.csv"))
    img_dir = os.path.join(mav0, "cam0", "data")
    stamps = np.asarray([int(r[0]) for r in cam_rows], np.int64)
    # cam0/data.csv is "timestamp [ns],filename" — use the recorded
    # filename when present rather than re-deriving it from the stamp
    paths = [
        os.path.join(img_dir,
                     r[1].strip() if len(r) > 1 and r[1].strip()
                     else f"{int(r[0]):d}.png")
        for r in cam_rows
    ]

    imu_t, imu = _read_csv(os.path.join(mav0, "imu0", "data.csv"),
                           [1, 2, 3, 4, 5, 6])
    gt_t, gt = _read_csv(
        os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"),
        [1, 2, 3, 4, 5, 6, 7])

    t0 = stamps[0]
    return EurocSequence(
        name=name,
        image_times=((stamps - t0) * 1e-9).astype(np.float32),
        image_paths=paths,
        imu_times=((imu_t - t0) * 1e-9).astype(np.float32),
        imu_gyro=imu[:, 0:3].astype(np.float32),
        imu_accel=imu[:, 3:6].astype(np.float32),
        gt_times=((gt_t - t0) * 1e-9).astype(np.float32),
        gt_pos=gt[:, 0:3].astype(np.float32),
        gt_quat=gt[:, 3:7].astype(np.float32),
    )


def load_images(seq: EurocSequence, start=0, count=None, inverse_scale=4,
                undistort=True, use_native=True):
    """Decode + (optionally) undistort + downscale a window of frames.

    Returns ([T, H, W] float32, scaled K [3, 3]).  PNG decode runs
    through ``frame_loader.FrameLoader`` (the native threaded loader
    where it builds, else the stdlib reader; ``use_native=False`` forces
    the latter); undistortion and downscaling are ``undistort_and_scale``.
    """
    from ekf_vio_tpu_torch.io import frame_loader

    paths = seq.image_paths[start: start + count if count else None]
    frames = [None] * len(paths)
    if use_native and frame_loader.native_available():
        loader = frame_loader.FrameLoader(paths, inverse_scale=1)
        try:
            for i, im in loader:
                frames[i] = im
        finally:
            loader.close()
    else:
        for i, p in enumerate(paths):
            try:
                frames[i] = frame_loader.read_png(p)
            except (OSError, ValueError):
                frames[i] = None
    missing = [paths[i] for i, f in enumerate(frames) if f is None]
    if missing:
        raise FileNotFoundError(missing[0])
    return undistort_and_scale(frames, CAM0_K, CAM0_DIST if undistort
                               else None, inverse_scale)


def undistort_map(K, dist, size):
    """(map_x, map_y) [h, w] float32 of ``cv2.initUndistortRectifyMap(K,
    dist, None, K, size, CV_32FC1)`` for radtan ``dist`` [k1, k2, p1, p2
    (, k3)]: where each pixel of the undistorted image samples the
    distorted one."""
    w, h = size
    K = np.asarray(K, np.float64)
    d = np.zeros(5)
    d[:len(dist)] = np.asarray(dist, np.float64)
    k1, k2, p1, p2, k3 = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ir = np.linalg.inv(K)
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    xw = j * ir[0, 0] + (i * ir[0, 1] + ir[0, 2])
    yw = j * ir[1, 0] + (i * ir[1, 1] + ir[1, 2])
    ww = j * ir[2, 0] + (i * ir[2, 1] + ir[2, 2])
    x, y = xw / ww, yw / ww
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy
    return u.astype(np.float32), v.astype(np.float32)


def _lerp(a, b, t):
    """a + (b − a) t in float32 with one rounding for the multiply-add,
    as a fused multiply-add computes it (the product of two float32 values
    is exact in float64)."""
    d = (b - a).astype(np.float64)
    return (a.astype(np.float64) + d * t.astype(np.float64)).astype(
        np.float32)


def remap_bilinear(img, map_x, map_y):
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR)`` of a float32 image
    with float maps, as OpenCV 5 computes it: each row pair blended along
    x, then the two blended along y, taps outside the image reading 0
    (``BORDER_CONSTANT``).  OpenCV 4 rounds the map to 1/32 px first
    (``INTER_TAB_SIZE``), a difference of a fraction of a gray level."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    x0, y0 = np.floor(mx), np.floor(my)
    fx, fy = mx - x0, my - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    pad = np.zeros((h + 2, w + 2), np.float32)  # 0 outside the image
    pad[1:-1, 1:-1] = img

    def tap(dy, dx):
        return pad[np.clip(y0 + dy, -1, h) + 1, np.clip(x0 + dx, -1, w) + 1]

    top = _lerp(tap(0, 0), tap(0, 1), fx)
    bottom = _lerp(tap(1, 0), tap(1, 1), fx)
    return _lerp(top, bottom, fy)


def _linear_taps(n_src: int, n_dst: int):
    """cv2.resize INTER_LINEAR along one axis: (left tap, weight of the
    left tap, weight of the right tap) of each destination index."""
    scale = 1.0 / (n_dst / n_src)  # OpenCV's 1 / inv_scale
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    f = np.where(s < 0, np.float32(0), f)
    s = np.maximum(s, 0)
    last = s >= n_src - 1
    f = np.where(last, np.float32(0), f)
    s = np.where(last, n_src - 1, s)
    return s, np.float32(1.0) - f, f


def resize_linear(img, dsize):
    """``cv2.resize(img, dsize)`` (INTER_LINEAR) of a float32 image, dsize
    (w, h): rows blended first, then columns, as OpenCV's separable
    passes do; at an exact factor of 2 the 2x2 mean, as OpenCV runs it."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    dw, dh = dsize
    if w == 2 * dw and h == 2 * dh:
        return ((img[0::2, 0::2] + img[0::2, 1::2])
                + (img[1::2, 0::2] + img[1::2, 1::2]))[:dh, :dw] \
            * np.float32(0.25)
    sx, ax, bx = _linear_taps(w, dw)
    sy, ay, by = _linear_taps(h, dh)
    sx1, sy1 = np.minimum(sx + 1, w - 1), np.minimum(sy + 1, h - 1)
    rows = img[:, sx] * ax + img[:, sx1] * bx       # [h, dw]
    return rows[sy] * ay[:, None] + rows[sy1] * by[:, None]


def undistort_and_scale(frames, K, dist, inverse_scale=4):
    """Radtan-undistort + downscale a list/array of frames (the
    reference's rectify nodelet, then the Frame-ctor downscale).
    ``dist`` is a radtan [k1, k2, p1, p2(, k3)] or None.  Returns ([T, H,
    W] float32, scaled K)."""
    newK = np.asarray(K, np.float32).copy()
    maps = None
    if dist is not None:
        h, w = frames[0].shape
        maps = undistort_map(K, dist, (w, h))
    imgs = []
    for im in frames:
        im = np.asarray(im, np.float32)
        if maps is not None:
            im = remap_bilinear(im, *maps)
        if inverse_scale != 1:
            im = resize_linear(im, (im.shape[1] // inverse_scale,
                                    im.shape[0] // inverse_scale))
        imgs.append(im.astype(np.float32))
    Ks = newK / inverse_scale
    Ks[2, 2] = 1.0
    return np.stack(imgs), Ks


def imu_between_frames(seq: EurocSequence, start=0, count=None,
                       max_per_frame=12):
    """Per-frame-interval IMU batches, zero-padded to max_per_frame.

    Returns ImuSample-compatible arrays dt [T-1, K], gyro/accel [T-1, K, 3]
    (gyro/accel rotated into the cam0 frame so the whole filter runs in
    the camera frame, absorbing the reference's tf base→camera lookup,
    EKFVIO.cpp:89-107).
    """
    t_img = seq.image_times[start : start + count if count else None]
    R_bc = T_BC[:3, :3]
    gyro_c = (R_bc.T @ seq.imu_gyro.T).T
    accel_c = (R_bc.T @ seq.imu_accel.T).T

    T = len(t_img)
    dt = np.zeros((T - 1, max_per_frame), np.float32)
    gy = np.zeros((T - 1, max_per_frame, 3), np.float32)
    ac = np.zeros((T - 1, max_per_frame, 3), np.float32)
    for i in range(T - 1):
        m = (seq.imu_times > t_img[i]) & (seq.imu_times <= t_img[i + 1])
        idx = np.nonzero(m)[0][:max_per_frame]
        times = np.concatenate([[t_img[i]], seq.imu_times[idx]])
        k = len(idx)
        dt[i, :k] = np.diff(times)
        gy[i, :k] = gyro_c[idx]
        ac[i, :k] = accel_c[idx]
    return dt, gy, ac
