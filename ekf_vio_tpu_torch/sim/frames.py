"""The headline benchmark's synthetic frames, with numpy and scipy only.

A copy of ``bench.make_frames`` (whose module imports JAX): a 640x480
corner-rich blob texture under lateral camera motion, 2 px per frame at
full resolution, 20 frames per second.  Same seed, same frames.
"""
from __future__ import annotations

import numpy as np

W_IN, H_IN = 640, 480
N_FRAMES = 240


def make_frames(seed: int = 0, n_frames: int = N_FRAMES):
    """Returns (frames [T, 480, 640] f32 in [0, 255], times [T] f32)."""
    import scipy.ndimage as ndi

    rng = np.random.RandomState(seed)
    shift = 2.0  # px/frame at full resolution
    # the texture is sized for N_FRAMES, as bench.py sizes it, so a shorter
    # run sees the same first frames
    shape = (H_IN + 64, W_IN + 64 + int(shift * max(n_frames, N_FRAMES)) + 8)
    smooth = ndi.gaussian_filter(rng.uniform(0, 255, shape), 2.0)
    blobs = (ndi.gaussian_filter(rng.uniform(0, 1, shape), 6.0) > 0.5) * 150.0
    big = 0.4 * smooth + blobs + 30.0
    big = (big - big.min()) / (np.ptp(big) + 1e-9) * 255.0
    big = big.astype(np.float32)
    frames = np.stack(
        [big[32: 32 + H_IN,
             32 + int(round(shift * i)): 32 + int(round(shift * i)) + W_IN]
         for i in range(n_frames)])
    times = np.arange(n_frames, dtype=np.float32) / 20.0  # 20 fps camera
    return frames, times
