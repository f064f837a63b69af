"""The benchmark's frame and IMU generator: EuRoC-shaped sessions, made on
the device from a seed.

A textured plane seen along a smooth 6-DoF trajectory that starts at rest,
rendered by inverse warping with bilinear sampling, and the IMU stream of
that trajectory with white noise at the sensor's densities and constant
biases.  It follows the model of the port's ``sim/rendered.generate`` but is
written anew in PyTorch, vectorised over frames, and imports nothing of the
port: every tensor of a session is made on ``device`` in a few large calls.

One seed gives one session: its texture, the frequencies of its motion and
its IMU noise.  Every seed gives the same sizes (frames, samples a frame,
image size), so the work of a run does not depend on the seed beyond what
the scene shows.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from the run's seed and a salt
    (large seeds are welcome: the hash takes any integer)."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), *salt])
    return int(rng.integers(0, 2 ** 63 - 1))


def _gauss_taps(sigma: float, device) -> torch.Tensor:
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [S, S] with reflected borders, as sums of
    shifted copies: elementwise, so the same seed gives the same bits
    whatever convolution algorithm or TF32 setting the process holds."""
    taps = _gauss_taps(sigma, "cpu").tolist()
    r = (len(taps) - 1) // 2
    h, w = img.shape
    p = F.pad(img[None, None], (0, 0, r, r), mode="reflect")[0, 0]
    img = sum(p[i:i + h] * taps[i] for i in range(len(taps)))
    p = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")[0, 0]
    return sum(p[:, i:i + w] * taps[i] for i in range(len(taps)))


def make_texture(size: int, seed: int, device) -> torch.Tensor:
    """[size, size] f32 texture in [0, 255]: smooth noise plus blobs."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 1))
    u = torch.rand((2, size, size), generator=g, device=device)
    smooth = _blur(255.0 * u[0], 2.0)
    blobs = (_blur(u[1], 8.0) > 0.5).to(torch.float32)
    tex = 0.45 * smooth + 140.0 * blobs + 25.0
    lo, hi = tex.min(), tex.max()
    return 255.0 * (tex - lo) / (hi - lo)


class Trajectory:
    """p(t) = a (1 - cos(w t)), yaw(t) = ya (1 - cos(yw t)), pitch(t) =
    pa (1 - cos(pw t)); R = R_y(yaw) R_x(pitch) (world <- camera).  All
    derivatives are analytic, so the IMU stream is exact up to its noise.
    Everything at t = 0 is at rest: the closed-form VI initialization needs
    a start whose velocity it can observe."""

    def __init__(self, p: dict, seed: int):
        rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 2])
        jit = 1.0 + p["freq_jitter"] * rng.uniform(-1.0, 1.0, 5)
        self.amp = np.asarray(p["amp_m"], dtype=np.float64)
        self.w = 2.0 * math.pi * np.asarray(p["freq_hz"]) * jit[:3]
        self.ya, self.yw = p["yaw_amp_rad"], 2.0 * math.pi * p["yaw_freq_hz"] * jit[3]
        self.pa, self.pw = p["pitch_amp_rad"], 2.0 * math.pi * p["pitch_freq_hz"] * jit[4]

    def pos(self, t):
        a = torch.as_tensor(self.amp, dtype=t.dtype, device=t.device)
        w = torch.as_tensor(self.w, dtype=t.dtype, device=t.device)
        return a * (1.0 - torch.cos(w * t[..., None]))

    def acc(self, t):
        a = torch.as_tensor(self.amp, dtype=t.dtype, device=t.device)
        w = torch.as_tensor(self.w, dtype=t.dtype, device=t.device)
        return a * w * w * torch.cos(w * t[..., None])

    def angles(self, t):
        yaw = self.ya * (1.0 - torch.cos(self.yw * t))
        pitch = self.pa * (1.0 - torch.cos(self.pw * t))
        dyaw = self.ya * self.yw * torch.sin(self.yw * t)
        dpitch = self.pa * self.pw * torch.sin(self.pw * t)
        return yaw, pitch, dyaw, dpitch

    def R(self, t):
        yaw, pitch, _, _ = self.angles(t)
        cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
        z, o = torch.zeros_like(cy), torch.ones_like(cy)
        ry = torch.stack([torch.stack([cy, z, sy], -1), torch.stack([z, o, z], -1),
                          torch.stack([-sy, z, cy], -1)], -2)
        rx = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, cp, -sp], -1),
                          torch.stack([z, sp, cp], -1)], -2)
        return ry @ rx

    def omega_body(self, t):
        """R^T dR/dt = [w]x with w = dpitch e_x + dyaw R_x(pitch)^T e_y."""
        _, pitch, dyaw, dpitch = self.angles(t)
        return torch.stack([dpitch, dyaw * torch.cos(pitch),
                            -dyaw * torch.sin(pitch)], -1)


def _render(tex, K, Rs, ps, plane_depth, tex_scale, h, w):
    """[F, h, w] images of the plane z = plane_depth (world) seen by
    cameras (Rs [F, 3, 3] world <- camera, ps [F, 3]), bilinear texture
    lookups clamped at the texture's border."""
    dev = tex.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays = torch.stack([(xs.reshape(-1) - K[0][2]) / K[0][0],
                        (ys.reshape(-1) - K[1][2]) / K[1][1],
                        torch.ones(h * w, device=dev)], 0)           # [3, HW]
    d = Rs.to(torch.float32) @ rays                                  # [F, 3, HW]
    p = ps.to(torch.float32)[:, :, None]
    lam = (plane_depth - p[:, 2:3]) / d[:, 2:3]
    pts = p + lam * d
    th, tw = tex.shape
    tx = pts[:, 0] * tex_scale + tw / 2.0
    ty = pts[:, 1] * tex_scale + th / 2.0
    x0 = torch.clamp(torch.floor(tx), 0, tw - 2)
    y0 = torch.clamp(torch.floor(ty), 0, th - 2)
    fx = torch.clamp(tx - x0, 0.0, 1.0)
    fy = torch.clamp(ty - y0, 0.0, 1.0)
    flat = tex.reshape(-1)
    i = y0.long() * tw + x0.long()
    v = (flat[i] * (1 - fx) * (1 - fy) + flat[i + 1] * fx * (1 - fy)
         + flat[i + tw] * (1 - fx) * fy + flat[i + tw + 1] * fx * fy)
    return v.reshape(-1, h, w)


def make_session(cfg: dict, traffic: dict, seed: int, frames: int,
                 device, lanes: int = 0) -> dict:
    """One session (``lanes`` = 0) or a stack of ``lanes`` sessions, each
    with its own seed, of ``frames`` frames on ``device``:

    frames [T, H, W] f32, times [T] (seconds, 1/fps apart), imu_dt
    [T-1, S], imu_gyro / imu_accel [T-1, S, 3] (S = imu_rate / fps samples
    at the interval's sample midpoints), gravity_w [3] and gt_pos [T, 3];
    with ``lanes`` every tensor but gravity_w gains a leading lane axis.
    The camera (``cfg["camera"]``) and the IMU (``cfg["imu"]``) come from
    the configuration, the scene and the motion from the traffic."""
    if lanes:
        one = [make_session(cfg, traffic, sub_seed(seed, 9, i), frames,
                            device) for i in range(lanes)]
        out = {k: torch.stack([s[k] for s in one]) for k in one[0]
               if k != "gravity_w"}
        out["gravity_w"] = one[0]["gravity_w"]
        return out
    cam, imu, scene = cfg["camera"], cfg["imu"], traffic["scene"]
    fps, rate = float(cam["fps"]), float(imu["rate_hz"])
    spf = int(round(rate / fps))
    if abs(spf * fps - rate) > 1e-6:
        raise ValueError("the IMU rate must be a whole multiple of the frame rate")
    h, w = int(cam["height"]), int(cam["width"])
    K = [[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]]
    traj = Trajectory(scene, seed)
    tex = make_texture(int(scene["texture_px"]), seed, device)

    f64 = dict(dtype=torch.float64, device=device)
    times = torch.arange(frames, **f64) / fps
    Rs, ps = traj.R(times), traj.pos(times)
    chunk = int(traffic.get("render_chunk", 64))
    images = torch.cat([
        _render(tex, K, Rs[i:i + chunk], ps[i:i + chunk], scene["plane_depth_m"],
                scene["texture_px_per_m"], h, w)
        for i in range(0, frames, chunk)])

    # samples tile each camera interval: sample s of interval i is taken at
    # the midpoint of [t_i + s/rate, t_i + (s+1)/rate]
    d = 1.0 / rate
    tm = times[:-1, None] + (torch.arange(spf, **f64) + 0.5) * d         # [T-1, S]
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 3))
    noise = torch.randn((2, frames - 1, spf, 3), generator=g, device=device,
                        dtype=torch.float32).to(torch.float64)
    g_w = torch.tensor([0.0, 9.81, 0.0], **f64)
    R = traj.R(tm)
    bg = torch.tensor(imu["gyro_bias"], **f64)
    ba = torch.tensor(imu["accel_bias"], **f64)
    scale = math.sqrt(rate)  # white noise density x sqrt(1 / dt)
    gyro = traj.omega_body(tm) + bg + imu["gyro_noise_density"] * scale * noise[0]
    spec = torch.einsum("tsji,tsj->tsi", R, traj.acc(tm) + g_w)
    accel = spec + ba + imu["accel_noise_density"] * scale * noise[1]
    f32 = torch.float32
    return {"frames": images.contiguous(),
            "times": times.to(f32),
            "imu_dt": torch.full((frames - 1, spf), d, dtype=f32, device=device),
            "imu_gyro": gyro.to(f32).contiguous(),
            "imu_accel": accel.to(f32).contiguous(),
            "gravity_w": (-g_w).to(f32),
            "gt_pos": ps.to(f32)}
