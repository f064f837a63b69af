"""Quaternion / rotation utilities on tensors, batched over leading dims.

Port of ``ekf_vio_tpu/core/lie.py``: Hamilton products, rotations and the
axis-angle exponential of the motion model (TightlyCoupledEKF.cpp:340-362),
written branch-free so ``torch.func.jacfwd`` differentiates them exactly.
Quaternions are stored [w, x, y, z].
"""
from __future__ import annotations

import torch


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v in the two-cross-product form v + 2w(u×v) + 2u×(u×v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_exp_omega(omega: torch.Tensor, dt) -> torch.Tensor:
    """Incremental rotation dq = [cos(θ/2), ω̂ sin(θ/2)], θ = dt‖ω‖
    (TightlyCoupledEKF.cpp:349-355), with a series branch below θ² = 1e-8
    so the θ→0 limit and its derivatives stay finite."""
    t2 = torch.sum(omega * omega, dim=-1, keepdim=True) * (dt * dt)
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(safe_t2)
    w = torch.where(small, 1.0 - t2 / 8.0 + t2 * t2 / 384.0,
                    torch.cos(theta / 2.0))
    k = torch.where(small, 0.5 - t2 / 48.0 + t2 * t2 / 3840.0,
                    torch.sin(theta / 2.0) / theta)
    return torch.cat([w, omega * dt * k], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix of a unit quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix [v]×."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], -1),
            torch.stack([z, o, -x], -1),
            torch.stack([-y, x, o], -1),
        ],
        dim=-2,
    )
