"""A batch of filters stepped together, without a device mesh.

Port of ``ekf_vio_tpu/parallel/batched.py``: ``init_batched_state`` and
``make_batched_filter_step`` over a leading batch axis, mapped with
``torch.func.vmap``.  The JAX module also constrains Σ to a
data x state mesh (``make_batched_filter_step(cfg, mesh)``) and times
that (``scaling_efficiency_probe``); both need the distributed layer and
come with it.
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.engine import resolve_device


def init_batched_state(cfg: VIOConfig, batch: int,
                       generator: torch.Generator | None = None,
                       uv: torch.Tensor | None = None, device="cuda"):
    """A batch of freshly initialized filters with every slot active at
    random positions (the large-state benchmark setup).

    uv: [batch, max_features, 2] metric positions; when None they are
    drawn uniformly from [-1, 1) with ``generator`` (a CPU
    ``torch.Generator``; the JAX version draws them with ``jax.random``,
    so the two agree only on explicit ``uv``).  Returns a FilterState
    whose every tensor has a leading batch axis, on ``device``."""
    dev = resolve_device(device)
    if uv is None:
        uv = torch.rand(batch, cfg.max_features, 2,
                        generator=generator) * 2.0 - 1.0
    uv = torch.as_tensor(uv, dtype=torch.float32).to(dev)
    base = ekf.init_state(cfg, device=dev)
    ones = torch.ones(cfg.max_features, dtype=torch.bool, device=dev)
    return torch.func.vmap(
        lambda u: ekf.add_features(base, cfg, u, ones))(uv)


def make_batched_filter_step(cfg: VIOConfig):
    """(batched FilterState, z [B, N, 2], dt) -> FilterState: one predict
    and one masked update (R = 1e-5 I, every active slot measured) per
    filter of the batch, the compute core of the per-frame pipeline."""
    def one_step(state, z, dt):
        state = ekf.predict(state, cfg, dt)
        eye = torch.eye(2, dtype=state.Sigma.dtype, device=state.device)
        meas_cov = (eye * 1e-5).expand(cfg.max_features, 2, 2)
        return ekf.update_with_feature_positions(state, cfg, z, meas_cov,
                                                 state.active)

    return torch.func.vmap(one_step, in_dims=(0, 0, None))
