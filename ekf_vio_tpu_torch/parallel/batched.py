"""A batch of filters stepped together, on one device or on a mesh.

Port of ``ekf_vio_tpu/parallel/batched.py`` (BASELINE.json configs 4 and
5): ``init_batched_state`` and ``make_batched_filter_step`` over a
leading batch axis, mapped with ``torch.func.vmap``.  With a mesh the
lanes split over ``data`` and each lane's Σ over ``state`` in the JAX
layout (``mesh.filter_state_shardings``: Σ[b, :, columns]), so a rank
stores only its [B/nd, D, D/ns] block; the JAX module leaves the
collectives to GSPMD, here one all-gather of Σ's columns runs the
mesh-less step.
``scaling_efficiency_probe`` times the mesh step.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch import scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as ekf
from ekf_vio_tpu_torch.engine import resolve_device, use_cusolver
from ekf_vio_tpu_torch.parallel import mesh as mesh_mod


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
    use_cusolver(dev)
    if uv is None:
        uv = torch.rand(batch, cfg.max_features, 2,
                        generator=generator) * 2.0 - 1.0
    uv = torch.as_tensor(uv, dtype=torch.float32).to(dev)
    base = ekf.init_state(cfg, device=dev)
    ones = torch.ones(cfg.max_features, dtype=torch.bool, device=dev)
    return torch.func.vmap(
        lambda u: ekf.add_features(base, cfg, u, ones))(uv)


def make_batched_filter_step(cfg: VIOConfig, mesh: DeviceMesh | None = None):
    """(batched FilterState, z [B, N, 2], dt) -> FilterState: one predict
    and one masked update (R = 1e-5 I, every active slot measured) per
    filter of the batch, the compute core of the per-frame pipeline.

    With a mesh the step takes and returns this rank's blocks
    (``mesh.local_blocks`` of the state along
    ``mesh.filter_state_shardings(mesh)``, and of z along ``data``): a
    rank stores its [B/nd, D, D/ns] block of Σ.  The step all-gathers Σ's
    columns over ``state``, runs the mesh-less step on the rank's lanes
    and keeps its own columns, so every option of ``cfg`` is honoured
    exactly as without a mesh.  During the step a rank holds its lanes'
    whole Σ, so its peak memory is O(B/nd · D²), and every rank of a
    ``state`` group does the same O(B/nd · D³) work: the mesh splits the
    lanes' compute over ``data`` only.  Needs (22 + 3N) divisible by the
    ``state`` size (``mesh.aligned_capacity``).

    On the card the step is ``scan.graphed`` (``jax.jit``): its first call
    for each shape captures it, all-gather included on a NCCL mesh, and
    later calls replay that graph, ``dt`` an input of it; on a gloo mesh
    it runs eagerly.  Its factorizations must go to cuSOLVER
    (``engine.use_cusolver``, which ``init_batched_state`` sets)."""
    def one_step(state, z, dt):
        state = ekf.predict(state, cfg, dt)
        eye = torch.eye(2, dtype=state.Sigma.dtype, device=state.device)
        meas_cov = (eye * 1e-5).expand(cfg.max_features, 2, 2)
        return ekf.update_with_feature_positions(state, cfg, z, meas_cov,
                                                 state.active)

    vstep = torch.func.vmap(one_step, in_dims=(0, 0, None))
    if mesh is None:
        return scan.graphed(vstep)

    def mesh_step(state, z, dt):
        g, k, ns = mesh_mod.axis(mesh, "state")
        out = vstep(state.replace(
            Sigma=mesh_mod.all_gather(state.Sigma, g, dim=2)), z, dt)
        dc = out.Sigma.shape[2] // ns
        return out.replace(
            Sigma=out.Sigma[:, :, k * dc:(k + 1) * dc].contiguous())

    return scan.graphed(mesh_step) if mesh_mod.capturable(mesh) \
        else mesh_step


def scaling_efficiency_probe(cfg: VIOConfig, mesh: DeviceMesh, batch: int,
                             steps: int = 10) -> float:
    """Seconds per mesh step of a batch of ``batch`` filters (every slot
    active at positions drawn from seed 0, z = the features' own
    positions, dt = 0.05), this rank's share on its device, after one
    warm-up step; on the card timed between ``torch.cuda.synchronize``
    calls."""
    import time

    dev = mesh_mod.mesh_device(mesh)
    state = init_batched_state(cfg, batch,
                               generator=torch.Generator().manual_seed(0),
                               device=dev)
    specs = mesh_mod.filter_state_shardings(mesh, True)
    state = mesh_mod.local_blocks(state, specs, mesh)
    z = state.feat_mu[:, :, :2].contiguous()
    step = make_batched_filter_step(cfg, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    state = step(state, z, 0.05)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step(state, z, 0.05)
    sync()
    return (time.perf_counter() - t0) / steps
