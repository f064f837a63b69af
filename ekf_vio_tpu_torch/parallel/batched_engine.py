"""Batched multi-sequence VIO: B sequences as one batched step per frame.

Port of ``ekf_vio_tpu/parallel/batched_engine.py`` without a mesh
(BASELINE.json config 4, "all EuRoC MH/V sequences data-parallel").  The
JAX package vmaps its scanned rollout; here ``torch.func.vmap`` maps the
port's own ``engine.initialize`` and ``engine.step`` over the lanes and
``scan.scan`` runs the vmapped step over the frames (on the card one
captured CUDA graph of it, replayed once a frame; each chunk of a
microbatched call captures its own), so every tensor op of a step runs
once for all lanes.
The kernels are custom operators whose vmap rules fold the lanes into one
launch: a batched step launches ``lk_level`` and ``fast9`` once (plus
``klt_level`` once on the 'pallas_klt' rule), as one lane does.

``MICROBATCH`` comes from ``chip_smoke.py``'s microbatch phase on an
H100 (``PERF.md``): at B = 128 and 256 lanes one batch took 0.53 and
0.51 times as long as two chunks of half the lanes, since a batched step
is bound by the host issuing its ~1300 kernels and barely grows with the
lanes.  It is the largest B measured; batches above it that it divides
run as chunks of that size, one after another.  ``run_sequences_sharded``
splits the lanes over a mesh's ``data`` groups: each runs
``run_sequences_batched`` on its share with no collective until one
all-gather at the end.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch import engine, scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend.camera import Camera

# chunk size for batches above it (chip_smoke.py's microbatch phase,
# PERF.md)
MICROBATCH = 256


def _concat(trees):
    """Concatenate equal pytrees of tensors on their batch axis."""
    from torch.utils import _pytree

    leaves = [_pytree.tree_flatten(t) for t in trees]
    spec = leaves[0][1]
    return _pytree.tree_unflatten(
        [torch.cat(xs, 0) for xs in zip(*(lv for lv, _ in leaves))], spec)


def _run_microbatch(images, times, cfg: VIOConfig, cam: Camera, dev):
    init = torch.func.vmap(
        lambda im, t: engine.initialize(im, t, cfg, cam, device=dev))
    step = torch.func.vmap(lambda es, im, t: engine.step(es, im, t, cfg, cam))
    estate = init(images[:, 0], times[:, 0])
    # frames lead in the scan: xs [T-1, B, ...], ys back to [B, T-1, ...]
    estate, outs = scan.scan(lambda es, x: step(es, *x), estate,
                             (images[:, 1:].transpose(0, 1),
                              times[:, 1:].T))
    return estate, engine.StepOutputs(*(y.transpose(0, 1) for y in outs))


def run_sequences_batched(images, times, cfg: VIOConfig, cam: Camera,
                          microbatch: int = MICROBATCH, device="cuda"):
    """Vision-only rollouts of B sequences on ``device``.

    images: [B, T, H, W]; times: [B, T].  Returns (final EngineState with
    a leading batch axis on every tensor, StepOutputs [B, T-1, ...]).
    Batches larger than ``microbatch`` and divisible by it run as chunks
    of ``microbatch`` lanes, one after another without a host sync;
    the results are concatenated on the batch axis."""
    dev = engine.resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32).to(dev)
    times = torch.as_tensor(times, dtype=torch.float32).to(dev)
    b = images.shape[0]
    if b <= microbatch or b % microbatch:
        return _run_microbatch(images, times, cfg, cam, dev)
    outs = [_run_microbatch(images[i:i + microbatch],
                            times[i:i + microbatch], cfg, cam, dev)
            for i in range(0, b, microbatch)]
    return _concat(outs)


def run_sequences_sharded(images, times, cfg: VIOConfig, cam: Camera,
                          mesh: DeviceMesh, microbatch: int = MICROBATCH):
    """``run_sequences_batched`` with the lanes split over the mesh's
    ``data`` axis: data group i runs lanes [i·B/nd, (i+1)·B/nd) (its
    ``host_local_batch`` share; the ranks of a ``state`` group run the
    same lanes), with no collective in the steady state, then one
    all-gather along ``data`` returns the whole batch, the shape the
    mesh-less call returns, to every rank.  On the mesh's device."""
    from torch.utils import _pytree

    from ekf_vio_tpu_torch.parallel import mesh as mesh_mod
    from ekf_vio_tpu_torch.parallel.multihost import host_local_batch

    g, i, nd = mesh_mod.axis(mesh, "data")
    share = host_local_batch(images.shape[0], nd)
    lo = i * share
    out = run_sequences_batched(images[lo:lo + share], times[lo:lo + share],
                                cfg, cam, microbatch=microbatch,
                                device=mesh_mod.mesh_device(mesh))
    leaves, spec = _pytree.tree_flatten(out)
    return _pytree.tree_unflatten(
        [mesh_mod.all_gather(x, g, dim=0) for x in leaves], spec)
