"""Batched multi-sequence VIO: B sequences as one batched step per frame.

Port of ``ekf_vio_tpu/parallel/batched_engine.py`` without a mesh
(BASELINE.json config 4, "all EuRoC MH/V sequences data-parallel").  The
JAX package vmaps its scanned rollout; here ``torch.func.vmap`` maps the
port's own ``engine.initialize`` and ``engine.step`` over the lanes, one
frame at a time, so every tensor op of a step runs once for all lanes.
The kernels are custom operators whose vmap rules fold the lanes into one
launch: a batched step launches ``lk_level`` and ``fast9`` once (plus
``klt_level`` once on the 'pallas_klt' rule), as one lane does.

``MICROBATCH`` comes from ``chip_smoke.py``'s microbatch phase on an
H100 (``PERF.md``): at B = 128 and 256 lanes one batch took 0.53 and
0.51 times as long as two chunks of half the lanes, since a batched step
is bound by the host issuing its ~1300 kernels and barely grows with the
lanes.  It is the largest B measured; batches above it that it divides
run as chunks of that size, one after another.  ``run_sequences_sharded``
needs a device mesh and comes with the distributed layer.
"""
from __future__ import annotations

import torch

from ekf_vio_tpu_torch import engine
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
    outs = []
    for i in range(1, images.shape[1]):
        estate, out = step(estate, images[:, i], times[:, i])
        outs.append(out)
    return estate, engine.StepOutputs(
        *(torch.stack(field, 1) for field in zip(*outs)))


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
