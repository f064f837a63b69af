"""Carry engine state and camera intrinsics between the two packages.

The JAX package's ``EngineState`` (and the ``FilterState`` inside it) is
exchanged as a plain dict of numpy arrays, so this module needs neither
JAX nor ``ekf_vio_tpu``:

    base_mu, feat_mu, active, klt_ref, Sigma, t, age   (the FilterState)
    prev_pyr (list of [H, W] levels), frame_idx, lin_base

On the JAX side the dict is built with ``np.asarray`` of each field, e.g.
``{**{k: np.asarray(getattr(es.filt, k)) for k in FILTER_FIELDS},
"prev_pyr": [np.asarray(l) for l in es.prev_pyr], ...}``.
"""
from __future__ import annotations

import numpy as np
import torch

from ekf_vio_tpu_torch.core.state import FilterState
from ekf_vio_tpu_torch.engine import EngineState
from ekf_vio_tpu_torch.frontend.camera import Camera

FILTER_FIELDS = ("base_mu", "feat_mu", "active", "klt_ref", "Sigma", "t",
                 "age")
_DTYPES = {"active": torch.bool, "age": torch.int32}


def filter_state_from_numpy(d: dict, device) -> FilterState:
    """FilterState on ``device`` from a dict of numpy arrays."""
    return FilterState(**{
        k: torch.tensor(np.asarray(d[k]),
                        dtype=_DTYPES.get(k, torch.float32), device=device)
        for k in FILTER_FIELDS})


def filter_state_to_numpy(filt: FilterState) -> dict:
    return {k: getattr(filt, k).detach().cpu().numpy() for k in FILTER_FIELDS}


def engine_state_from_numpy(d: dict, device) -> EngineState:
    """EngineState on ``device`` from a dict of numpy arrays (the filter
    fields at top level, plus prev_pyr, frame_idx and lin_base)."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return EngineState(
        filt=filter_state_from_numpy(d, device),
        prev_pyr=tuple(f32(level) for level in d["prev_pyr"]),
        frame_idx=torch.tensor(np.asarray(d["frame_idx"], np.int32),
                               device=device),
        lin_base=f32(d["lin_base"]),
    )


def engine_state_to_numpy(es: EngineState) -> dict:
    out = filter_state_to_numpy(es.filt)
    out["prev_pyr"] = [level.detach().cpu().numpy() for level in es.prev_pyr]
    out["frame_idx"] = es.frame_idx.detach().cpu().numpy()
    out["lin_base"] = es.lin_base.detach().cpu().numpy()
    return out


def camera_from_K(K, width: int, height: int) -> Camera:
    """The port's Camera from a 3x3 intrinsics matrix."""
    return Camera.from_K(K, width, height)


def camera_to_K(cam: Camera) -> np.ndarray:
    return np.asarray(cam.K(), np.float32)
