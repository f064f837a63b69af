"""Checkpoint / resume of the filter state.

Port of ``ekf_vio_tpu/io/checkpoint.py``.  ``save`` / ``load`` keep the
``FilterState`` fields with ``torch.save``; they take the place of both
the JAX package's npz files and its orbax checkpoints (orbax has no
counterpart here).  ``load_npz`` reads a file the JAX package's
``save_npz`` wrote (the leaves in ``FilterState`` field order, plus
``__treedef__``), so a JAX run resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ekf_vio_tpu_torch.core.state import FilterState
from ekf_vio_tpu_torch.engine import resolve_device
from ekf_vio_tpu_torch.interop import FILTER_FIELDS, filter_state_from_numpy


def save(path: str, state: FilterState) -> None:
    """The state's fields, moved to the CPU, in one ``torch.save`` file."""
    torch.save({k: getattr(state, k).detach().cpu() for k in FILTER_FIELDS},
               path)


def load(path: str, device="cuda") -> FilterState:
    """A state ``save`` wrote, on ``device`` (the card unless the caller
    passes ``device="cpu"``; an error without a card)."""
    dev = resolve_device(device)
    d = torch.load(path, map_location="cpu", weights_only=True)
    return FilterState(**{k: d[k].to(dev) for k in FILTER_FIELDS})


def load_npz(path: str, device="cuda") -> FilterState:
    """A state the JAX package's ``checkpoint.save_npz`` wrote, on
    ``device`` (as for ``load``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    if len(leaves) != len(FILTER_FIELDS):
        raise ValueError(f"{path}: {len(leaves)} leaves, a FilterState has "
                         f"{len(FILTER_FIELDS)}")
    return filter_state_from_numpy(dict(zip(FILTER_FIELDS, leaves)), dev)
