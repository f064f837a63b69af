"""Checkpoint / resume of the filter state.

Port of ``ekf_vio_tpu/io/checkpoint.py``.  ``save_npz`` / ``load_npz``
write and read the JAX package's npz layout (the leaves ``leaf_0`` ..
``leaf_6`` in ``FilterState`` field order, plus ``__treedef__``), so a
state moves between the two packages in either direction; the CLI's
``--checkpoint`` writes it.  ``save`` / ``load`` keep the fields with
``torch.save``, the port's own pair; they stand in for the JAX package's
orbax checkpoints, which have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from ekf_vio_tpu_torch.core.state import FilterState
from ekf_vio_tpu_torch.engine import resolve_device
from ekf_vio_tpu_torch.interop import FILTER_FIELDS, filter_state_from_numpy

# what the JAX package's save_npz stores as __treedef__: str() of the
# FilterState's tree structure (its load_npz reads only the leaves)
_TREEDEF = "PyTreeDef(CustomNode(FilterState[()], [*, *, *, *, *, *, *]))"


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


def save_npz(path: str, state: FilterState) -> None:
    """The state in the JAX package's npz layout, which its ``load_npz``
    reads (numpy appends ``.npz`` to a path without it, as there)."""
    np.savez(
        path,
        __treedef__=np.frombuffer(_TREEDEF.encode(), dtype=np.uint8),
        **{f"leaf_{i}": getattr(state, k).detach().cpu().numpy()
           for i, k in enumerate(FILTER_FIELDS)})


def load_npz(path: str, device="cuda") -> FilterState:
    """A state ``save_npz`` or the JAX package's ``save_npz`` wrote, on
    ``device`` (as for ``load``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    if len(leaves) != len(FILTER_FIELDS):
        raise ValueError(f"{path}: {len(leaves)} leaves, a FilterState has "
                         f"{len(FILTER_FIELDS)}")
    return filter_state_from_numpy(dict(zip(FILTER_FIELDS, leaves)), dev)
