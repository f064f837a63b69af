"""The lane axis shared by the three kernel wrappers and their plain
versions.

A kernel takes B independent sequences as a leading lane axis in one
launch.  ``fold_lanes`` / ``unfold_lanes`` are the ``register_vmap`` rule
of each custom operator (``lk_cuda``, ``klt_cuda``, ``fast_cuda``): the
axis ``torch.func.vmap`` maps becomes the lane axis of one call.
``call_with_lanes`` gives one-lane inputs a lane axis of 1 for the
pyramid ops, and ``per_lane`` is how the plain versions take lanes: one
lane after another (they are never on the card's path).
"""
from __future__ import annotations

import torch
from torch import Tensor


def fold_lanes(info, in_dims, *args):
    """A ``register_vmap`` rule's inputs with the vmapped axis folded into
    the leading lane axis: every tensor (also inside a list) has its
    vmapped axis moved to the front, or is repeated B times where it has
    none, and is then merged with the lane axis behind it, contiguous as
    the kernels take it.  Returns the folded arguments; non-tensors pass
    through."""
    b = info.batch_size

    def fold(x, d):
        if not isinstance(x, Tensor):
            return x
        x = x.movedim(d, 0) if d is not None else x.expand(b, *x.shape)
        return x.reshape(b * x.shape[1], *x.shape[2:]).contiguous()

    return [[fold(x, d) for x, d in zip(a, dims)] if isinstance(a, list)
            else fold(a, dims) for a, dims in zip(args, in_dims)]


def unfold_lanes(info, outs):
    """The op's lane-shaped outputs split back into (vmapped, lane) axes,
    with the out_dims a ``register_vmap`` rule returns."""
    b = info.batch_size
    return (tuple(o.reshape(b, o.shape[0] // b, *o.shape[1:]) for o in outs),
            (0,) * len(outs))


def call_with_lanes(op, prev_pyr, cur_pyr, prev_pts, init_pts, valid, *rest):
    """A pyramid ``op`` on lane-shaped inputs: one-lane inputs ([N, 2]
    points, as under ``torch.func.vmap``) get a lane axis of 1 and lose
    it again."""
    if prev_pts.dim() == 3:
        return op(list(prev_pyr), list(cur_pyr), prev_pts, init_pts, valid,
                  *rest)
    outs = op([x[None] for x in prev_pyr], [x[None] for x in cur_pyr],
              prev_pts[None], init_pts[None], valid[None], *rest)
    return tuple(o[0] for o in outs)


def per_lane(fn, *args, **kw):
    """``fn`` on each lane of lane-shaped arguments (tensors [B, ...] and
    lists of them), outputs stacked on a new lane axis."""
    def lane(a, b):
        if isinstance(a, (list, tuple)):
            return [x[b] for x in a]
        return a[b] if isinstance(a, Tensor) else a

    lanes = next(a for a in args if isinstance(a, Tensor)).shape[0]
    outs = [fn(*(lane(a, b) for a in args), **kw) for b in range(lanes)]
    if isinstance(outs[0], Tensor):
        return torch.stack(outs)
    return tuple(torch.stack(o) for o in zip(*outs))
