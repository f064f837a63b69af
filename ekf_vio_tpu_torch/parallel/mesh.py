"""The ('data', 'state') device mesh on ``torch.distributed``, and the
collectives the distributed layer runs on it.

Port of ``ekf_vio_tpu/parallel/mesh.py``.  One rank drives one device
(a card, or a CPU process with gloo), so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks:

* ``data``  — independent sequences (data parallelism; the EuRoC
  multi-sequence configuration, BASELINE.json config 4);
* ``state`` — the block partition of the filter covariance for large-N
  filters (BASELINE.json config 5).

JAX states a layout as ``NamedSharding`` and lets GSPMD place the
collectives; here a rank holds only its own block of each tensor and the
collectives are written out (``all_gather``, ``all_to_all_blocks``,
``all_true``).  ``filter_state_shardings`` describes the JAX layout
(which axis of which field splits over which mesh dim), and
``local_blocks`` / ``gather_blocks`` cut a tree into a rank's blocks and
put it back together along that description.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ekf_vio_tpu_torch.core.state import FilterState
from ekf_vio_tpu_torch.engine import resolve_device

AXES = ("data", "state")

# the single-tensor all-gather: torch 2.13 renamed it (the old name still
# works there, with a deprecation warning)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def make_mesh(n_data: int, n_state: int, device="cuda") -> DeviceMesh:
    """An (n_data, n_state) mesh over the first n_data·n_state ranks of
    the process group, rank r at (r // n_state, r % n_state).  The mesh
    runs on the card unless the caller passes ``device="cpu"`` (gloo);
    ranks past n_data·n_state are in no mesh position."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize_distributed first")
    need = n_data * n_state
    have = dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    return DeviceMesh(dev.type, torch.arange(need).reshape(n_data, n_state),
                      mesh_dim_names=AXES)


def aligned_capacity(n_features: int, n_state: int) -> int:
    """Smallest slot capacity >= n_features with state dim (22+3N)
    divisible by the ``state`` axis size (Σ blocks must tile evenly)."""
    n = n_features
    while (22 + 3 * n) % n_state != 0:
        n += 1
    return n


def axis(mesh: DeviceMesh, name: str):
    """(process group, this rank's index, size) of one mesh dim."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(AXES.index(name)))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def capturable(mesh: DeviceMesh) -> bool:
    """Whether a CUDA graph can hold the mesh's collectives: NCCL runs
    them on the card's streams; gloo runs them on host threads, which no
    graph captures."""
    return all(dist.get_backend(mesh.get_group(name)) == "nccl"
               for name in AXES)


# --------------------------------------------------------------------------
# Collectives (contiguous buffers; bool travels as uint8)
# --------------------------------------------------------------------------


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in rank order (JAX's
    tiled ``all_gather``); a gather along another dim than 0 moves it to
    the front around a dim-0 gather."""
    n = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    _all_gather_single(out, src, group=group)
    out = out.movedim(0, dim)
    return out.bool() if is_bool else out


def all_to_all_blocks(x: torch.Tensor, group) -> torch.Tensor:
    """[r, c] -> [n·r, c/n]: column block j of every rank's rows goes to
    rank j (JAX's ``all_to_all(split_axis=1, concat_axis=0, tiled=True)``).
    On row blocks of a matrix M this gives every rank M[:, its columns]."""
    n = dist.get_world_size(group)
    r, c = x.shape
    src = x.reshape(r, n, c // n).transpose(0, 1).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.reshape(n * r, c // n)


def all_true(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool scalar that is True on every rank of ``group`` iff ``flag``
    is True on every rank (no host read)."""
    v = flag.to(torch.int32).reshape(1)
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=group)
    return v[0].bool()


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on every
    rank of the mesh: a broadcast along ``data`` from data index 0, then
    along ``state`` from state index 0."""
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(tree)
    out = []
    for x in leaves:
        is_bool = x.dtype == torch.bool
        buf = (x.to(torch.uint8) if is_bool else x).clone().contiguous()
        for name in AXES:
            g = mesh.get_group(name)
            dist.broadcast(buf, src=dist.get_global_rank(g, 0), group=g)
        out.append(buf.bool() if is_bool else buf)
    return _pytree.tree_unflatten(out, spec)


# --------------------------------------------------------------------------
# The JAX layout of a FilterState, and blocks along it
# --------------------------------------------------------------------------


def filter_state_shardings(mesh: DeviceMesh | None = None,
                           batched: bool = True) -> FilterState:
    """The layout of a (batched) FilterState, as the JAX module's
    ``NamedSharding``s state it: for each field, the mesh dim each tensor
    axis splits over (None: whole on every rank).  Σ splits its columns
    over ``state``; the batch axis splits over ``data``; means, masks
    and times are whole along ``state``.  ``mesh`` is not read (the JAX
    signature's)."""
    b = ("data",) if batched else ()
    return FilterState(
        base_mu=b + (None,), feat_mu=b + (None, None), active=b + (None,),
        klt_ref=b + (None, None), Sigma=b + (None, "state"), t=b,
        age=b + (None,))


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def local_blocks(tree, specs, mesh: DeviceMesh):
    """This rank's block of every tensor of ``tree`` along ``specs`` (a
    tree of the same structure whose leaves are ``filter_state_shardings``
    tuples)."""
    from torch.utils import _pytree

    leaves, tdef = _pytree.tree_flatten(tree)
    spec_leaves = _pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
    out = []
    for x, spec in zip(leaves, spec_leaves):
        for d, name in enumerate(spec):
            if name is not None:
                _, k, n = axis(mesh, name)
                size = x.shape[d] // n
                if size * n != x.shape[d]:
                    raise ValueError(f"axis {d} of {tuple(x.shape)} does "
                                     f"not split over {n} '{name}' ranks")
                x = x.narrow(d, k * size, size)
        out.append(x.contiguous())
    return _pytree.tree_unflatten(out, tdef)


def gather_blocks(tree, specs, mesh: DeviceMesh):
    """The inverse of ``local_blocks``: every rank's blocks gathered, so
    every rank of the mesh holds the whole tree."""
    from torch.utils import _pytree

    leaves, tdef = _pytree.tree_flatten(tree)
    spec_leaves = _pytree.tree_flatten(specs, is_leaf=_is_spec)[0]
    out = []
    for x, spec in zip(leaves, spec_leaves):
        for d, name in enumerate(spec):
            if name is not None:
                x = all_gather(x, mesh.get_group(name), dim=d)
        out.append(x)
    return _pytree.tree_unflatten(out, tdef)
