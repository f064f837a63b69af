"""Compiled rollouts: one CUDA graph of a step, replayed once a frame.

The port's counterpart of ``jax.jit`` + ``jax.lax.scan``, with which the
JAX package compiles every rollout into one device program
(``ekf_vio_tpu/engine.py:409-426``).

``scan(body, carry, xs)`` runs ``body(carry, x) -> (carry, y)`` over the
leading axis of every tensor of ``xs`` (pytrees of tensors throughout)
and returns (final carry, the ys stacked on a new leading axis), as
``jax.lax.scan`` does.

* On CPU tensors it is the plain loop (``loop``).
* On CUDA tensors it runs the first iteration eagerly, which warms up the
  CUDA context, the cuBLAS and cuSOLVER handles, the nvcc-built kernels
  (``cuda_lib.load``) and any NCCL communicator, and gives that frame's
  output.  It copies the carry into static buffers and captures one
  iteration with ``torch.cuda.graph``: the iteration reads its frame of
  ``xs`` at a device-side counter (``index_select``), copies the new
  carry back into the static carry, writes its outputs into
  preallocated [T, ...] buffers at the counter and advances the counter.
  Then it replays the graph once per remaining frame, with no other host
  work.  A capture runs under the default error mode, so any call that
  synchronises, reads back or copies host data raises: nothing falls back
  to the eager loop.  Each call captures anew (no cache to invalidate, no
  memory held between calls); the carry and ys it returns are buffers of
  its own, written by the replays and aliased by nothing.

A replay runs no host code, so the kernels count their own launches on
the card (``csrc/launch_count.cuh``) and, with the recorder of
``utils/profiling.py`` on, the captured step stamps its ``vio.*`` spans
and counts into the recorder's ring on the card (``csrc/stamp.cu``), once
a replay.  ``last`` holds the host seconds of the last capture and the
number of replays.

``graphed(fn)`` is the counterpart of ``jax.jit`` for a function called
once a frame from a host loop (the CLI's streaming step, the batched
filter step): on CUDA tensors its first call for each shape runs eagerly
and captures ``fn`` on static copies of the arguments, a Python float
(the batched step's ``dt``) as a 0-d tensor, as ``jax.jit`` traces it;
later calls copy their arguments in, replay and return a copy of the
outputs.  With the recorder on, a call records the host spans
``graphed.call`` (children ``graphed.copy_in``, ``graphed.launch``: the
replay, ``graphed.copy_out``: the clones) and ``graphed.capture`` on a
miss, and ``scan`` records ``scan.capture``; whether the recorder is on
is part of a graph's key, so turning it on captures a stamped graph once
and the plain one replays unchanged with it off.
"""
from __future__ import annotations

import time

import torch
from torch import Tensor
from torch.utils import _pytree

from ekf_vio_tpu_torch.utils import profiling

# the host seconds of the last capture, and the replays that followed it
last = {"capture_s": 0.0, "replays": 0}


def _on_card(tree) -> bool:
    leaves = [x for x in _pytree.tree_leaves(tree) if isinstance(x, Tensor)]
    return bool(leaves) and leaves[0].is_cuda


def _capture(fn):
    """A CUDA graph of ``fn()`` on the capture stream; its host seconds
    go to ``last``."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    last["capture_s"] = time.perf_counter() - t0
    return graph


def _capture_recorded(fn, rec, name: str):
    """``_capture(fn)`` in the host span ``name`` of the recorder ``rec``
    (None: off), and the recorder's frames the graph holds."""
    if rec is None:
        return _capture(fn), 0
    before = rec.captured
    with rec.span(name):
        graph = _capture(fn)
    return graph, rec.captured - before


def _at(xs, i):
    """Frame ``i`` of ``xs``: ``i`` an int, or a [1] device tensor read by
    ``index_select`` (a 0-d index would read it back to the host)."""
    if xs is None:
        return None
    if isinstance(i, int):
        return _pytree.tree_map(lambda a: a[i], xs)
    return _pytree.tree_map(lambda a: a.index_select(0, i)[0], xs)


def _length(xs, length):
    return length if xs is None else _pytree.tree_leaves(xs)[0].shape[0]


def loop(body, carry, xs, length: int | None = None):
    """``scan`` as a plain Python loop over the frames, on any device."""
    ys = []
    for i in range(_length(xs, length)):
        carry, y = body(carry, _at(xs, i))
        ys.append(y)
    return carry, _pytree.tree_map(lambda *y: torch.stack(y), *ys)


def scan(body, carry, xs, length: int | None = None):
    """``jax.lax.scan(body, carry, xs)``: a captured CUDA graph of one
    iteration, replayed once a frame, for CUDA tensors; ``loop`` for CPU
    tensors.  ``xs`` may be None with ``length`` iterations given."""
    if not _on_card((carry, xs)):
        return loop(body, carry, xs, length)
    return _scan_graphed(body, carry, xs, length)


def _check_like(static: list, new: list, what: str) -> None:
    for s, n in zip(static, new):
        if s.shape != n.shape or s.dtype != n.dtype:
            raise ValueError(f"{what} changed from {s.dtype}{list(s.shape)} "
                             f"to {n.dtype}{list(n.shape)} in an iteration")


def _scan_graphed(body, carry, xs, length):
    n = _length(xs, length)
    carry, y0 = body(carry, _at(xs, 0))  # eager: warm-up and frame 0
    if n == 1:
        return carry, _pytree.tree_map(lambda y: y[None].clone(), y0)
    c_leaves, c_spec = _pytree.tree_flatten(carry)
    static = [c.clone() for c in c_leaves]
    y_leaves, y_spec = _pytree.tree_flatten(y0)
    ys = [y.new_empty((n,) + y.shape) for y in y_leaves]
    for buf, y in zip(ys, y_leaves):
        buf[0].copy_(y)
    dev = static[0].device
    idx = torch.ones(1, dtype=torch.long, device=dev)  # the frame counter

    def iteration():
        new, y = body(_pytree.tree_unflatten(list(static), c_spec),
                      _at(xs, idx))
        new_leaves = _pytree.tree_flatten(new)[0]
        new_y = _pytree.tree_flatten(y)[0]
        _check_like(static, new_leaves, "the carry")
        _check_like([b[0] for b in ys], new_y, "an output")
        for s, v in zip(static, new_leaves):
            if v is not s:  # a leaf the body passed through is in place
                s.copy_(v)
        for buf, v in zip(ys, new_y):
            buf.index_copy_(0, idx, v[None])
        idx.add_(1)

    rec = profiling.active()
    graph, frames = _capture_recorded(iteration, rec, "scan.capture")
    for _ in range(n - 1):
        graph.replay()
    if rec is not None:
        rec.replayed(frames * (n - 1))
    last["replays"] = n - 1
    return (_pytree.tree_unflatten(static, c_spec),
            _pytree.tree_unflatten(ys, y_spec))


def _signature(x):
    """What selects a graph of ``graphed``: a tensor's shape, dtype and
    device, the type of a Python float (its value is an input of the
    graph), any other argument's value (an int or a bool may pick a shape
    or a branch, as a static argument of ``jax.jit`` does)."""
    if isinstance(x, Tensor):
        return (x.shape, x.dtype, x.device)
    return float if type(x) is float else x


def graphed(fn):
    """``jax.jit(fn)`` for a step called from a host loop: on CUDA tensors
    the first call for each signature of the arguments (``_signature``)
    runs ``fn`` eagerly, returns that result and captures ``fn`` on
    static copies of the arguments, each Python float as a 0-d float64
    tensor on the card; every later such call copies its tensors into
    them, fills the floats in, replays and returns a copy of the outputs.
    On CPU tensors ``fn`` itself."""
    cache = {}

    def miss(key, args, leaves, spec, rec):
        # a stamped graph of a recorder that is off now never replays
        # again: drop it, with the private pool and the ring it holds
        for k in [k for k in cache if k[-1] not in (None, rec)]:
            del cache[k]
        out = fn(*args)  # eager: warm-up and this call's result
        dev = next(x.device for x in leaves if isinstance(x, Tensor))
        static_in = [
            x.clone() if isinstance(x, Tensor)
            else torch.full((), x, dtype=torch.float64, device=dev)
            if type(x) is float else x for x in leaves]
        held = {}

        def once():
            held["out"] = fn(*_pytree.tree_unflatten(static_in, spec))

        graph, frames = _capture_recorded(once, rec, "graphed.capture")
        cache[key] = (graph, static_in, held, frames)
        return out

    def copy_in(static_in, leaves):
        for s, x in zip(static_in, leaves):
            if isinstance(x, Tensor):
                s.copy_(x)
            elif type(x) is float:
                s.fill_(x)

    def recorded(rec, key, args, leaves, spec):
        with rec.span("graphed.call"):
            entry = cache.get(key)
            if entry is None:
                return miss(key, args, leaves, spec, rec)
            graph, static_in, held, frames = entry
            with rec.span("graphed.copy_in"):
                copy_in(static_in, leaves)
            with rec.span("graphed.launch"):
                graph.replay()
                rec.replayed(frames)
            with rec.span("graphed.copy_out"):
                return _pytree.tree_map(torch.clone, held["out"])

    def call(*args):
        if not _on_card(args):
            return fn(*args)
        rec = profiling.active()
        leaves, spec = _pytree.tree_flatten(args)
        # the recorder (None: off) keys its own stamped graph, which holds
        # pointers into its ring, and keeps it alive until the next miss
        # under another recorder
        key = (str(spec), tuple(map(_signature, leaves)), rec)
        if rec is not None:
            return recorded(rec, key, args, leaves, spec)
        entry = cache.get(key)
        if entry is None:
            return miss(key, args, leaves, spec, None)
        graph, static_in, held, _ = entry
        copy_in(static_in, leaves)
        graph.replay()
        return _pytree.tree_map(torch.clone, held["out"])

    return call
