"""What the offline drivers (``fleet``, ``replay``) share: whole calls of
one entry point, again and again, over the same sequences.

``offline_fps`` is the lane-frames the calls completed over the time from
the first call's start to the end of the last call begun within the
window; a call's initialization, eager first step and capture are inside
it, as a user re-processing recordings pays them.

Correctness, after the window, for one call of the window drawn from the
seed (its outputs at every frame and the state it returned):

* the start: its first ``compare_frames`` filtered frames of every lane
  against the plain reference run from its own initialization on the
  same frames (the initialization and the first steps);
* across the call and at its end: at a frame drawn from the seed and at
  ``frames - follow_frames``, the same entry called again on the frames
  before it (a prefix of the same sequences, every lane) hands over the
  program's state there; the prefix call's last outputs are held against
  the drawn call's at that frame, and the reference follows
  ``follow_frames`` frames from that state, each held against the drawn
  call's outputs; at the end the reference's state is held against the
  state the drawn call returned.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from portbench import trace as tr

CALL_SALT = 11
HANDOVER_SALT = 13


def finite_poses(base_mu) -> tuple:
    """(lane-frames, lane-frames whose pose is not finite) of [..., 22]."""
    import torch

    ok = torch.isfinite(base_mu[..., :7]).all(-1)
    return ok.numel(), int((~ok).sum())


def run_calls(h, dev, call, warm, lane_frames: int, profile_call) -> tuple:
    """Set-up (``warm``), then calls of ``call`` (returning (state,
    outputs) of one call) until the window closes.  Returns (result dict,
    (state, outputs) of the call drawn from the seed for the comparison:
    a reservoir of one, so only it is kept)."""
    from ekf_vio_tpu_torch import scan

    h.phase("sequences made")
    warm()
    h.setup_done(dev)
    rng = np.random.default_rng([h.seed & ((1 << 64) - 1), CALL_SALT])
    drawn, captures, seconds = None, [], []
    attempted = failed = 0
    t_start = time.perf_counter()
    deadline = t_start + h.seconds
    t_end = t_start
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        got = call()
        n, bad = finite_poses(got[1].base_mu)   # reads back: the call is done
        t_end = time.perf_counter()
        seconds.append(t_end - t0)
        captures.append(scan.last["capture_s"])
        attempted, failed = attempted + n, failed + bad
        if rng.random() * len(seconds) < 1.0:
            drawn = got
        del got
    calls = len(seconds)
    print("calls: " + ", ".join(f"{s:.4f}" for s in seconds) + " s; captures "
          + ", ".join(f"{c * 1e3:.1f}" for c in captures) + " ms", file=sys.stderr)
    res = {"attempted": attempted, "failed": failed,
           "device": h.device_info(dev),
           "metrics": {"offline_fps": calls * lane_frames / (t_end - t_start)}}
    if h.trace:
        import torch

        prof = tr.profiler(dev)
        with prof:
            with torch.profiler.record_function(tr.CALL):
                profile_call()
                h.sync(dev)
        summary = tr.reduce_slice(prof)
        if dev.type == "cuda":  # a capture happens on the card only
            summary["capture_ms"] = statistics.fmean(captures) * 1e3
        res["trace"] = summary
    return res, drawn


def handovers(h, first: int, frames: int, follow: int) -> list:
    """The frames at which the reference takes over the program's state:
    one drawn from the seed in [first, frames - 2 * follow] (when that
    holds one) and ``frames - follow``, so the last followed frame is the
    call's last."""
    end = frames - follow
    out = []
    if end - follow >= first:
        rng = np.random.default_rng([h.seed & ((1 << 64) - 1), HANDOVER_SALT])
        out.append(int(rng.integers(first, end - follow + 1)))
    return out + [end]


def lane_of(tree, b: int):
    """Lane ``b`` of a state with a leading lane axis on every tensor."""
    from torch.utils import _pytree

    return _pytree.tree_map(lambda x: x[b], tree)


def out_at(outs, *idx) -> dict:
    """One frame's outputs as a dict of tensors."""
    return {k: v[idx] for k, v in outs._asdict().items()}
