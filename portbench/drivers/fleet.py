"""``fleet``: bulk re-processing of recorded sequences, many at once.

``parallel.batched_engine.run_sequences_batched`` over ``lanes`` sequences
of ``frames`` frames each (every lane its own seeded sequence, made on
the card), called again and again on the same lanes: the vision-only
batched engine, one captured step for all lanes, replayed once a frame.
Set-up warms the batched step on the first frames of the same lanes.
The comparison is ``offline``'s, on every lane.
"""
from __future__ import annotations

from portbench import offline
from portbench.reference import compare
from portbench.reference import vio as ref
from portbench.traffic.generate import make_session


def run(h, dev):
    from ekf_vio_tpu_torch.parallel import batched_engine

    cfg, cam = h.vio_config(), h.camera()
    if cfg.use_imu:
        raise ValueError("the batched engine is vision-only")
    tf = h.traffic
    lanes, frames = int(tf["lanes"]), int(tf["frames"])
    data = make_session(h.config, tf, h.seed, frames, dev, lanes=lanes)
    images, times = data["frames"], data["times"]
    del data

    def call(t=frames):
        return batched_engine.run_sequences_batched(
            images[:, :t], times[:, :t], cfg, cam, device=dev)

    res, (state, outs) = offline.run_calls(
        h, dev, call, lambda: call(4), lanes * frames,
        lambda: call(int(tf["profile_frames"])))
    h.phase("window closed")

    rcfg, rcam = ref.make_cfg(h.config["vio"]), h.ref_camera()
    modes = (False, True) if getattr(h, "control", False) else (False,)
    gaps, cgaps = [], []

    def follow(states, lane, f0, f1):
        """The reference (and the control) from ``states`` over frames
        [f0, f1) of ``lane``, each frame held against the drawn call's
        outputs (output j is frame j + 1).  Returns the states and the
        last outputs."""
        r_out = {}
        for f in range(f0, f1):
            for tf32 in modes:
                with ref.precision(tf32):
                    states[tf32], r_out[tf32] = ref.step(
                        states[tf32], images[lane, f], times[lane, f], rcfg, rcam)
            gaps.append(compare.output_gaps(offline.out_at(outs, lane, f - 1),
                                            r_out[False]))
            if True in r_out:
                cgaps.append(compare.output_gaps(r_out[True], r_out[False]))
        return states, r_out

    # the start: every lane from the reference's own initialization
    k = int(tf["compare_frames"])
    for lane in range(lanes):
        states = {}
        for tf32 in modes:
            with ref.precision(tf32):
                states[tf32] = ref.initialize(images[lane, 0], times[lane, 0],
                                              rcfg, rcam)
        follow(states, lane, 1, k + 1)
    h.phase("start compared")

    # across the call and at its end: the program's state handed over by
    # a prefix call of the same entry
    m = int(tf["follow_frames"])
    for t0 in offline.handovers(h, k + 1, frames, m):
        p_state, p_outs = call(t0)
        h.phase(f"prefix call of {t0} frames")
        for lane in range(lanes):
            gaps.append(compare.output_gaps(offline.out_at(p_outs, lane, t0 - 2),
                                            offline.out_at(outs, lane, t0 - 2)))
            states = {tf32: ref.from_program(offline.lane_of(p_state, lane))
                      for tf32 in modes}
            states, r_out = follow(states, lane, t0, t0 + m)
            if t0 + m == frames:
                end = ref.from_program(offline.lane_of(state, lane))
                last = offline.out_at(outs, lane, frames - 2)
                gaps.append(compare.state_gaps(end, last, states[False],
                                               r_out[False]))
                if True in states:
                    cgaps.append(compare.state_gaps(states[True], r_out[True],
                                                    states[False], r_out[False]))
        del p_state, p_outs
        h.phase(f"followed from frame {t0}")
    h.hold(gaps, cgaps, frames=len(gaps))
    return res
