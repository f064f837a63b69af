"""``replay_sqrt``: ``replay``'s offline evaluation of one recorded
sequence, with the filter in square-root form.

``engine.run_sequence_imu`` with ``square_root_form`` (the state carries
the lower Cholesky factor L across frames; each predict, update, slot add
and depth re-prime is a QR triangularization) over one ``frames``-frame
sequence made on the card from the seed, the closed-form VI
initialization inside each call, called again and again; set-up warms
the same entry on the sequence's first frames.  The window, the start,
the hand-overs and the follow are ``replay``'s (``offline.py``); the plain
reference is ``reference/vio_sqrt.py``, which carries L as the program
does, and every state is compared as Σ = L Lᵀ (``vio_sqrt.squared``) on
both sides: L is not unique where a pre-array loses rank.  The outputs
are in covariance terms on both sides and compared as ``replay``'s.
"""
from __future__ import annotations

from portbench import offline
from portbench.reference import compare
from portbench.reference import vio_sqrt as ref
from portbench.traffic.generate import make_session


def run(h, dev):
    from ekf_vio_tpu_torch import engine

    cfg, cam = h.vio_config(), h.camera()
    if not (cfg.use_imu and cfg.square_root_form):
        raise ValueError("the replay_sqrt driver runs the mono-inertial "
                         "entry in square-root form")
    tf = h.traffic
    frames, k0 = int(tf["frames"]), cfg.vi_init_frames
    d = make_session(h.config, tf, h.seed, frames, dev)
    seq = (d["frames"], d["times"], d["imu_dt"], d["imu_gyro"], d["imu_accel"])
    gravity = d["gravity_w"]
    del d

    def call(t=frames):
        return engine.run_sequence_imu(
            seq[0][:t], seq[1][:t], seq[2][:t - 1], seq[3][:t - 1],
            seq[4][:t - 1], gravity, cfg, cam, init_frames=k0, device=dev)

    res, (state, outs) = offline.run_calls(
        h, dev, call, lambda: call(k0 + 4), frames,
        lambda: call(int(tf["profile_frames"])))
    h.phase("window closed")

    rcfg, rcam = ref.make_cfg(h.config["vio"]), h.ref_camera()
    modes = (False, True) if getattr(h, "control", False) else (False,)
    gaps, cgaps = [], []

    def follow(states, f0, f1):
        """The reference (and the control) from ``states`` over frames
        [f0, f1), each frame held against the drawn call's outputs
        (output j is frame k0 + j).  Returns the states and the last
        outputs."""
        r_out = {}
        for f in range(f0, f1):
            for tf32 in modes:
                with ref.precision(tf32):
                    states[tf32], r_out[tf32] = ref.step(
                        states[tf32], seq[0][f], seq[1][f], rcfg, rcam,
                        imu=(seq[2][f - 1], seq[3][f - 1], seq[4][f - 1]),
                        gravity_w=gravity)
            gaps.append(compare.output_gaps(offline.out_at(outs, f - k0),
                                            r_out[False]))
            if True in r_out:
                cgaps.append(compare.output_gaps(r_out[True], r_out[False]))
        return states, r_out

    # the start: the reference's own VI initialization and first steps
    states = {}
    for tf32 in modes:
        with ref.precision(tf32):
            states[tf32] = ref.initialize_imu(
                seq[0][:k0], seq[1][:k0], seq[2][:k0 - 1], seq[3][:k0 - 1],
                seq[4][:k0 - 1], gravity, rcfg, rcam, k0)
    k = int(tf["compare_frames"])
    follow(states, k0, k0 + k)
    h.phase("start compared")

    # across the call and at its end: the program's state (its factor)
    # handed over by a prefix call of the same entry
    m = int(tf["follow_frames"])
    for t0 in offline.handovers(h, k0 + k, frames, m):
        p_state, p_outs = call(t0)
        h.phase(f"prefix call of {t0} frames")
        gaps.append(compare.output_gaps(offline.out_at(p_outs, t0 - 1 - k0),
                                        offline.out_at(outs, t0 - 1 - k0)))
        states = {tf32: ref.from_program(p_state) for tf32 in modes}
        del p_state, p_outs
        states, r_out = follow(states, t0, t0 + m)
        if t0 + m == frames:
            gaps.append(compare.state_gaps(
                ref.squared(ref.from_program(state)),
                offline.out_at(outs, frames - 1 - k0),
                ref.squared(states[False]), r_out[False]))
            if True in states:
                cgaps.append(compare.state_gaps(
                    ref.squared(states[True]), r_out[True],
                    ref.squared(states[False]), r_out[False]))
        h.phase(f"followed from frame {t0}")
    h.hold(gaps, cgaps, frames=len(gaps))
    return res
