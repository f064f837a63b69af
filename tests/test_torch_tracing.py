"""The recorder of ``ekf_vio_tpu_torch/utils/profiling.py``: spans and
counts of ``engine.step`` that also survive CUDA-graph replay.

On the CPU (the stamps' CPU kernel writes the host clock):

* the span tree of an eager step: parents, frame ids, the same tree from
  host spans and from device stamps; self time = duration minus the part
  covered by children;
* with the recorder off nothing is recorded, and ``engine.step`` (vision,
  IMU, the vmapped batched step) and ``scan.graphed`` (on a stand-in
  graph, as in ``test_torch_graph.py``) give bitwise the same outputs and
  state with it on and off;
* the counts equal ``num_tracked``, the lost flag and the slots the step
  filled, computed from the step's own outputs; the gated count is what
  the χ² gate removed; ``skipped`` counts an update in square-root form
  that a failed factorization left as predicted;
* in square-root form each QR triangularization is a ``vio.tria.<role>``
  span inside its layer's, in step order, eager and replayed; with the
  recorder off the step runs the same ops as with those spans taken out;
* ``flush`` after the ring wrapped keeps the last frames and reports the
  overwritten ones;
* in one ``torch.profiler`` profile, a program span and a
  ``record_function`` opened at the same points agree to within 50 µs
  (one clock), and ``trace`` merges the program's events into its file.

On the card (``requires_cuda``, skipped here; the file imports no JAX, so
it runs with ``--noconftest``): a stamped ``scan.scan`` rollout, a stamped
``scan.graphed`` call and a vmapped batched rollout bitwise equal to
unstamped ones, the stamp launches counted on the card; device stamps
within 10 µs of the profiler's device ops of their layer, once the
profiler's own drifting conversion is fitted out; the stamps' offset to the
host clock steady over a second; the recorder-off graph holds the nodes it held
before the recorder (a fixed count) and no stamp node, and the stamped
graph one more node per ring write and the counts' own ops; the
square-root-form graph of the 128-slot test step holds as many nodes with
the recorder off as with its ``vio.tria.*`` spans taken out, and its
stamped replay the ``vio.tria.*`` stamps in step order; that step's
``scan.graphed`` replays bitwise equal to the eager step, the state it hands
on square lower-triangular.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree

from ekf_vio_tpu_torch import engine, scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import imu, sqrt_filter
from ekf_vio_tpu_torch.frontend import camera
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.parallel import batched_engine
from ekf_vio_tpu_torch.sim import frames as sim_frames
from ekf_vio_tpu_torch.sim import rendered
from ekf_vio_tpu_torch.utils import profiling

W, H = 160, 120
CAM = Camera.from_K([[458.0 / 4, 0.0, W / 2], [0.0, 458.0 / 4, H / 2],
                     [0.0, 0.0, 1.0]], W, H)
BENCH = VIOConfig(max_features=32, min_new_feature_dist=8.0,
                  fast_threshold=30)
MONO = VIOConfig.from_yaml(
    Path(__file__).resolve().parent.parent / "configs" / "mono_inertial.yaml"
).replace(max_features=32)
SQRT = MONO.replace(square_root_form=True)
LAYERS = ("vio.pyramid", "vio.track", "vio.update", "vio.replenish")
# a factor-form IMU step's spans in step order (each vio.tria.* inside the
# layer span before it)
SQRT_SPANS = ("vio.step", "vio.imu", "vio.pyramid", "vio.track",
              "vio.depth_boot", "vio.update", "vio.tria.update",
              "vio.replenish", "vio.tria.close")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread, as the suite's other port files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with no recorder on."""
    profiling.disable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def bench():
    """Bench frames 0-5 at 160x120 and their times."""
    frames, times = sim_frames.make_frames(seed=0, n_frames=6)
    small = camera.downscale_image(torch.from_numpy(frames), 4).contiguous()
    return small, torch.from_numpy(times)


@pytest.fixture(scope="module")
def seq():
    """A rendered 160x120 mono-inertial sequence of 6 frames."""
    s = rendered.generate(num_frames=6, w=W, h=H)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(s, k)))
            for k in ("frames", "times", "imu_dt", "imu_gyro", "imu_accel",
                      "gravity_w")}


def _vision_steps(bench, cfg=BENCH, n=3, device="cpu"):
    """initialize, then ``n`` eager steps: (states, outputs)."""
    small, times = (x.to(device) for x in bench)
    es = engine.initialize(small[0], times[0], cfg, CAM, device=device)
    states, outs = [es], []
    for i in range(1, n + 1):
        es, out = engine.step(es, small[i], times[i], cfg, CAM)
        states.append(es)
        outs.append(out)
    return states, outs


def _imu_steps(seq, n=2, cfg=MONO):
    es = engine.initialize(seq["frames"][0], seq["times"][0], cfg, CAM,
                           device="cpu")
    states, outs = [es], []
    for i in range(1, n + 1):
        batch = imu.ImuSample(seq["imu_dt"][i - 1], seq["imu_gyro"][i - 1],
                              seq["imu_accel"][i - 1])
        es, out = engine.step(es, seq["frames"][i], seq["times"][i], cfg,
                              CAM, imu_batch=batch,
                              gravity_w=seq["gravity_w"])
        states.append(es)
        outs.append(out)
    return states, outs


def _batched_steps(bench):
    small, times = bench
    lanes = torch.stack([small[:3], small[1:4]])
    init = torch.func.vmap(lambda im, t: engine.initialize(
        im, t, BENCH, CAM, device="cpu"))
    step = torch.func.vmap(lambda e, im, t: engine.step(e, im, t, BENCH, CAM))
    es = init(lanes[:, 0], times[0].expand(2))
    states, outs = [es], []
    for i in (1, 2):
        es, out = step(es, lanes[:, i], times[i].expand(2))
        states.append(es)
        outs.append(out)
    return states, outs


def _assert_bitwise(a, b):
    la, lb = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and \
            torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def _tree(spans):
    """(name, parent's name, frame) of every span."""
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None,
             s.frame) for s in spans]


# --------------------------------------------------------------------------
# The span tree
# --------------------------------------------------------------------------


def test_an_eager_step_records_its_span_tree(bench):
    with profiling.recording() as rec:
        _vision_steps(bench, n=2)
        tr = rec.flush()
    assert rec.frames == 3 and int(rec.counter[0]) == 3 and tr.dropped == 0
    for spans in (tr.host, tr.device):
        tree = _tree(spans)
        assert tree[0] == ("vio.init", None, 1)
        for f in (2, 3):
            frame = [t for t in tree if t[2] == f]
            assert frame[0] == ("vio.step", None, f)
            names = [t[0] for t in frame[1:]]
            assert names == ["vio.predict", *LAYERS]
            assert all(t[1] == "vio.step" for t in frame[1:])
        for s in spans:
            assert s.end_ns >= s.start_ns
            if s.parent >= 0:
                p = spans[s.parent]
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    # the CPU stamps are host-clock readings made inside the host spans
    for h, d in zip(sorted(tr.host, key=lambda s: s.start_ns),
                    sorted(tr.device, key=lambda s: s.start_ns)):
        assert h.name == d.name
        assert h.start_ns <= d.start_ns <= d.end_ns <= h.end_ns


@pytest.mark.parametrize("case", ("nested", "overlapping", "clipped"))
def test_self_time_is_duration_minus_what_children_cover(case):
    Span = profiling.Span
    kids = {"nested": [(10, 20), (30, 45)],
            "overlapping": [(10, 30), (25, 40)],
            "clipped": [(0, 15), (90, 130)]}[case]
    spans = [Span("p", 5, 100)] + [Span(f"c{i}", a, b, 0, 1)
                                   for i, (a, b) in enumerate(kids)]
    spans.append(Span("g", 11, 14, 1, 1))  # a grandchild, inside c0
    covered = {"nested": 10 + 15, "overlapping": 30,
               "clipped": 10 + 10}[case]
    got = profiling.self_ns(spans)
    assert got[0] == 95 - covered
    assert got[1] == kids[0][1] - kids[0][0] - 3
    assert got[-1] == 3


def test_a_step_records_its_frames_imu_layers(seq):
    with profiling.recording() as rec:
        _imu_steps(seq, n=1)
        tr = rec.flush()
    names = [s.name for s in tr.device if s.frame == 2]
    assert names == ["vio.step", "vio.imu", *LAYERS[:2], "vio.depth_boot",
                     *LAYERS[2:]]


# --------------------------------------------------------------------------
# Off records nothing; on and off give the same bits
# --------------------------------------------------------------------------


def test_off_records_nothing(bench):
    rec = profiling.enable()
    profiling.disable()
    _vision_steps(bench, n=1)
    assert profiling.active() is None
    assert rec.host == [] and rec.frames == 0
    assert int(rec.counter[0]) == 0 and not rec.ring.any()


def test_off_counts_compute_nothing(bench):
    """The counts' mask arithmetic runs inside the recorder: a step with
    both gates on runs no xor with the recorder off, and one a mask
    counted (gated, added) with it on."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    cfg = BENCH.replace(innovation_gate_chi2=50.0, min_eigen_rel_gate=20.0)
    with Ops() as off:
        _vision_steps(bench, cfg=cfg, n=1)
    with profiling.recording(), Ops() as on:
        _vision_steps(bench, cfg=cfg, n=1)
    assert off.seen["bitwise_xor"] == 0
    assert on.seen["bitwise_xor"] == 2


@pytest.mark.parametrize("path", ("vision", "imu", "batched", "sqrt_imu"))
def test_steps_are_bitwise_equal_with_the_recorder_on_and_off(path, bench,
                                                              seq):
    run = {"vision": lambda: _vision_steps(bench, n=3),
           "imu": lambda: _imu_steps(seq, n=2),
           "batched": lambda: _batched_steps(bench),
           "sqrt_imu": lambda: _imu_steps(seq, n=2, cfg=SQRT)}[path]
    off = run()
    with profiling.recording() as rec:
        on = run()
        tr = rec.flush()
    assert tr.device and rec.frames == len(on[0])  # one frame a call
    _assert_bitwise(on, off)


class StandInGraph:
    """``torch.cuda.CUDAGraph``'s stand-in of ``test_torch_graph.py``: a
    capture records ``fn`` and runs nothing; ``replay()`` runs it."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    graphs = []

    def capture(fn):
        graphs.append(StandInGraph(fn))
        return graphs[-1]

    monkeypatch.setattr(scan, "_on_card", lambda tree: True)
    monkeypatch.setattr(scan, "_capture", capture)
    return graphs


def test_graphed_is_bitwise_equal_with_the_recorder_on_and_off(bench,
                                                               stand_in):
    """``scan.graphed`` keys a stamped graph of its own: off, on, off
    again captures two graphs, the plain one replayed after the stamped
    one; the outputs of every call are bitwise equal; the recorder's
    host spans are ``graphed.call`` with copy-in, launch and copy-out."""
    small, times = bench
    step = scan.graphed(lambda es, img, t: engine.step(es, img, t, BENCH,
                                                       CAM))

    def run(first, last):
        es = engine.initialize(small[0], times[0], BENCH, CAM, device="cpu")
        got = []
        for i in range(first, last):
            es, out = step(es, small[i], times[i])
            got.append((es, out))
        return got

    off = run(1, 5)
    with profiling.recording() as rec:
        on = run(1, 5)
        tr = rec.flush()
    again = run(1, 5)
    _assert_bitwise(on, off)
    _assert_bitwise(again, off)
    assert len(stand_in) == 2 and stand_in[0].replays == 3 + 4
    assert stand_in[1].replays == 3
    calls = [i for i, s in enumerate(tr.host) if s.name == "graphed.call"]
    assert len(calls) == 4
    first = [s.name for s in tr.host if s.parent == calls[0]]
    assert first == ["vio.step", "graphed.capture"]
    for c in calls[1:]:
        kids = [s for s in tr.host if s.parent == c]
        assert [s.name for s in kids] == ["graphed.copy_in", "graphed.launch",
                                          "graphed.copy_out"]
        # the call, its children and the replayed step share the frame id
        assert {s.frame for s in kids} == {tr.host[c].frame}
        assert tr.host[c].frame in {s.frame for s in tr.device
                                    if s.name == "vio.step"}


def test_graphed_drops_the_graphs_of_a_recorder_that_is_off(bench,
                                                           stand_in):
    """A stamped graph holds its recorder's ring: once another recorder
    captures, the graphs of the one before are dropped and it is freed."""
    import gc
    import weakref

    small, times = bench
    step = scan.graphed(lambda es, img, t: engine.step(es, img, t, BENCH,
                                                       CAM))
    es = engine.initialize(small[0], times[0], BENCH, CAM, device="cpu")
    with profiling.recording() as rec:
        step(es, small[1], times[1])
    first = weakref.ref(rec)
    del rec
    gc.collect()
    assert first() is not None   # still cached: no miss since
    with profiling.recording():
        step(es, small[1], times[1])
        gc.collect()
        assert first() is None
    step(es, small[1], times[1])  # off: the plain graph, captured now
    assert len(stand_in) == 3


# --------------------------------------------------------------------------
# Counts
# --------------------------------------------------------------------------


def _counts(tr, frame):
    return {c.name: c.value for c in tr.counts if c.frame == frame}


@pytest.mark.parametrize("path", ("vision", "imu", "batched", "sqrt_imu"))
def test_counts_equal_what_the_outputs_say(path, bench, seq):
    run = {"vision": lambda: _vision_steps(bench, n=3),
           "imu": lambda: _imu_steps(seq, n=2),
           "batched": lambda: _batched_steps(bench),
           "sqrt_imu": lambda: _imu_steps(seq, n=2, cfg=SQRT)}[path]
    with profiling.recording() as rec:
        states, outs = run()
        tr = rec.flush()
    for k, (es, out) in enumerate(zip(states[1:], outs)):
        got = _counts(tr, k + 2)
        # a factor-form update also counts whether it was skipped: never
        # on these frames
        sq = path.startswith("sqrt")
        assert set(got) == {"tracked", "lost", "added"} | (
            {"skipped"} if sq else set())
        assert got.get("skipped", 0) == 0
        # summed over the lanes of a batched step
        assert got["tracked"] == int(out.num_tracked.sum())
        assert got["lost"] == int(out.tracking_lost.sum())
        filled = es.filt.active & (es.filt.age == 0)
        assert got["added"] == int(filled.sum())


def test_gated_counts_what_the_gates_removed(bench):
    """With a χ² gate that keeps every track and one that keeps none:
    nothing gated, then every track KLT kept (the first's tracked)."""
    tracked = {}
    for name, chi2 in (("open", 1e30), ("shut", 1e-30)):
        with profiling.recording() as rec:
            _, outs = _vision_steps(bench, BENCH.replace(
                innovation_gate_chi2=chi2), n=1)
            tracked[name] = _counts(rec.flush(), 2)
        assert tracked[name]["tracked"] == int(outs[0].num_tracked)
    assert tracked["open"]["gated"] == 0 and tracked["open"]["tracked"] > 0
    assert tracked["shut"]["tracked"] == 0
    assert tracked["shut"]["gated"] == tracked["open"]["tracked"]


@pytest.mark.parametrize("planted", (False, True))
def test_skipped_counts_a_failed_factorization(planted, seq):
    """A factor-form update whose measurement covariance cannot be
    factored (a NaN planted in one measured feature's R) leaves the state
    as predicted and counts one ``skipped``; a clean one counts none."""
    es = _imu_steps(seq, n=1, cfg=SQRT)[0][-1]
    f = es.filt
    uv = f.feat_mu[:, :2] + 1e-3
    cov = torch.eye(2).expand(f.n_max, 2, 2) * 1e-5
    if planted:
        cov = cov.clone()
        cov[int(torch.nonzero(f.active)[0, 0])] = torch.nan
    with profiling.recording() as rec:
        with profiling.frame("f"):
            got = sqrt_filter.update_sqrt_factor(f, SQRT, uv, cov, f.active)
        tr = rec.flush()
    assert [(c.name, c.value) for c in tr.counts] == [("skipped", int(planted))]
    assert torch.equal(got.Sigma, f.Sigma) == planted


def _tria_tree(spans, frame):
    """(name, parent's name) of a frame's spans, in the order they began."""
    got = sorted((s for s in spans if s.frame == frame),
                 key=lambda s: s.start_ns)
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in got]


# each vio.tria.* span's layer in a factor-form IMU step: the step
# carries a non-square factor from the IMU propagation on, and runs two
# QRs, the update array and the close that makes the factor square
TRIA_PARENTS = [("vio.tria.update", "vio.update"),
                ("vio.tria.close", "vio.replenish")]


@pytest.mark.parametrize("run", ("eager", "graphed"))
def test_a_factor_step_stamps_its_triangularizations(run, seq, stand_in):
    """In square-root form every QR is a ``vio.tria.<role>`` span inside
    its layer's, in step order, from host spans and from the stamps, of an
    eager step and of a replayed one (``scan.graphed`` on the stand-in
    graph, whose replay runs the captured step)."""
    es = _imu_steps(seq, n=0, cfg=SQRT)[0][0]
    g = seq["gravity_w"]
    body = engine.imu_step_body(SQRT, CAM, g)
    step = (scan.graphed(lambda e, *x: body(e, x)) if run == "graphed"
            else lambda e, *x: body(e, x))

    def x(i):
        return (seq["frames"][i], seq["times"][i], seq["imu_dt"][i - 1],
                seq["imu_gyro"][i - 1], seq["imu_accel"][i - 1])

    with profiling.recording() as rec:
        es1, _ = step(es, *x(1))           # eager (and, graphed, captured)
        step(es1, *x(2))                   # graphed: a replay
        tr = rec.flush()
    last = max(s.frame for s in tr.device)
    for spans in (tr.host, tr.device):
        tree = [t for t in _tria_tree(spans, last)
                if t[0].startswith("vio.") and t[0] != "vio.gates"]
        assert [n for n, _ in tree] == list(SQRT_SPANS)
        assert [t for t in tree if t[0].startswith("vio.tria.")] == TRIA_PARENTS
    if run == "graphed":
        assert stand_in[0].replays == 1


def _aten_ops(fn):
    """Names of the ops ``fn()`` dispatches, the profiler's own left out."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace != "profiler":
                self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as ops:
        fn()
    return ops.seen


def test_off_factor_step_runs_the_ops_it_runs_without_its_spans(seq,
                                                                monkeypatch):
    """With the recorder off the ``vio.tria.*`` spans and the ``skipped``
    count add no op to a factor-form step: the same ops, in the same
    order, as with the spans taken out (a plain QR for ``_qr_r``)."""
    with_spans = _aten_ops(lambda: _imu_steps(seq, n=1, cfg=SQRT))
    monkeypatch.setattr(sqrt_filter, "_qr_r",
                        lambda pre_T, role: torch.linalg.qr(pre_T,
                                                            mode="r").R)
    without = _aten_ops(lambda: _imu_steps(seq, n=1, cfg=SQRT))
    assert with_spans == without and len(without) > 100


# --------------------------------------------------------------------------
# The ring
# --------------------------------------------------------------------------


def test_flush_after_the_ring_wrapped_keeps_the_last_frames():
    with profiling.recording(rows=4) as rec:
        for i in range(6):
            with profiling.frame("f"):
                with profiling.span("inner"):
                    profiling.count("n", torch.tensor([True] * i))
        tr = rec.flush()
        assert tr.dropped == 2
        assert [s.frame for s in tr.device if s.name == "f"] == [3, 4, 5, 6]
        assert [c.value for c in tr.counts] == [2, 3, 4, 5]
        assert [s.frame for s in tr.host if s.name == "f"] == list(range(1, 7))
        for _ in range(2):
            with profiling.frame("f"):
                pass
        tr = rec.flush()
        assert tr.dropped == 0 and [s.frame for s in tr.device] == [7, 8]
        assert rec.flush() == profiling.Trace([], [], [], 0)


def test_a_frame_with_more_slots_than_the_ring_has_raises(monkeypatch):
    monkeypatch.setattr(profiling, "SLOTS", 6)
    with profiling.recording():
        with pytest.raises(RuntimeError, match="slots"):
            with profiling.frame("f"):
                for _ in range(3):
                    with profiling.span("s"):
                        pass


# --------------------------------------------------------------------------
# One clock with the profiler
# --------------------------------------------------------------------------


def _kineto(prof):
    return {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()}


def test_program_spans_share_the_profilers_clock():
    """A layer span opens its ``record_function`` range at its own start
    and closes it at its end: on one clock the two agree."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as rec:
        with profiling.frame("warm-up"), profiling.span("warm-up layer"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with profiling.frame(f"frame{i}"), \
                        profiling.span(f"layer{i}"):
                    torch.ones(256).sum()
        tr = rec.flush()
    events = _kineto(prof)
    layers = [(h, d) for h, d in zip(tr.host, tr.device)
              if h.name.startswith("layer")]
    assert len(layers) == 3
    for h, d in layers:
        assert h.name == d.name
        rf = events[h.name]
        assert abs(h.start_ns - rf[0]) < 50_000
        assert abs(h.end_ns - rf[1]) < 50_000
        # the CPU stamps: host-clock readings inside the range
        assert rf[0] <= d.start_ns <= d.end_ns <= rf[1]


def test_trace_merges_spans_and_counts_into_the_chrome_trace(bench,
                                                              tmp_path):
    with profiling.trace(str(tmp_path), device="cpu"):
        _vision_steps(bench, n=1)
    doc = json.loads((tmp_path / "trace.json").read_text())
    ours = [e for e in doc["traceEvents"]
            if e.get("pid") == "ekf_vio_tpu_torch"]
    names = {(e["ph"], e["name"]) for e in ours}
    assert {("X", "vio.init"), ("X", "vio.step"), ("X", "vio.update"),
            ("C", "tracked"), ("C", "added"), ("C", "lost")} <= names
    assert profiling.active() is None
    # on the profiler's time axis: the program's vio.update inside the
    # profiler's own record_function of it
    prof = [e for e in doc["traceEvents"] if e.get("name") == "vio.update"
            and e.get("pid") != "ekf_vio_tpu_torch"]
    mine = [e for e in ours if e["name"] == "vio.update"
            and e["tid"] == "program spans (host)"]
    assert len(prof) == len(mine) == 1
    assert abs(prof[0]["ts"] - mine[0]["ts"]) < 50.0


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    engine.use_f32_matmul()
    return torch.device("cuda")


def _step_layout(rec):
    return next(k for k in rec.layouts if k[0] == "vio.step>")


def _ring_writes(rec):
    """Ring writes a step makes: one a slot label, one layout id."""
    return len(_step_layout(rec)) + 1


# device ops of one replay of the recorder-off graph of a 128-slot vision
# step (BENCH at 160x120): the graph the step captured before it had a
# recorder, which the recorder, off, leaves as it was
OFF_STEP_OPS = 1158


def _device_ops(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation()]


def _count_ops(rec, device):
    """Device ops a step's counts add besides their ring writes: those of
    ``count_value`` on two masks for each mask counted (added, gated),
    measured here; none for a 0-d count."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.zeros(128, dtype=torch.bool, device=device)
    profiling.count_value(a, a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiling.count_value(a, a)
        torch.cuda.synchronize()
    masks = sum(k in ("#added", "#gated") for k in _step_layout(rec))
    return masks * len(_device_ops(prof))


@pytest.mark.requires_cuda
class TestOnCard:
    def test_stamped_rollouts_are_bitwise_equal(self, cuda, bench):
        small, times = (x.to(cuda) for x in bench)
        cfg = BENCH.replace(max_features=128)
        off = engine.run_sequence(small, times, cfg, CAM)
        with profiling.recording(cuda) as rec:
            profiling.reset_launches()
            on = engine.run_sequence(small, times, cfg, CAM)
            tr = rec.flush()
        _assert_bitwise(on, off)
        assert rec.frames == int(rec.counter[0]) == small.shape[0]
        # the replays ran their stamps: two a span, one a count, one
        # layout id a frame, each a launch counted on the card
        assert profiling.launches() == (2 * len(tr.device) + len(tr.counts)
                                        + rec.frames)
        assert [s.frame for s in tr.device if s.name == "vio.step"] == \
            list(range(2, small.shape[0] + 1))

    def test_stamped_batched_rollout_is_bitwise_equal(self, cuda, bench):
        small, times = (x.to(cuda) for x in bench)
        images = torch.stack([small[i:i + 3] for i in range(4)])
        lane_t = times[:3].expand(4, -1).contiguous()
        cfg = BENCH.replace(max_features=128)
        off = batched_engine.run_sequences_batched(images, lane_t, cfg, CAM)
        with profiling.recording(cuda) as rec:
            on = batched_engine.run_sequences_batched(images, lane_t, cfg,
                                                      CAM)
            tr = rec.flush()
        _assert_bitwise(on, off)
        # one frame a batched step; the counts summed over the lanes
        assert rec.frames == int(rec.counter[0]) == 3
        for f, out in zip((2, 3), range(2)):
            assert _counts(tr, f)["tracked"] == int(
                on[1].num_tracked[:, out].sum())

    def test_stamped_graphed_call_is_bitwise_equal(self, cuda, bench):
        small, times = (x.to(cuda) for x in bench)
        cfg = BENCH.replace(max_features=128)
        step = scan.graphed(lambda es, img, t: engine.step(es, img, t, cfg,
                                                           CAM))

        def run():
            es = engine.initialize(small[0], times[0], cfg, CAM)
            return [step(es, small[i], times[i]) for i in range(1, 5)]

        off = run()
        with profiling.recording(cuda) as rec:
            on = run()
            tr = rec.flush()
        _assert_bitwise(on, off)
        _assert_bitwise(run(), off)  # the plain graph again
        assert rec.frames == int(rec.counter[0]) == 5
        assert len([s for s in tr.device if s.name == "vio.step"]) == 4

    def test_stamps_bracket_their_layers_device_ops(self, cuda, bench):
        """Two replayed steps under the profiler.  The profiler's stamp
        kernels, in stream order, are the ring writes of the step's slot
        layout.  The profiler sets its device events on the host clock by
        a conversion of its own, which drifts against that clock (PERF.md
        §6), so its readings of the stamp kernels are fitted to the stamps
        by one line (an offset and a rate within 1 %): every stamp lies
        within 10 µs of the line, and every device op between a span's two
        stamp kernels lies inside the span to within 10 µs."""
        from torch.profiler import ProfilerActivity, profile

        small, times = (x.to(cuda) for x in bench)
        cfg = BENCH.replace(max_features=128)
        step = scan.graphed(lambda es, img, t: engine.step(es, img, t, cfg,
                                                           CAM))
        with profiling.recording(cuda) as rec:
            es = engine.initialize(small[0], times[0], cfg, CAM)
            es, _ = step(es, small[1], times[1])        # eager + capture
            rec.flush()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in (2, 3):
                    es, _ = step(es, small[i], times[i])
                torch.cuda.synchronize()
            tr = rec.flush()
        ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA")
                     and not e.is_user_annotation())
        stamps = [i for i, o in enumerate(ops) if "ring_write" in o[2]]
        layout = _step_layout(rec) + (None,)       # the layout id last
        assert len(stamps) == 2 * len(layout)
        kernel = {}                                # (frame, label) -> op
        for k, i in enumerate(stamps):
            kernel[(tr.device[0].frame + k // len(layout),
                    layout[k % len(layout)])] = i
        pairs = [(kernel[(s.frame, s.name + ">")], kernel[(s.frame,
                                                           s.name + "<")], s)
                 for s in tr.device]
        t0 = tr.device[0].start_ns
        x = np.array([float(t - t0) for a, b, s in pairs
                      for t in (s.start_ns, s.end_ns)])
        y = np.array([float(ops[i][0] - t0) for a, b, s in pairs
                      for i in (a, b)])
        rate, offset = np.polyfit(x, y, 1)
        print(f"profiler = {offset / 1e3:.3f} us + (1 {rate - 1:+.2e}) x "
              f"stamps; worst residual "
              f"{np.abs(y - (offset + rate * x)).max() / 1e3:.3f} us")
        assert abs(rate - 1.0) < 0.01
        assert np.abs(y - (offset + rate * x)).max() <= 10_000

        def stamp_time(t):                         # profiler -> stamps
            return t0 + (t - t0 - offset) / rate

        for a, b, s in pairs:
            for o in ops[a + 1:b]:
                assert (s.start_ns - 10_000 <= stamp_time(o[0])
                        <= stamp_time(o[1]) <= s.end_ns + 10_000), (s, o)

    def test_the_stamps_keep_to_the_host_clock(self, cuda):
        """The offset from ``%globaltimer`` to the host clock, measured
        again a second later, moves by less than 50 µs: device stamps and
        host spans share the clock over a slice's length."""
        import time

        first = profiling.Recorder(cuda).offset_ns
        time.sleep(1.0)
        assert abs(profiling.Recorder(cuda).offset_ns - first) < 50_000

    def test_off_graph_has_no_stamp_node(self, cuda, bench):
        """One replay of the recorder-off graph and of the stamped graph
        under the profiler: the first has the ops it had before the
        recorder and no stamp kernel, the second exactly the ring writes
        and the counts' own ops more."""
        from torch.profiler import ProfilerActivity, profile

        small, times = (x.to(cuda) for x in bench)
        cfg = BENCH.replace(max_features=128)
        step = scan.graphed(lambda es, img, t: engine.step(es, img, t, cfg,
                                                           CAM))
        es0 = engine.initialize(small[0], times[0], cfg, CAM)

        def replay_ops():
            step(es0, small[1], times[1])               # eager + capture
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(es0, small[1], times[1])
                torch.cuda.synchronize()
            return _device_ops(prof)

        off = replay_ops()
        with profiling.recording(cuda) as rec:
            on = replay_ops()
        print(f"timer: {profiling.timer_resolution_ns(cuda)}; replayed step "
              f"{len(off)} ops, stamped {len(on)}")
        assert len(off) == OFF_STEP_OPS
        assert not any("ring_write" in n for n in off)
        assert sum("ring_write" in n for n in on) == _ring_writes(rec)
        assert len(on) - len(off) == (_ring_writes(rec)
                                      + _count_ops(rec, cuda))

    def test_off_factor_graph_has_the_nodes_it_has_without_its_spans(
            self, cuda, seq, monkeypatch):
        """The factor-form 128-slot test step (IMU, depth bootstrap): one
        replay of its recorder-off graph runs as many device ops as the
        graph captured with the ``vio.tria.*`` spans taken out, and no
        stamp; the stamped replay stamps the spans in step order."""
        from torch.profiler import ProfilerActivity, profile

        cfg = SQRT.replace(max_features=128)
        d = {k: v.to(cuda) for k, v in seq.items()}
        body = engine.imu_step_body(cfg, CAM, d["gravity_w"])
        x = (d["frames"][1], d["times"][1], d["imu_dt"][0], d["imu_gyro"][0],
             d["imu_accel"][0])
        es0 = engine.initialize(d["frames"][0], d["times"][0], cfg, CAM)

        def replay_ops():
            step = scan.graphed(lambda e, *a: body(e, a))
            step(es0, *x)                                # eager + capture
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(es0, *x)
                torch.cuda.synchronize()
            return _device_ops(prof)

        off = replay_ops()
        with profiling.recording(cuda) as rec:
            on = replay_ops()
            tr = rec.flush()
        with monkeypatch.context() as m:
            m.setattr(sqrt_filter, "_qr_r",
                      lambda pre_T, role: torch.linalg.qr(pre_T, mode="r").R)
            plain = replay_ops()
        print(f"factor-form step: {len(off)} ops off, {len(plain)} without "
              f"the spans, {len(on)} stamped")
        assert len(off) == len(plain)
        assert not any("ring_write" in n for n in off)
        last = max(s.frame for s in tr.device)
        tree = [t for t in _tria_tree(tr.device, last)
                if t[0] != "vio.gates"]
        assert [n for n, _ in tree] == list(SQRT_SPANS)
        assert [t for t in tree if t[0].startswith("vio.tria.")] == TRIA_PARENTS

    def test_graphed_factor_step_is_the_eager_step_bitwise(self, cuda, seq):
        """The factor-form 128-slot test step (IMU, depth bootstrap, the
        carried factor's two QRs, 790-1,503-row arrays at D = 406), two
        frames: each replay of its ``scan.graphed`` capture equals the
        eager step bitwise, and the state it hands on is square
        lower-triangular."""
        cfg = SQRT.replace(max_features=128)
        d = {k: v.to(cuda) for k, v in seq.items()}
        body = engine.imu_step_body(cfg, CAM, d["gravity_w"])

        def x(i):
            return (d["frames"][i], d["times"][i], d["imu_dt"][i - 1],
                    d["imu_gyro"][i - 1], d["imu_accel"][i - 1])

        es0 = engine.initialize(d["frames"][0], d["times"][0], cfg, CAM)
        eager1 = body(es0, x(1))
        eager2 = body(eager1[0], x(2))
        step = scan.graphed(lambda e, *a: body(e, a))
        step(es0, *x(1))                                 # eager + capture
        got1 = step(es0, *x(1))
        got2 = step(got1[0], *x(2))
        _assert_bitwise(got1, eager1)
        _assert_bitwise(got2, eager2)
        L = got2[0].filt.Sigma
        assert L.shape == (406, 406) and torch.equal(L, torch.tril(L))
