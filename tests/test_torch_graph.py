"""Compiled rollouts (ekf_vio_tpu_torch/scan.py): the step paths build no
tensor from host data and read nothing back, ``scan``'s static-buffer
rollout equals the eager loop bitwise, and ``scan`` is ``jax.lax.scan``.

* The host-read guard: one ``step`` of each path (vision, IMU, square-root
  IMU with ``klt_covariance="sample"``, the vmapped batched step, the
  simulator's closed-loop step) runs under a ``TorchDispatchMode`` that
  fails on ``aten.lift_fresh`` (a tensor from host data: on the card a
  pageable host-to-device copy, which a capturing stream refuses),
  ``aten._local_scalar_dense`` (``.item()``, ``if`` on a tensor),
  ``aten.nonzero``, ``aten.masked_select`` and boolean ``aten.index``.  A
  planted ``torch.tensor([...])``, a planted ``.item()`` and the step with
  its old host constant are caught.
* The bookkeeping of the graph path on the CPU: ``StandInGraph`` takes the
  place of the CUDA graph (monkeypatched over ``scan._capture``): a
  capture records the callable and runs nothing, ``replay()`` runs it.
  The static-buffer rollouts of ``run_sequence``, ``run_sequence_imu``,
  ``run_sequences_batched`` and ``simulator.run_scenario`` equal
  ``scan.loop`` bitwise and their outputs alias nothing a replay made;
  ``scan.graphed`` captures once for every value of a Python float.
* Every kernel of ``csrc`` counts its own launches on the card, so a
  replay's launches are counted where they run.
* On the card (``requires_cuda``, skipped here): a graphed
  ``run_sequence`` and ``run_sequences_batched`` (B = 4) against the eager
  ``step`` loop: every count equal; base_mu, Σ and mean_nis equal, or no
  further apart than two eager rollouts are.

Small shapes throughout: 160x120 frames, 32 slots, 4-6 frames.  The file
imports no JAX at the top, so it runs with ``--noconftest`` on a machine
without JAX; the ``jax.lax.scan`` parity case imports JAX itself and
skips where there is none.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ekf_vio_tpu_torch import engine, scan
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import imu
from ekf_vio_tpu_torch.frontend import camera, lk_cuda
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.parallel import batched, batched_engine
from ekf_vio_tpu_torch.sim import frames as sim_frames
from ekf_vio_tpu_torch.sim import rendered, simulator

W, H = 160, 120
CAM = Camera.from_K([[458.0 / 4, 0.0, W / 2], [0.0, 458.0 / 4, H / 2],
                     [0.0, 0.0, 1.0]], W, H)
BENCH = VIOConfig(max_features=32, min_new_feature_dist=8.0,
                  fast_threshold=30)
MONO = VIOConfig.from_yaml(
    Path(__file__).resolve().parent.parent / "configs" / "mono_inertial.yaml"
).replace(max_features=32)

aten = torch.ops.aten
BANNED = {aten.lift_fresh.default, aten._local_scalar_dense.default,
          aten.nonzero.default, aten.masked_select.default}


class HostRead(AssertionError):
    pass


TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
# torch's wrappers between a call and the dispatch mode
WRAPPERS = ("_compile.py", "_dynamo" + os.sep, "utils" + os.sep
            + "_python_dispatch.py")


def _made_by_torch() -> bool:
    """Whether the op's caller, the nearest frame outside the dispatch
    mode and torch's wrappers, is PyTorch's own code (torch 2.11's
    ``jacfwd`` builds its basis offsets with ``torch.tensor`` on the
    CPU, where they stay), not the port's."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_filename
        if not (name.startswith(TORCH_DIR)
                and name[len(TORCH_DIR):].startswith(WRAPPERS)):
            return name.startswith(TORCH_DIR)
        frame = frame.f_back
    return False


class NoHostData(TorchDispatchMode):
    """Fails on every op that builds a tensor from host data or reads one
    back to the host (a host constant that PyTorch's own code makes is
    not the port's)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bad = func in BANNED or (func is aten.index.Tensor and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1] if i is not None))
        if bad and not (func is aten.lift_fresh.default
                        and _made_by_torch()):
            raise HostRead(f"{func} in a step")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread, as the suite's other port files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    """Bench frames 0-5 at 160x120 and their times."""
    frames, times = sim_frames.make_frames(seed=0, n_frames=6)
    small = camera.downscale_image(torch.from_numpy(frames), 4).contiguous()
    return small, torch.from_numpy(times)


@pytest.fixture(scope="module")
def seq():
    """A rendered 160x120 mono-inertial sequence of 6 frames, as tensors."""
    s = rendered.generate(num_frames=6, w=W, h=H)
    return {k: torch.from_numpy(np.ascontiguousarray(getattr(s, k)))
            for k in ("frames", "times", "imu_dt", "imu_gyro", "imu_accel",
                      "gravity_w")}


def _imu_step(cfg, seq):
    es = engine.initialize(seq["frames"][0], seq["times"][0], cfg, CAM,
                           device="cpu")
    batch = imu.ImuSample(seq["imu_dt"][0], seq["imu_gyro"][0],
                          seq["imu_accel"][0])
    return lambda: engine.step(es, seq["frames"][1], seq["times"][1], cfg,
                               CAM, imu_batch=batch,
                               gravity_w=seq["gravity_w"])


def _step_of(path, bench, seq):
    """A callable running one step of ``path`` on prepared inputs."""
    small, times = bench
    if path == "vision":
        es = engine.initialize(small[0], times[0], BENCH, CAM, device="cpu")
        return lambda: engine.step(es, small[1], times[1], BENCH, CAM)
    if path == "imu":
        return _imu_step(MONO, seq)
    if path == "sqrt_imu_sample":
        return _imu_step(MONO.replace(square_root_form=True,
                                      klt_covariance="sample"), seq)
    if path == "batched":
        lanes, lane_t = small[None, :2].repeat(2, 1, 1, 1), times[:2]
        es = torch.func.vmap(lambda im, t: engine.initialize(
            im, t, BENCH, CAM, device="cpu"))(lanes[:, 0],
                                              lane_t[0].expand(2))
        step = torch.func.vmap(
            lambda e, im, t: engine.step(e, im, t, BENCH, CAM))
        return lambda: step(es, lanes[:, 1], lane_t[1].expand(2))
    assert path == "simulator"
    scn = simulator.REFERENCE_SCENARIOS[5]
    cfg = VIOConfig(max_features=scn.feature_count)
    gen = torch.Generator().manual_seed(0)
    pts, valid = simulator.generate_scene(gen, scn, cfg.max_features)
    from ekf_vio_tpu_torch.core import filter as ekf

    state = ekf.add_features(ekf.init_state(cfg, device="cpu"), cfg,
                             pts[:, :2] / pts[:, 2:3], valid)
    gt = simulator.GroundTruth(torch.zeros(3), torch.eye(4)[0],
                               torch.full((3,), 0.1), torch.zeros(3))
    omega, mc = torch.full((3,), 0.1), (torch.eye(2) * 1e-5).expand(
        cfg.max_features, 2, 2)
    return lambda: simulator._closed_loop_step((state, gt), scn, cfg, pts,
                                               valid, omega, mc)


PATHS = ("vision", "imu", "sqrt_imu_sample", "batched", "simulator")


@pytest.mark.parametrize("path", PATHS)
def test_a_step_builds_nothing_from_host_data(path, bench, seq):
    run = _step_of(path, bench, seq)
    with NoHostData():
        out = run()
    assert all(torch.isfinite(x.float()).all()
               for x in _pytree.tree_leaves(out))


def test_the_guard_catches_a_host_constant_and_a_read(bench, seq):
    with pytest.raises(HostRead, match="lift_fresh"), NoHostData():
        torch.tensor([1.0, 0.0])
    x = torch.ones(3)
    with pytest.raises(HostRead, match="_local_scalar_dense"), NoHostData():
        x.sum().item()
    with pytest.raises(HostRead, match="index"), NoHostData():
        x[x > 0]


def test_the_guard_catches_the_old_host_constant(bench, seq, monkeypatch):
    """The step with ``_recovered_base``'s constant written as before
    (``init_mu[3] = 1.0``) fails the guard."""
    def old_recovered_base(base_mu):
        init_mu = torch.zeros(22, dtype=base_mu.dtype)
        init_mu[3] = 1.0
        return torch.where(torch.isfinite(base_mu), base_mu, init_mu)

    monkeypatch.setattr(engine, "_recovered_base", old_recovered_base)
    run = _step_of("vision", bench, seq)
    with pytest.raises(HostRead, match="lift_fresh"), NoHostData():
        run()


# --------------------------------------------------------------------------
# The graph path's bookkeeping on the CPU
# --------------------------------------------------------------------------


class StandInGraph:
    """Test-only stand-in for ``torch.cuda.CUDAGraph``: the capture
    records ``fn`` and runs nothing; each ``replay()`` runs it again on
    the same buffers, as a replay runs the captured kernels."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """``scan`` takes its graph path on CPU tensors, with StandInGraph as
    the graph; the step outputs each replay made are recorded."""
    graphs, made = [], []
    real_step = engine.step

    def recording_step(*a, **kw):
        es, out = real_step(*a, **kw)
        made.append((es, out))
        return es, out

    def capture(fn):
        graphs.append(StandInGraph(fn))
        return graphs[-1]

    monkeypatch.setattr(scan, "_on_card", lambda tree: True)
    monkeypatch.setattr(scan, "_capture", capture)
    monkeypatch.setattr(engine, "step", recording_step)
    return graphs, made


def _storages(tree) -> set:
    return {x.untyped_storage().data_ptr()
            for x in _pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)}


def _assert_bitwise(a, b):
    la, lb = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and \
            torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def _eager(fn, monkeypatch):
    """``fn()`` with every rollout's ``scan.scan`` as the plain loop."""
    with monkeypatch.context() as m:
        m.setattr(scan, "scan", scan.loop)
        return fn()


@pytest.mark.parametrize("path", ("vision", "imu"))
def test_static_buffer_rollout_equals_the_eager_loop(path, bench, seq,
                                                     stand_in, monkeypatch):
    graphs, made = stand_in
    if path == "vision":
        small, times = bench
        run = lambda: engine.run_sequence(small[:5], times[:5], BENCH, CAM,
                                          device="cpu")
    else:
        args = (seq["frames"], seq["times"], seq["imu_dt"], seq["imu_gyro"],
                seq["imu_accel"], seq["gravity_w"])
        run = lambda: engine.run_sequence_imu(*args, MONO, CAM,
                                              device="cpu")
    es, outs = run()
    assert len(graphs) == 1 and graphs[0].replays == outs.base_mu.shape[0] - 1
    last_es, last_out = made[-1]
    # the stacked outputs and the final carry are buffers of scan's own,
    # not the tensors the last replay's step returned
    assert not _storages(outs) & _storages(last_out)
    assert not _storages(es) & _storages(last_es)
    assert torch.equal(outs.base_mu[-1], last_out.base_mu)
    made.clear()
    es_ref, outs_ref = _eager(run, monkeypatch)
    assert len(graphs) == 1  # the eager loop captured nothing
    _assert_bitwise(outs, outs_ref)
    _assert_bitwise(es, es_ref)


def test_static_buffer_batched_rollout_equals_the_eager_loop(
        bench, stand_in, monkeypatch):
    graphs, _ = stand_in
    small, times = bench
    images = torch.stack([small[:4], small[1:5]])
    lane_t = torch.stack([times[:4], times[:4]])
    run = lambda: batched_engine.run_sequences_batched(
        images, lane_t, BENCH, CAM, device="cpu")
    es, outs = run()
    assert len(graphs) == 1 and graphs[0].replays == 2
    assert outs.base_mu.shape == (2, 3, 22)
    es_ref, outs_ref = _eager(run, monkeypatch)
    _assert_bitwise(outs, outs_ref)
    _assert_bitwise(es, es_ref)


@pytest.mark.parametrize("sqrt", (False, True))
def test_static_buffer_simulator_equals_the_eager_loop(sqrt, stand_in,
                                                       monkeypatch):
    graphs, _ = stand_in
    scn = simulator.REFERENCE_SCENARIOS[5]
    cfg = VIOConfig(max_features=scn.feature_count, square_root_form=sqrt)

    def run():
        return simulator.run_scenario(
            scn, cfg, 6, generator=torch.Generator().manual_seed(0),
            device="cpu")

    state, gt, telem = run()
    assert len(graphs) == 1 and graphs[0].replays == 5
    ref = _eager(run, monkeypatch)
    _assert_bitwise((state, gt, telem), ref)


def test_graphed_step_equals_the_eager_step(bench, stand_in):
    """``scan.graphed`` (the CLI's streaming step): the first call is the
    eager step, later calls replay on copies of their arguments and
    return copies of the outputs."""
    graphs, _ = stand_in
    small, times = bench
    real_step = engine.step
    step = scan.graphed(lambda es, img, t: real_step(es, img, t, BENCH, CAM))
    es = es_ref = engine.initialize(small[0], times[0], BENCH, CAM,
                                    device="cpu")
    for i in range(1, 5):
        es, out = step(es, small[i], times[i])
        es_ref, out_ref = real_step(es_ref, small[i], times[i], BENCH, CAM)
        _assert_bitwise((es, out), (es_ref, out_ref))
    assert len(graphs) == 1 and graphs[0].replays == 3
    # a copy, not the graph's own outputs: the next replay leaves it be
    kept = out.base_mu.clone()
    step(es, small[5], times[5])
    assert torch.equal(out.base_mu, kept)


def test_graphed_step_takes_a_python_float_as_an_input(stand_in,
                                                      monkeypatch):
    """A Python float is an input of ``scan.graphed``'s graph, as
    ``jax.jit`` traces it: the batched filter step called with three
    values of ``dt`` captures one graph and equals the eager step bitwise
    on every call."""
    graphs, _ = stand_in
    cfg = VIOConfig(max_features=8)
    state = batched.init_batched_state(
        cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    z = state.feat_mu[:, :, :2] + 0.01
    step = batched.make_batched_filter_step(cfg)
    with monkeypatch.context() as m:
        m.setattr(scan, "graphed", lambda fn: fn)
        eager = batched.make_batched_filter_step(cfg)
    for dt in (0.05, 0.033, 0.05, 0.1):
        _assert_bitwise(step(state, z, dt), eager(state, z, dt))
    assert len(graphs) == 1 and graphs[0].replays == 3


CSRC = Path(__file__).resolve().parent.parent / "ekf_vio_tpu_torch" / "csrc"


@pytest.mark.parametrize("name", ("lk_level", "fast9", "klt_level", "stamp"))
def test_every_kernel_counts_its_own_launches(name):
    """A replay runs no host code, so each ``__global__`` kernel of the
    library counts its launch on the card: ``count_launch()``
    (``csrc/launch_count.cuh``) before any statement that could return;
    and no wrapper counts on the host."""
    import re

    src = (CSRC / f"{name}.cu").read_text()
    assert '#include "launch_count.cuh"' in src
    kernels = [m.end() for m in re.finditer(r"__global__[^;{]*\{", src)]
    assert kernels
    for start in kernels:
        head = src[start:src.index("count_launch();", start)]
        assert "return" not in head and "}" not in head
    for module in ("lk_cuda", "fast_cuda", "klt_cuda"):
        wrapper = (CSRC.parent / "frontend" / f"{module}.py").read_text()
        assert "launches +=" not in wrapper


def test_scan_is_jax_lax_scan():
    """``scan`` over a pytree carry and pytree xs against
    ``jax.lax.scan`` on the same numbers."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    rng = np.random.RandomState(0)
    c0 = (rng.randn(3).astype(np.float32), rng.randn(2, 2).astype(np.float32))
    xs = {"a": rng.randn(7, 3).astype(np.float32),
          "b": rng.randn(7).astype(np.float32)}

    def body(lib):
        def f(c, x):
            v, m = c
            v = v * 0.5 + x["a"] * x["b"]
            m = m @ m.T * 0.1 + v[:2, None]
            return (v, m), (v.sum(), m[0])
        return f

    (jv, jm), (js, jr) = jax.lax.scan(body(jnp), (jnp.asarray(c0[0]),
                                                  jnp.asarray(c0[1])),
                                      {k: jnp.asarray(v)
                                       for k, v in xs.items()})
    (tv, tm), (ts, tr) = scan.scan(
        body(torch), tuple(torch.from_numpy(c) for c in c0),
        {k: torch.from_numpy(v) for k, v in xs.items()})
    for a, b in ((jv, tv), (jm, tm), (js, ts), (jr, tr)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                   atol=1e-6)
    assert ts.shape == (7,) and tr.shape == (7, 2)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def _eager_rollout(small, times, cfg):
    es = engine.initialize(small[0], times[0], cfg, CAM, device=small.device)
    outs = []
    for i in range(1, small.shape[0]):
        es, out = engine.step(es, small[i], times[i], cfg, CAM)
        outs.append(out)
    return es, engine.StepOutputs(*map(torch.stack, zip(*outs)))


def _no_further_apart(graph, eager, eager2) -> None:
    """Every count equal; base_mu, Σ and mean_nis equal, or no further
    from the eager rollout than a second eager rollout is."""
    (ges, gout), (ees, eout), (e2es, e2out) = graph, eager, eager2
    for k in ("num_tracked", "num_active", "tracking_lost"):
        assert torch.equal(getattr(gout, k), getattr(eout, k)), k
    for g, e, e2 in ((gout.base_mu, eout.base_mu, e2out.base_mu),
                     (gout.mean_nis, eout.mean_nis, e2out.mean_nis),
                     (ges.filt.Sigma, ees.filt.Sigma, e2es.filt.Sigma)):
        assert (g - e).abs().max() <= (e2 - e).abs().max()


@pytest.mark.requires_cuda
class TestGraphsOnCard:
    def test_graphed_run_sequence_equals_the_eager_loop(self, cuda, bench):
        small, times = (x.to(cuda) for x in bench)
        cfg = BENCH.replace(max_features=128)
        before = lk_cuda.launches()
        graph = engine.run_sequence(small, times, cfg, CAM)
        assert lk_cuda.launches() - before == small.shape[0] - 1
        assert scan.last["replays"] == small.shape[0] - 2
        _no_further_apart(graph, _eager_rollout(small, times, cfg),
                          _eager_rollout(small, times, cfg))

    def test_graphed_batched_rollout_equals_the_eager_loop(self, cuda,
                                                           bench):
        small, times = (x.to(cuda) for x in bench)
        images = torch.stack([small[i:i + 3] for i in range(4)])
        lane_t = times[:3].expand(4, -1)
        cfg = BENCH.replace(max_features=128)
        es, outs = batched_engine.run_sequences_batched(images, lane_t, cfg,
                                                        CAM)
        init = torch.func.vmap(lambda im, t: engine.initialize(im, t, cfg,
                                                               CAM))
        step = torch.func.vmap(lambda e, im, t: engine.step(e, im, t, cfg,
                                                            CAM))

        def eager():
            e = init(images[:, 0], lane_t[:, 0])
            ys = []
            for i in range(1, 3):
                e, y = step(e, images[:, i], lane_t[:, i])
                ys.append(y)
            return e, engine.StepOutputs(
                *(torch.stack(f, 1) for f in zip(*ys)))

        _no_further_apart((es, outs), eager(), eager())
