"""Parity of the PyTorch engine (ekf_vio_tpu_torch/engine.py) with the JAX
engine on the CPU, the interop and frame helpers it is driven with, and
the port's independence from JAX.

Bars: one step from a state carried over by ``interop`` matches at the
bars of ``__graft_entry__.dryrun_multichip`` (equal num_tracked and
active set; base_mu within 1e-4, feat_mu within 2e-5, Σ within
1e-3·max(|Σ|, 1)); a 10-frame rollout tracks and keeps exactly the same
number of features on every frame.
"""
import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu import engine as jengine
from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.frontend import camera as jcam
from ekf_vio_tpu_torch import engine, interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.sim import frames as sim_frames

W, H = 160, 120
K = [[458.0 / 4, 0.0, W / 2], [0.0, 458.0 / 4, H / 2], [0.0, 0.0, 1.0]]
BENCH_KW = dict(min_new_feature_dist=8.0, fast_threshold=30)


def _small_frames(n):
    """Bench frames downscaled ÷4 once (by the JAX package), so both
    engines see bitwise the same 160x120 inputs."""
    frames, times = sim_frames.make_frames(seed=0, n_frames=n)
    small = np.array(jcam.downscale_image(jnp.asarray(frames), 4))
    return small, times


def _jax_state_dict(es):
    d = {k: np.asarray(getattr(es.filt, k)) for k in interop.FILTER_FIELDS}
    d["prev_pyr"] = [np.asarray(level) for level in es.prev_pyr]
    d["frame_idx"] = np.asarray(es.frame_idx)
    d["lin_base"] = np.asarray(es.lin_base)
    return d


def test_one_step_from_a_carried_jax_state():
    small, times = _small_frames(2)
    jcfg = JConfig(max_features=128, **BENCH_KW)
    cfg = VIOConfig(max_features=128, **BENCH_KW)
    jc = jengine.make_hashable_camera(K, W, H)
    es0 = jengine.initialize(jnp.asarray(small[0]), times[0], jcfg, jc)
    es1, jout = jax.jit(jengine.step, static_argnums=(3, 4))(
        es0, jnp.asarray(small[1]), jnp.float32(times[1]), jcfg, jc)

    ts0 = interop.engine_state_from_numpy(_jax_state_dict(es0), "cpu")
    ts1, out = engine.step(ts0, torch.from_numpy(small[1]),
                           torch.tensor(times[1]), cfg,
                           interop.camera_from_K(K, W, H))
    assert int(out.num_tracked) == int(jout.num_tracked) > 50
    assert int(out.num_active) == int(jout.num_active)
    np.testing.assert_array_equal(ts1.filt.active.numpy(),
                                  np.asarray(es1.filt.active))
    assert np.abs(ts1.filt.base_mu.numpy() - np.asarray(es1.filt.base_mu)
                  ).max() < 1e-4
    assert np.abs(ts1.filt.feat_mu.numpy() - np.asarray(es1.filt.feat_mu)
                  ).max() < 2e-5
    sig = np.asarray(es1.filt.Sigma)
    assert np.abs(ts1.filt.Sigma.numpy() - sig).max() < 1e-3 * max(
        np.abs(sig).max(), 1.0)
    assert bool(out.tracking_lost) == bool(jout.tracking_lost)
    # the carried state and the intrinsics round-trip
    np.testing.assert_array_equal(
        interop.camera_to_K(interop.camera_from_K(K, W, H)),
        np.asarray(jc.K))
    back = interop.engine_state_to_numpy(ts0)
    for k, v in _jax_state_dict(es0).items():
        if k == "prev_pyr":
            for a, b in zip(back[k], v):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(back[k], v)


def test_ten_frame_rollout_matches_jax():
    small, times = _small_frames(10)
    jcfg = JConfig(max_features=64, num_features=50, **BENCH_KW)
    cfg = VIOConfig(max_features=64, num_features=50, **BENCH_KW)
    _, jout = jengine.run_sequence(jnp.asarray(small), jnp.asarray(times),
                                   jcfg, jengine.make_hashable_camera(K, W, H))
    es, out = engine.run_sequence(torch.from_numpy(small),
                                  torch.from_numpy(times), cfg,
                                  interop.camera_from_K(K, W, H))
    np.testing.assert_array_equal(out.num_tracked.numpy(),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(out.num_active.numpy(),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 10
    assert torch.isfinite(out.base_mu).all()
    # f32 roundoff compounds over the rollout in the weakly observed
    # kinematic states; the per-step bar is held by the test above
    np.testing.assert_allclose(out.base_mu.numpy(), np.asarray(jout.base_mu),
                               atol=5e-3)
    assert int(es.frame_idx) == 10


def test_recover_tracking_lost_matches_jax():
    rng = np.random.RandomState(0)
    n = 8
    cfg, jcfg = VIOConfig(max_features=n), JConfig(max_features=n)
    d = {k: np.asarray(v) for k, v in zip(
        interop.FILTER_FIELDS,
        (rng.normal(size=22).astype(np.float32),
         rng.normal(size=(n, 3)).astype(np.float32),
         rng.uniform(size=n) < 0.5, rng.normal(size=(n, 2)).astype(np.float32),
         np.diag(rng.uniform(0.1, 1, 22 + 3 * n)).astype(np.float32),
         np.float32(0.3), rng.randint(0, 5, n).astype(np.int32)))}
    d["base_mu"][1] = np.nan
    d["Sigma"][17, 17] = np.inf
    from ekf_vio_tpu.core import state as jstate

    js = jstate.FilterState(**{k: jnp.asarray(v) for k, v in d.items()})
    for lost in (True, False):
        got = engine._recover_tracking_lost(
            interop.filter_state_from_numpy(d, "cpu"), cfg,
            torch.tensor(lost))
        ref = jengine._recover_tracking_lost(js, jcfg, jnp.asarray(lost))
        for k in interop.FILTER_FIELDS:
            np.testing.assert_allclose(
                getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("option", [
    dict(square_root_form=True), dict(triangulate_new_features=True),
    dict(innovation_gate_chi2=25.0), dict(min_eigen_rel_gate=20.0),
    dict(klt_covariance="sample")])
def test_off_slice_options_raise(option):
    small, times = _small_frames(2)
    cam = interop.camera_from_K(K, W, H)
    es = engine.initialize(torch.from_numpy(small[0]), times[0],
                           VIOConfig(max_features=32, **BENCH_KW), cam)
    with pytest.raises(NotImplementedError):
        engine.step(es, torch.from_numpy(small[1]), torch.tensor(times[1]),
                    VIOConfig(max_features=32, **BENCH_KW, **option), cam)


def test_imu_step_raises():
    small, times = _small_frames(2)
    cam = interop.camera_from_K(K, W, H)
    cfg = VIOConfig(max_features=32, **BENCH_KW)
    es = engine.initialize(torch.from_numpy(small[0]), times[0], cfg, cam)
    with pytest.raises(NotImplementedError):
        engine.step(es, torch.from_numpy(small[1]), torch.tensor(times[1]),
                    cfg, cam, imu_batch=object())


def test_sim_frames_equal_bench_frames(monkeypatch):
    monkeypatch.setenv("EKF_VIO_NO_COMPILE_CACHE", "1")
    bench = importlib.import_module("bench")
    ref, ref_t = bench.make_frames(seed=0)
    got, got_t = sim_frames.make_frames(seed=0)
    for i in (0, 1, 239):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_array_equal(got_t, ref_t)
    short, _ = sim_frames.make_frames(seed=0, n_frames=3)
    np.testing.assert_array_equal(short, ref[:3])


def test_port_imports_no_jax():
    code = ("import sys, ekf_vio_tpu_torch.engine, ekf_vio_tpu_torch.interop, "
            "ekf_vio_tpu_torch.sim.frames; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ekf_vio_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
