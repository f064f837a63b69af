"""Parity of the PyTorch engine (ekf_vio_tpu_torch/engine.py) with the JAX
engine on the CPU, the interop and frame helpers it is driven with, and
the port's independence from JAX.

Bars: one step from a state carried over by ``interop`` matches at the
bars of ``__graft_entry__.dryrun_multichip`` (equal num_tracked and
active set; base_mu within 1e-4, feat_mu within 2e-5, Σ within
1e-3·max(|Σ|, 1)); a rollout tracks and keeps exactly the same number of
features on every frame, vision-only and mono-inertial.

The mono-inertial cases run on rendered 320x240 frames rounded to
integers (camera bytes), where the JAX package's ``pallas_fast.detect``
would run its Pallas kernel on a TPU: the fixture ``jax_fast_rule`` gives
the JAX side that kernel's margin order (mask before NMS) on the CPU, the
rule the port follows at that size.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu import engine as jengine
from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.core import imu as jimu
from ekf_vio_tpu.frontend import camera as jcam
from ekf_vio_tpu.frontend import fast as jfast
from ekf_vio_tpu.frontend import pallas_fast as jpallas_fast
from ekf_vio_tpu_torch import engine, interop
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.core import filter as tfilt
from ekf_vio_tpu_torch.core import imu
from ekf_vio_tpu_torch.sim import frames as sim_frames
from ekf_vio_tpu_torch.sim import rendered

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
                                  interop.camera_from_K(K, W, H),
                                  device="cpu")
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
            torch.tensor(lost), tfilt.COVARIANCE)
        ref = jengine._recover_tracking_lost(js, jcfg, jnp.asarray(lost))
        for k in interop.FILTER_FIELDS:
            np.testing.assert_allclose(
                getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("option", [dict(square_root_form=True)])
def test_off_slice_options_raise(option):
    """No option of the JAX engine is off the port's slice any more: a
    step under the option runs (its parity: test_torch_sqrt_engine.py).
    What is still refused is what the JAX package refuses, ``budget``
    with ``square_root_form``."""
    small, times = _small_frames(2)
    cam = interop.camera_from_K(K, W, H)
    cfg = VIOConfig(max_features=32, **BENCH_KW, **option)
    es = engine.initialize(torch.from_numpy(small[0]), times[0], cfg, cam,
                           device="cpu")
    es1, out = engine.step(es, torch.from_numpy(small[1]),
                           torch.tensor(times[1]), cfg, cam)
    assert torch.isfinite(es1.filt.Sigma).all() and int(out.num_tracked) > 10
    n = cfg.max_features
    with pytest.raises(ValueError, match="budget"):
        tfilt.update_with_feature_positions(
            tfilt.init_state(cfg), cfg, torch.zeros(n, 2),
            torch.eye(2).expand(n, 2, 2), torch.ones(n, dtype=torch.bool),
            budget=n - 1)


def test_entry_points_run_on_the_card_unless_asked():
    small, times = _small_frames(2)
    cam = interop.camera_from_K(K, W, H)
    cfg = VIOConfig(max_features=32, **BENCH_KW)
    es = engine.initialize(small[0], times[0], cfg, cam, device="cpu")
    assert es.filt.Sigma.device.type == "cpu"
    if torch.cuda.is_available():
        return
    for call in (lambda: engine.initialize(small[0], times[0], cfg, cam),
                 lambda: engine.run_sequence(small, times, cfg, cam)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _assert_step_close(ts1, es1):
    """One step's bars: equal active set; base_mu within 1e-4, (u, v)
    within 2e-5, ρ within 1e-4 (inverse depths near 2 that a few px of
    parallax observe weakly: the update amplifies f32 roundoff), Σ
    within 1e-3·max(|Σ|, 1)."""
    np.testing.assert_array_equal(ts1.filt.active.numpy(),
                                  np.asarray(es1.filt.active))
    assert np.abs(ts1.filt.base_mu.numpy() - np.asarray(es1.filt.base_mu)
                  ).max() < 1e-4
    dfeat = np.abs(ts1.filt.feat_mu.numpy() - np.asarray(es1.filt.feat_mu))
    assert dfeat[:, :2].max() < 2e-5 and dfeat[:, 2].max() < 1e-4
    sig = np.asarray(es1.filt.Sigma)
    assert np.abs(ts1.filt.Sigma.numpy() - sig).max() < 1e-3 * max(
        np.abs(sig).max(), 1.0)


# one parity case per option of step() beyond the vision main path, each
# from a state where the option changes the step's result (checked
# against the JAX step without it): (options, base steps run before)
OPTIONS = {
    # a tight kinematic prior, so the first step's innovations are
    # significant and the gate rejects some of them
    "chi2": (dict(innovation_gate_chi2=1.2, init_kinematic_variance=1e-4),
             0),
    "rel_eig": (dict(min_eigen_rel_gate=1.5), 3),
    "sample_R": (dict(klt_covariance="sample"), 3),
    # 10 free slots, and a filter that has seen the motion: new features
    # get triangulated depth priors
    "vision_triangulation": (dict(triangulate_new_features=True,
                                  num_features=110), 3),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_step_option_matches_jax(name):
    option, warm = OPTIONS[name]
    small, times = _small_frames(warm + 2)
    kw = dict(max_features=128, **BENCH_KW, **option)
    base_kw = {k: v for k, v in kw.items() if k in (
        "max_features", "num_features", "init_kinematic_variance",
        *BENCH_KW)}
    jcfg, cfg = JConfig(**kw), VIOConfig(**kw)
    jc = jengine.make_hashable_camera(K, W, H)
    if warm:
        es0, _ = jengine.run_sequence(jnp.asarray(small[:warm + 1]),
                                      jnp.asarray(times[:warm + 1]),
                                      JConfig(**base_kw), jc)
    else:
        es0 = jengine.initialize(jnp.asarray(small[0]), times[0], jcfg, jc)
    jstep = jax.jit(jengine.step, static_argnums=(3, 4))
    img, t = jnp.asarray(small[warm + 1]), jnp.float32(times[warm + 1])
    es1, jout = jstep(es0, img, t, jcfg, jc)
    base1, jbase = jstep(es0, img, t, JConfig(**base_kw), jc)

    ts0 = interop.engine_state_from_numpy(_jax_state_dict(es0), "cpu")
    ts1, out = engine.step(ts0, torch.from_numpy(small[warm + 1]),
                           torch.tensor(times[warm + 1]), cfg,
                           interop.camera_from_K(K, W, H))
    assert int(out.num_tracked) == int(jout.num_tracked) > 50
    assert int(out.num_active) == int(jout.num_active)
    _assert_step_close(ts1, es1)
    # the option bites: the JAX step without it differs
    changed = (int(jout.num_tracked) != int(jbase.num_tracked)
               or np.abs(np.asarray(es1.filt.feat_mu)
                         - np.asarray(base1.filt.feat_mu)).max() > 1e-6)
    assert changed, name


def test_fast_with_insight_profile_matches_jax(jax_fast_rule):
    """configs/fast_with_insight.yaml with bench.py's overrides, cut to 64
    slots (48 features) and 5 frames of the bench sequence at ÷2
    (320x240, where FAST masks its margin before NMS): the 'lk' tracker
    rule as at 512 slots, equal counts on every frame, and one step from
    the JAX package's state at the per-step bars."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "configs", "fast_with_insight.yaml")
    over = dict(min_new_feature_dist=8.0, fast_threshold=30)
    full, jfull = VIOConfig.from_yaml(path), JConfig.from_yaml(path)
    assert (full.num_features, full.max_features,
            full.inverse_image_scale) == (400, 512, 2)
    assert full == VIOConfig.from_dict(
        {f: getattr(jfull, f) for f in ("num_features", "max_features",
                                        "inverse_image_scale",
                                        "fast_threshold")})
    from ekf_vio_tpu_torch.frontend import klt

    assert klt.selected_backend((240, 320), 512, full.replace(**over),
                                "cuda") == "cuda_lk"
    cut = dict(over, max_features=64, num_features=48)
    cfg, jcfg = full.replace(**cut), jfull.replace(**cut)
    assert klt.selected_backend((240, 320), 64, cfg, "cpu") == "torch_lk"

    frames, times = sim_frames.make_frames(seed=0, n_frames=5)
    s = cfg.inverse_image_scale
    small = np.array(jcam.downscale_image(jnp.asarray(frames), s))
    w, h = 640 // s, 480 // s
    Ks = [[458.0 / s, 0.0, w / 2], [0.0, 458.0 / s, h / 2], [0.0, 0.0, 1.0]]
    jc = jengine.make_hashable_camera(Ks, w, h)
    cam = interop.camera_from_K(Ks, w, h)
    jes, jout = jengine.run_sequence(jnp.asarray(small[:4]),
                                     jnp.asarray(times[:4]), jcfg, jc)
    es, out = engine.run_sequence(torch.from_numpy(small[:4]),
                                  torch.from_numpy(times[:4]), cfg, cam,
                                  device="cpu")
    np.testing.assert_array_equal(out.num_tracked.numpy(),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(out.num_active.numpy(),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 30
    # one step from the carried JAX state
    es1, jo = jax.jit(jengine.step, static_argnums=(3, 4))(
        jes, jnp.asarray(small[4]), jnp.float32(times[4]), jcfg, jc)
    ts0 = interop.engine_state_from_numpy(_jax_state_dict(jes), "cpu")
    ts1, o = engine.step(ts0, torch.from_numpy(small[4]),
                         torch.tensor(times[4]), cfg, cam)
    assert int(o.num_tracked) == int(jo.num_tracked) > 30
    assert int(o.num_active) == int(jo.num_active)
    _assert_step_close(ts1, es1)
    sig = ts1.filt.Sigma.numpy()
    assert np.diag(sig).min() >= -1e-5 and np.abs(sig - sig.T).max() < 1e-3


@pytest.fixture
def jax_fast_rule(monkeypatch):
    """The JAX package's FAST with the Pallas kernel's margin order from
    128x256 px (on a TPU it runs the kernel there), in jnp on the CPU."""
    def detect(img, threshold, nms=True):
        h, w = img.shape
        if not nms or h * w < 128 * 256:
            return jfast.detect(img, threshold, nms=nms)
        score = jfast.fast_score_map(img, threshold)
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        margin = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
        return jfast.non_max_suppress(jnp.where(margin, score, 0.0))

    monkeypatch.setattr(jpallas_fast, "detect", detect)


MONO_KW = dict(max_features=32, num_features=25, min_new_feature_dist=10.0,
               fast_threshold=25, triangulate_new_features=True,
               klt_measurement_variance_px=0.001, q_feature=1e-7,
               use_imu=True, vi_init_frames=6)


@pytest.fixture(scope="module")
def mono_seq():
    seq = rendered.generate(num_frames=13)
    return seq._replace(frames=np.round(seq.frames))


def _seq_args(seq, n, xp):
    return tuple(xp(a[:m]) for a, m in (
        (seq.frames, n), (seq.times, n), (seq.imu_dt, n - 1),
        (seq.imu_gyro, n - 1), (seq.imu_accel, n - 1))) + (
        xp(seq.gravity_w),)


def test_mono_inertial_rollout_and_step_match_jax(mono_seq, jax_fast_rule):
    """A 12-frame ``run_sequence_imu`` (VI initialization over 6 frames,
    then 6 IMU steps), then one IMU step of both engines from the JAX
    package's final state."""
    seq = mono_seq
    h, w = seq.frames.shape[1:]
    jcfg, cfg = JConfig(**MONO_KW), VIOConfig(**MONO_KW)
    jc = jengine.make_hashable_camera(seq.K, w, h)
    cam = interop.camera_from_K(seq.K, w, h)
    jes, jout = jengine.run_sequence_imu(*_seq_args(seq, 12, jnp.asarray),
                                         jcfg, jc, init_frames=6)
    es, out = engine.run_sequence_imu(*_seq_args(seq, 12, torch.from_numpy),
                                      cfg, cam, init_frames=6, device="cpu")
    np.testing.assert_array_equal(out.num_tracked.numpy(),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(out.num_active.numpy(),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 15
    # f32 roundoff compounds over the rollout (1.3e-4 seen in the weakly
    # observed ω/a slots); the per-step bars are held below
    np.testing.assert_allclose(out.base_mu.numpy(), np.asarray(jout.base_mu),
                               atol=1e-3)
    sig = np.asarray(jes.filt.Sigma)
    assert np.abs(es.filt.Sigma.numpy() - sig).max() < 1e-3 * max(
        np.abs(sig).max(), 1.0)
    assert int(es.frame_idx) == int(jes.frame_idx) == 12

    # one IMU step from the carried JAX state
    jbatch = jimu.ImuSample(jnp.asarray(seq.imu_dt[11]),
                            jnp.asarray(seq.imu_gyro[11]),
                            jnp.asarray(seq.imu_accel[11]))
    g_w = jnp.asarray(seq.gravity_w)
    es1, jo = jax.jit(jengine.step, static_argnums=(3, 4))(
        jes, jnp.asarray(seq.frames[12]), jnp.float32(seq.times[12]), jcfg,
        jc, imu_batch=jbatch, gravity_w=g_w)
    ts0 = interop.engine_state_from_numpy(_jax_state_dict(jes), "cpu")
    ts1, o = engine.step(
        ts0, torch.from_numpy(seq.frames[12]), torch.tensor(seq.times[12]),
        cfg, cam, imu_batch=imu.ImuSample(
            *(torch.from_numpy(a[11]) for a in (seq.imu_dt, seq.imu_gyro,
                                                 seq.imu_accel))),
        gravity_w=torch.from_numpy(seq.gravity_w))
    assert int(o.num_tracked) == int(jo.num_tracked) > 15
    assert int(o.num_active) == int(jo.num_active)
    _assert_step_close(ts1, es1)
    np.testing.assert_allclose(ts1.lin_base.numpy(),
                               np.asarray(es1.lin_base), atol=1e-4)


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
    """Every module of the port, and chip_smoke.py, imports neither JAX
    nor the JAX package."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "ekf_vio_tpu_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods] + ["chip_smoke"]
    assert "ekf_vio_tpu_torch.core.imu" in mods
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ekf_vio_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
