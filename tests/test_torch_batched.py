"""Lanes: the kernels' plain versions with a lane axis, the batched engine
(``parallel/batched_engine.py``) and the batched filter step
(``parallel/batched.py``) of the port against the JAX package on the
CPU.

Bars: the LK lanes equal ``jax.vmap`` of the JAX package's XLA tracker
(``klt.track``, whose ``_track_level`` the plain version ports) in status
exactly and in points, err and min_eig within 1e-4, and ``jax.vmap`` of
``pallas_lk.track`` (interpret mode) at that tracker's own bar (status
exact, points within 0.05 px, err within 0.75 + 4 %, min_eig within rtol
0.02: its corr tables round to bf16 where ``_track_level`` does not);
FAST lanes bitwise equal ``jax.vmap(fast.detect)`` on integer frames;
``run_sequences_batched`` equal to the JAX one in every tracked and
active count with base_mu within 1e-3, and each lane to the port's own
one-lane ``run_sequence`` (counts equal, base_mu within 1e-4: batched and
one-lane matrix products round differently); the batched filter step
within f32 roundoff of the JAX one on the same positions.  A vmapped
``track`` / ``detect`` is one call of each kernel's operator for all
lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from ekf_vio_tpu import engine as jengine
from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.frontend import fast as jfast
from ekf_vio_tpu.frontend import klt as jklt
from ekf_vio_tpu.frontend import pallas_lk
from ekf_vio_tpu.frontend import pyramid as jpyramid
from ekf_vio_tpu.parallel import batched as jbatched
from ekf_vio_tpu.parallel import batched_engine as jbatched_engine
from ekf_vio_tpu_torch import engine
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import fast, fast_cuda, klt, lk_cuda, pyramid
from ekf_vio_tpu_torch.frontend.camera import Camera
from ekf_vio_tpu_torch.parallel import batched, batched_engine
from test_torch_kernels import _scene, blocks


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module: beside the suite's other
    workers its intra-op threads spend far longer waiting on one another
    than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lk_lanes():
    """The 3-lane, 32-feature, 2-level scene of
    ``test_pallas_lk.py::test_vmapped_batch_matches_per_lane`` through the
    JAX package's vmapped trackers (XLA and pallas_lk in interpret mode),
    each (points, status, error, min_eig) [3, 32, ...]."""
    lanes = [_scene(seed=s, shift=(0.9 * s, -1.1)) for s in (1, 2, 3)]
    prev, cur, q = (np.stack([x[i] for x in lanes]) for i in range(3))
    valid = np.ones((3, 32), bool)
    cfg = JConfig(max_features=32)

    def run(track):
        def one(a, b, p, v):
            pp = jpyramid.build_pyramid(a, 2)
            cp = jpyramid.build_pyramid(b, 2)
            return tuple(track(pp, cp, p, p, v))
        return [np.asarray(x) for x in jax.vmap(one)(
            jnp.asarray(prev), jnp.asarray(cur), jnp.asarray(q),
            jnp.asarray(valid))]

    xla = run(lambda *a: jklt.track(*a, cfg))
    fused = run(lambda *a: pallas_lk.track(*a, cfg, interpret=True))
    return (prev, cur, q, valid), xla, fused


def _port_lanes(prev, cur, q, valid, vmapped: bool):
    cfg = VIOConfig(max_features=32)
    pp = pyramid.build_pyramid(_t(prev), 2)
    cp = pyramid.build_pyramid(_t(cur), 2)
    if vmapped:
        return torch.func.vmap(
            lambda a, b, p, v: tuple(klt.track(a, b, p, p, v, cfg)))(
                pp, cp, _t(q), _t(valid))
    g, ok, eig, err = lk_cuda.track_pyramid(pp, cp, _t(q), _t(q), _t(valid),
                                            cfg, 0, 2)
    return g, ok, err, eig


@pytest.mark.parametrize("vmapped", [False, True])
def test_lk_lanes_match_the_vmapped_jax_trackers(lk_lanes, vmapped):
    inputs, xla, fused = lk_lanes
    g, ok, err, eig = (x.numpy() for x in _port_lanes(*inputs, vmapped))
    for ref in (xla, fused):
        np.testing.assert_array_equal(ok, ref[1])
    assert ok.sum() >= 80
    for got, want in ((g, xla[0]), (err, xla[2]), (eig, xla[3])):
        np.testing.assert_allclose(got[ok], want[ok], atol=1e-4)
    assert np.abs(g - fused[0])[ok].max() < 0.05
    assert (np.abs(err - fused[2])[ok] < 0.75 + 0.04 * xla[2][ok]).all()
    np.testing.assert_allclose(eig[ok], fused[3][ok], rtol=0.02, atol=1e-3)


def test_lk_lanes_equal_one_lane_calls(lk_lanes):
    (prev, cur, q, valid), _, _ = lk_lanes
    lanes = _port_lanes(prev, cur, q, valid, vmapped=True)
    for b in range(3):
        one = _port_lanes(prev[b], cur[b], q[b], valid[b], vmapped=False)
        for x, y in zip(lanes, one):
            assert torch.equal(x[b], y)


def test_a_vmapped_call_is_one_operator_call(lk_lanes, monkeypatch):
    """One lane-shaped call of each plain version for all lanes, as one
    launch of each kernel on the card."""
    calls = []
    real_lk, real_fast = klt.track_pyramid_plain, fast.detect

    def lk(prev_pyr, cur_pyr, pts, *a, **k):
        calls.append(("lk", tuple(pts.shape)))
        return real_lk(prev_pyr, cur_pyr, pts, *a, **k)

    def detect(img, thr):
        calls.append(("fast", tuple(img.shape)))
        return real_fast(img, thr)

    monkeypatch.setattr(klt, "track_pyramid_plain", lk)
    monkeypatch.setattr(fast, "detect", detect)
    (prev, cur, q, valid), _, _ = lk_lanes
    _port_lanes(prev, cur, q, valid, vmapped=True)
    torch.func.vmap(lambda im: fast_cuda.detect(im, 20.0))(_t(prev))
    lane_calls = [c for c in calls if len(c[1]) == 3]
    assert lane_calls == [("lk", (3, 32, 2)), ("fast", (3, 128, 192))]


@pytest.mark.parametrize("vmapped", [False, True])
def test_fast_lanes_match_vmapped_jax_detect(vmapped):
    imgs = np.stack([blocks(seed=s) for s in range(4)])
    ref = np.asarray(jax.vmap(lambda im: jfast.detect(im, 30.0))(
        jnp.asarray(imgs)))
    if vmapped:
        got = torch.func.vmap(lambda im: fast_cuda.detect(im, 30.0))(_t(imgs))
    else:
        got = fast_cuda.detect(_t(imgs), 30.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref > 0).sum((1, 2)).min() > 20


def test_pyramid_lanes_equal_one_lane_pyramids():
    imgs = _t(np.stack([blocks(seed=s) for s in range(3)]))
    lanes = pyramid.build_pyramid(imgs, 3)
    for b in range(3):
        for x, y in zip(lanes, pyramid.build_pyramid(imgs[b], 3)):
            assert torch.equal(x[b], y)


def test_lane_mismatch_raises():
    (prev, cur, q) = _scene()
    pp = pyramid.build_pyramid(_t(np.stack([prev] * 2)), 2)
    cp = pyramid.build_pyramid(_t(np.stack([cur] * 2)), 2)
    q3 = _t(np.stack([q] * 3))
    with pytest.raises(ValueError, match="lanes"):
        lk_cuda.track_pyramid(pp, cp, q3, q3, torch.ones(3, 32, dtype=bool),
                              VIOConfig(max_features=32), 0, 2)


# -- the batched engine: tests/test_parallel.py's two sequences -----------

H, W, T = 96, 128, 6
CFG_KW = dict(max_features=24, num_features=16, fast_threshold=12,
              min_new_feature_dist=10.0)
K = [[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]]


def _sequences(n_lanes=2):
    rng = np.random.RandomState(0)
    seqs = []
    for _ in range(n_lanes):
        big = ndi.gaussian_filter(rng.uniform(0, 255, (H + 20, W + 30)), 1.5)
        big = ((big - big.min()) / (np.ptp(big) + 1e-9) * 255).astype(
            np.float32)
        seqs.append(np.stack([big[10:10 + H, 10 + i:10 + i + W]
                              for i in range(T)]))
    times = np.tile(np.arange(T, dtype=np.float32) * 0.05, (n_lanes, 1))
    return np.stack(seqs), times


@pytest.fixture(scope="module")
def batched_runs():
    images, times = _sequences()
    _, jout = jbatched_engine.run_sequences_batched(
        jnp.asarray(images), jnp.asarray(times), JConfig(**CFG_KW),
        jengine.make_hashable_camera(K, W, H))
    es, out = batched_engine.run_sequences_batched(
        images, times, VIOConfig(**CFG_KW), Camera.from_K(K, W, H),
        device="cpu")
    return images, times, jout, es, out


def test_run_sequences_batched_matches_jax(batched_runs):
    _, _, jout, es, out = batched_runs
    assert out.base_mu.shape == (2, T - 1, 22)
    assert es.filt.Sigma.shape[0] == 2 and len(es.prev_pyr[0]) == 2
    np.testing.assert_array_equal(out.num_tracked.numpy(),
                                  np.asarray(jout.num_tracked))
    np.testing.assert_array_equal(out.num_active.numpy(),
                                  np.asarray(jout.num_active))
    assert out.num_tracked.min() > 0
    np.testing.assert_allclose(out.base_mu.numpy(), np.asarray(jout.base_mu),
                               atol=1e-3)
    assert not torch.allclose(out.base_mu[0], out.base_mu[1])


def test_each_lane_equals_a_one_lane_rollout(batched_runs):
    images, times, _, _, out = batched_runs
    for b in range(2):
        _, one = engine.run_sequence(images[b], times[b], VIOConfig(**CFG_KW),
                                     Camera.from_K(K, W, H), device="cpu")
        assert torch.equal(one.num_tracked, out.num_tracked[b])
        assert torch.equal(one.num_active, out.num_active[b])
        np.testing.assert_allclose(one.base_mu.numpy(),
                                   out.base_mu[b].numpy(), atol=1e-4)


def test_microbatches_split_divisible_batches_only(monkeypatch):
    """Batches above ``microbatch`` that it divides run as chunks, in
    order, concatenated on the batch axis; others run whole."""
    sizes = []
    real = batched_engine._run_microbatch

    def spy(images, *a):
        sizes.append(images.shape[0])
        return real(images, *a)

    monkeypatch.setattr(batched_engine, "_run_microbatch", spy)
    images, times = _sequences(4)
    images, times = images[:, :3], times[:, :3]
    cfg, cam = VIOConfig(**CFG_KW), Camera.from_K(K, W, H)
    es, out = batched_engine.run_sequences_batched(images, times, cfg, cam,
                                                   microbatch=2, device="cpu")
    assert sizes == [2, 2] and out.num_tracked.shape == (4, 2)
    assert es.filt.Sigma.shape[0] == 4
    _, whole = batched_engine.run_sequences_batched(
        images[:3], times[:3], cfg, cam, microbatch=2, device="cpu")
    assert sizes[2:] == [3]
    np.testing.assert_array_equal(whole.num_tracked.numpy(),
                                  out.num_tracked[:3].numpy())


def test_batched_filter_step_matches_jax():
    n, b = 16, 4
    rng = np.random.RandomState(0)
    uv = rng.uniform(-1, 1, (b, n, 2)).astype(np.float32)
    jcfg, cfg = JConfig(max_features=n), VIOConfig(max_features=n)

    jbase = jbatched.ekf.init_state(jcfg)
    jstate = jax.vmap(lambda u: jbatched.ekf.add_features(
        jbase, jcfg, u, jnp.ones(n, bool)))(jnp.asarray(uv))
    state = batched.init_batched_state(cfg, b, uv=torch.from_numpy(uv),
                                       device="cpu")
    np.testing.assert_array_equal(state.Sigma.numpy(),
                                  np.asarray(jstate.Sigma))
    z = uv + 0.01
    jout = jbatched.make_batched_filter_step(jcfg)(jstate, jnp.asarray(z),
                                                   0.05)
    out = batched.make_batched_filter_step(cfg)(state, torch.from_numpy(z),
                                                0.05)
    np.testing.assert_allclose(out.base_mu.numpy(), np.asarray(jout.base_mu),
                               atol=1e-6)
    np.testing.assert_allclose(out.feat_mu.numpy(), np.asarray(jout.feat_mu),
                               atol=1e-6)
    sig = np.asarray(jout.Sigma)
    np.testing.assert_allclose(out.Sigma.numpy(), sig,
                               atol=1e-5 * np.abs(sig).max())


def test_init_batched_state_draws_from_the_generator():
    cfg = VIOConfig(max_features=8)
    a = batched.init_batched_state(cfg, 3, torch.Generator().manual_seed(1),
                                   device="cpu")
    b = batched.init_batched_state(cfg, 3, torch.Generator().manual_seed(1),
                                   device="cpu")
    assert torch.equal(a.feat_mu, b.feat_mu) and a.active.all()
    assert a.feat_mu[:, :, :2].abs().max() <= 1.0
    assert not torch.equal(a.feat_mu[0], a.feat_mu[1])
