"""Parity of the PyTorch front end (ekf_vio_tpu_torch/frontend) with the JAX
package on the CPU.

The CUDA kernels against their plain twins are in test_torch_kernels.py.

Tolerances: camera maps, pyramid and FAST are bitwise equal on
integer-valued frames (every intermediate is exact in f32) and within
1e-4 otherwise (summation order); replenishment gives identical
candidates; the plain LK matches the JAX ``klt.track`` with identical
status and points within 2e-3 px (the window sums run in another order),
and ``pallas_lk`` at its own bar (tests/test_pallas_lk.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_vio_tpu.config import VIOConfig as JConfig
from ekf_vio_tpu.frontend import camera as jcam
from ekf_vio_tpu.frontend import fast as jfast
from ekf_vio_tpu.frontend import klt as jklt
from ekf_vio_tpu.frontend import pallas_fast as jpallas_fast
from ekf_vio_tpu.frontend import pallas_lk as jpallas_lk
from ekf_vio_tpu.frontend import pyramid as jpyr
from ekf_vio_tpu.frontend import replenish as jrep
from ekf_vio_tpu_torch.config import VIOConfig
from ekf_vio_tpu_torch.frontend import (camera, fast, fast_cuda, klt, lk_cuda,
                                        pyramid, replenish)
from ekf_vio_tpu_torch.sim import rendered
from test_torch_kernels import LK_CASES, blocks, lk_case, textured


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TestCameraAndPyramid:
    def test_camera_maps(self):
        K = [[114.5, 0.0, 80.0], [0.0, 114.5, 60.0], [0.0, 0.0, 1.0]]
        cam = camera.Camera.from_K(K, 160, 120)
        jc = jcam.CameraModel(K=jnp.asarray(K, jnp.float32), width=160,
                              height=120)
        px = np.random.RandomState(2).uniform(-5, 170, (64, 2)).astype(
            np.float32)
        uv = camera.pixel_to_metric(cam, torch.from_numpy(px))
        np.testing.assert_array_equal(_np(uv),
                                      _np(jcam.pixel_to_metric(jc, px)))
        np.testing.assert_array_equal(
            _np(camera.metric_to_pixel(cam, uv)),
            _np(jcam.metric_to_pixel(jc, jnp.asarray(_np(uv)))))
        np.testing.assert_array_equal(
            _np(camera.in_kill_box(cam, torch.from_numpy(px), 11)),
            _np(jcam.in_kill_box(jc, px, 11)))

    def test_downscale(self):
        img = np.random.RandomState(3).randint(0, 256, (2, 48, 64)).astype(
            np.float32)
        np.testing.assert_array_equal(
            _np(camera.downscale_image(torch.from_numpy(img), 4)),
            _np(jcam.downscale_image(jnp.asarray(img), 4)))

    @pytest.mark.parametrize("shape", [(120, 160), (61, 83)])
    def test_pyramid_bitwise_on_integer_frames(self, shape):
        img = np.random.RandomState(4).randint(0, 256, shape).astype(
            np.float32)
        got = pyramid.build_pyramid(torch.from_numpy(img), 3)
        ref = jpyr.build_pyramid(jnp.asarray(img), 3)
        assert len(got) == len(ref)
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(_np(g), _np(r))
        np.testing.assert_allclose(_np(got[3]), _np(ref[3]), atol=1e-4)

    def test_pyramid_fractional(self):
        img = textured()
        got = pyramid.build_pyramid(torch.from_numpy(img), 3)
        ref = jpyr.build_pyramid(jnp.asarray(img), 3)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), _np(r), atol=1e-4)


class TestFast:
    @pytest.mark.parametrize("shape,thr", [((120, 160), 30.0),
                                           ((100, 130), 50.0)])
    def test_detect_bitwise_on_integer_frames(self, shape, thr):
        img = blocks(*shape)
        got = fast_cuda.detect(torch.from_numpy(img), thr)
        ref = jfast.detect(jnp.asarray(img), thr)
        assert (_np(ref) > 0).sum() > 20
        np.testing.assert_array_equal(_np(got), _np(ref))

    def test_detect_fractional(self):
        img = textured() * 0.5 + blocks() * 0.5
        got = fast.detect(torch.from_numpy(img), 30.0)
        ref = jfast.detect(jnp.asarray(img), 30.0)
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4)

    def test_score_nms_and_margin_stages(self):
        """Each stage bitwise: score map, NMS (outside counts as -inf),
        then the 3-px margin after NMS, as in fast.detect."""
        img = blocks(seed=5)
        score = fast.fast_score_map(torch.from_numpy(img), 30.0)
        ref = jfast.fast_score_map(jnp.asarray(img), 30.0)
        np.testing.assert_array_equal(_np(score), _np(ref))
        np.testing.assert_array_equal(
            _np(fast.border_mask(fast.non_max_suppress(score))),
            _np(jfast.detect(jnp.asarray(img), 30.0)))

    @pytest.mark.parametrize("size", ["240x320", "120x160"])
    def test_margin_order_follows_jax_dispatch(self, size):
        """From 128x256 px the margin is zeroed before NMS, bitwise as the
        Pallas kernel (interpret mode) computes it; below, after NMS, as
        fast.detect does.  Integer-valued rendered frame 0."""
        frame = np.round(rendered.generate(num_frames=1).frames[0])
        if size == "120x160":
            frame = frame[60:180, 80:240]
        got = _np(fast_cuda.detect(torch.from_numpy(frame), 25.0))
        if size == "240x320":
            ref = _np(jpallas_fast.detect_pallas(jnp.asarray(frame), 25.0,
                                                 interpret=True))
            # masking first keeps corners on the first rows/columns inside
            # the margin that the other order suppresses: the two rules
            # are told apart on this frame
            after = _np(jfast.detect(jnp.asarray(frame), 25.0))
            assert ((ref > 0) & (after == 0)).sum() > 0
        else:
            ref = _np(jfast.detect(jnp.asarray(frame), 25.0))
        assert (ref > 0).sum() > 100
        np.testing.assert_array_equal(got, ref)

    def test_gaussian_blur(self):
        img = textured()
        np.testing.assert_allclose(
            _np(fast.gaussian_blur(torch.from_numpy(img), 1.2)),
            _np(jfast.gaussian_blur(jnp.asarray(img), 1.2)), atol=1e-4)
        assert fast.gaussian_blur(torch.from_numpy(img), 0.0) is not None


class TestReplenish:
    @pytest.mark.parametrize("n_existing", [0, 12])
    def test_identical_candidates(self, n_existing):
        img = blocks(seed=6, n=60)
        cfg = VIOConfig(max_features=32, min_new_feature_dist=8.0,
                        fast_threshold=30, num_features=25)
        jcfg = JConfig(max_features=32, min_new_feature_dist=8.0,
                       fast_threshold=30, num_features=25)
        rng = np.random.RandomState(7)
        px = rng.uniform(10, 110, (32, 2)).astype(np.float32)
        valid = np.arange(32) < n_existing
        got_px, got_v = replenish.replenish(
            torch.from_numpy(img), torch.from_numpy(px),
            torch.from_numpy(valid), cfg, 32)
        ref_px, ref_v = jrep.replenish(jnp.asarray(img), jnp.asarray(px),
                                       jnp.asarray(valid), jcfg, 32)
        assert _np(ref_v).sum() > 5
        np.testing.assert_array_equal(_np(got_v), _np(ref_v))
        np.testing.assert_array_equal(_np(got_px), _np(ref_px))

    def test_ties_keep_lower_cell_first(self):
        """Equal scores: lax.top_k order (lower index first), which
        torch.topk does not promise."""
        score = np.zeros((64, 64), np.float32)
        for y, x in [(20, 20), (20, 44), (44, 20), (44, 44), (30, 36)]:
            score[y, x] = 7.0
        cfg = VIOConfig(max_features=8, min_new_feature_dist=8.0,
                        num_features=3)
        jcfg = JConfig(max_features=8, min_new_feature_dist=8.0,
                       num_features=3)
        none = np.zeros((8, 2), np.float32)
        got = replenish.select_candidates(
            torch.from_numpy(score), torch.from_numpy(none),
            torch.zeros(8, dtype=torch.bool), torch.tensor(3), cfg, 8)
        ref = jrep.select_candidates(jnp.asarray(score), jnp.asarray(none),
                                     jnp.zeros(8, bool), 3, jcfg, 8)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(_np(g), _np(r))


def _track_torch(prev, cur, q, init, valid, levels, cfg, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    pp = pyramid.build_pyramid(t(prev), levels)
    cp = pyramid.build_pyramid(t(cur), levels)
    return klt.track(pp, cp, t(q), t(init), t(valid), cfg)


class TestLK:
    @pytest.mark.parametrize("case", LK_CASES)
    def test_plain_lk_matches_jax_track(self, case):
        prev, cur, q, init, valid, levels = lk_case(case)
        n = q.shape[0]
        got = _track_torch(prev, cur, q, init, valid, levels,
                           VIOConfig(max_features=n))
        ref = jklt.track(jpyr.build_pyramid(jnp.asarray(prev), levels),
                         jpyr.build_pyramid(jnp.asarray(cur), levels),
                         jnp.asarray(q), jnp.asarray(init), jnp.asarray(valid),
                         JConfig(max_features=n))
        ok, ref_ok = _np(got.status), _np(ref.status)
        np.testing.assert_array_equal(ok, ref_ok)
        if case in ("translation", "seeded_flow", "n100"):
            assert ref_ok.sum() >= 0.85 * n  # the scene is trackable
        if case == "flat":
            assert not ok.any()
        if ok.any():
            d = np.abs(_np(got.points) - _np(ref.points))[ok]
            assert d.max() <= 2e-3, d.max()
            np.testing.assert_allclose(_np(got.error)[ok], _np(ref.error)[ok],
                                       rtol=1e-3, atol=1e-3)
            np.testing.assert_allclose(_np(got.min_eig)[ok],
                                       _np(ref.min_eig)[ok], rtol=1e-4)
        assert np.isfinite(_np(got.points)[valid]).all()

    def test_plain_lk_matches_pallas_lk(self):
        """The fused TPU tracker in interpret mode, at the bar
        tests/test_pallas_lk.py holds it to."""
        prev, cur, q, init, valid, levels = lk_case("seeded_flow")
        cfg = JConfig(max_features=32)
        g, ok, err, eig = jpallas_lk.track(
            jpyr.build_pyramid(jnp.asarray(prev), levels),
            jpyr.build_pyramid(jnp.asarray(cur), levels),
            jnp.asarray(q), jnp.asarray(init), jnp.asarray(valid), cfg,
            interpret=True)
        got = _track_torch(prev, cur, q, init, valid, levels,
                           VIOConfig(max_features=32))
        both = _np(ok) & _np(got.status)
        np.testing.assert_array_equal(_np(got.status), _np(ok))
        assert both.sum() >= 28
        assert np.abs(_np(got.points) - _np(g))[both].max() < 0.05
        de = np.abs(_np(got.error) - _np(err))[both]
        assert (de < 0.75 + 0.04 * _np(got.error)[both]).all()
        np.testing.assert_allclose(_np(got.min_eig)[both], _np(eig)[both],
                                   rtol=0.02, atol=1e-3)

    def test_backend_and_measurement_covariance(self):
        cfg = VIOConfig(max_features=128)
        assert klt.selected_backend((120, 160), 128, cfg, "cpu") == "torch_lk"
        assert klt.selected_backend((120, 160), 128, cfg,
                                    torch.device("cuda", 0)) == "cuda_lk"
        cfg = VIOConfig()
        got = klt.measurement_covariance_metric(114.5, 110.0, 8, cfg)
        ref = jklt.measurement_covariance_metric(114.5, 110.0, 8, JConfig())
        np.testing.assert_array_equal(_np(got), _np(ref))

    def test_cpu_tensors_never_reach_the_kernels(self):
        before = (lk_cuda.launches, fast_cuda.launches)
        _track_torch(*lk_case("translation"), VIOConfig(max_features=32))
        fast_cuda.detect(torch.from_numpy(blocks()), 30.0)
        assert (lk_cuda.launches, fast_cuda.launches) == before
        with pytest.raises(ValueError):
            fast_cuda.detect_cuda(torch.zeros(8, 8), 30.0)
        with pytest.raises(ValueError):
            lk_cuda.track_level_cuda(
                *(torch.zeros(16, 16),) * 2, torch.zeros(2, 2),
                torch.zeros(2, 2), torch.ones(2, dtype=torch.bool), win=5,
                iters=3, eps=0.01, min_eigen=1e-4, gate_eig=True)
